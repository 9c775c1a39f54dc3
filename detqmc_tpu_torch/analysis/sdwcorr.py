"""sdwcorr — offline phi-field correlations from dumped configurations.

Reference parity: SURVEY.md §3 "sdwcorr" (mainsdwcorr.cpp): real- and
k-space correlation functions / structure factors of the O(N) field from
.binarystream dumps.

Usage: sdwcorr-torch <phi.binarystream> [--L L] [--device cpu]
Record shape must be (m, N, opdim) (written by the SDW driver's
``dump_config`` option).

The port's copy of detqmc_tpu/analysis/sdwcorr.py: the FFTs and the
reductions run in float64 / complex128 with ``torch.fft.fft2`` on an
explicit device, the card unless ``device`` (``--device``) names another;
the results come back as NumPy arrays, and the .corr.npz has the JAX
tool's keys and shapes.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from detqmc_tpu_torch.io.binarystream import read_binarystream


def phi_correlations(phi: np.ndarray, L: int, device=None):
    """phi: (n_meas, m, N, opdim). Returns dict with:
    - corr_r: (L, L) translation-averaged equal-time <phi_0 . phi_r>
    - struct_k: (L, L) static structure factor S(q) (FFT of corr_r)
    - chi_q0: susceptibility-like sum over tau at q=0
    computed on ``device`` (default the card)."""
    device = torch.device("cuda" if device is None else device)
    n_meas, m, N, opdim = phi.shape
    assert N == L * L, (N, L)
    ph = torch.as_tensor(np.asarray(phi, np.float64), device=device)
    conf = ph.reshape(n_meas * m, L, L, opdim)
    # translation-averaged equal-time correlation via FFT
    f = torch.fft.fft2(conf.to(torch.complex128), dim=(1, 2))
    power = (f * f.conj()).real.sum(dim=-1)          # (n, L, L)
    struct_k = power.mean(dim=0) / (L * L)
    corr_r = torch.fft.ifft2(struct_k.to(torch.complex128)).real
    # q=0 susceptibility: beta factor is applied by the caller if desired
    phibar = ph.mean(dim=(1, 2))                      # (n_meas, opdim)
    chi_q0 = (phibar ** 2).sum(dim=-1).mean() * N
    return {"corr_r": corr_r.cpu().numpy(),
            "struct_k": struct_k.cpu().numpy(),
            "chi_q0": np.float64(chi_q0.item())}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: sdwcorr <phi.binarystream> [--L L] [--device D]",
              file=sys.stderr)
        return 2
    path = argv[0]
    phi = read_binarystream(path)
    if phi.ndim != 4:
        print(f"unexpected record shape {phi.shape[1:]}", file=sys.stderr)
        return 2
    L = int(round(np.sqrt(phi.shape[2])))
    if "--L" in argv:
        L = int(argv[argv.index("--L") + 1])
    device = "cuda"
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    out = phi_correlations(phi, L, device=device)
    np.savez(path + ".corr.npz", **out)
    print(f"chi(q=0) = {out['chi_q0']!r}")
    print(f"S(pi,pi) = {out['struct_k'][L // 2, L // 2]!r}")
    print(f"wrote {path}.corr.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
