"""O(n) spin-density-wave metal, BSS determinantal QMC — PyTorch port.

Port of detqmc_tpu.models.sdw (the reference): an O(opdim) order-parameter
field phi(i, l) Yukawa-coupled to two fermion bands, B_l =
exp(-dtau V(phi_l)) exp(-dtau K), box or rotate/scale proposals, exact
q x q determinant ratios with rank-q Woodbury updates of G, and the
UdV-stabilized sweep of models/hubbard.py. Two fermion matrices, as in the
JAX model (``fermion_matrix``):
- full: the (4N, 4N) complex matrix in orbital-major order (x_up, x_dn,
  y_up, y_dn), q = 4; opdim 3 always, opdim 2 with ``fermion_matrix=
  "full"``;
- reduced (opdim <= 2, the default there): phi_z = 0 decouples the
  4-orbital matrix into sector A = (x_up, y_dn) and sector B = conj(A),
  so the chain carries A alone, (2N, 2N), q = 2: complex at opdim 2, real
  at opdim 1 (sdw.py:377-416 and ``_assemble_reduced`` of the JAX model).
  The physical weight is |det M_A|^2: the accept uses c_det = 1, the
  log-weight twice sector A's log-det, and the measurements rebuild the
  physical 4-orbital G from A (B = conj(A), no cross-sector blocks) and
  count occupancy and kinetic energy twice.

From JAX to PyTorch (as in models/hubbard.py):
- walkers lead every state tensor (W, ...); ``lax.scan`` is a Python
  loop; randomness comes from a caller's ``torch.Generator`` or injected
  draws (``draws``), which is how the tests feed JAX's own numbers;
- ``SDWModel`` is an ``nn.Module`` on an explicit device, its constants
  registered buffers.

Representation: native complex. G and the stack's U are complex64
(``dtype="float32"``) or complex128; the stack's d is float64 and its V
complex128. The real opdim-1 chain keeps G and U in float32 or float64, d
and V in float64. None of the TPU's representations is ported: no (re, im) pair
planes, no real rho-embedding, no df32, no Ozaki limbs (ROADMAP.md Queue 1
item 12). So ``fermion_repr`` "auto", "complex" and "native_pair" all mean
native complex, and ``green_kernel`` "auto", "xla", "df32" and "pallas"
all mean K3c; ``green_refine_iters``, ``ozaki_chain_limbs``,
``stab_dtype`` and ``wrap_prec`` are accepted and not read (wraps always
run at full precision).

The slice update follows the JAX model's kernel route
(``_update_slice_pallas``): proposals, the Delta blocks and the static
action difference are built for all sites of a slice at once, then a
kernel walks the sites with a log-domain accept
lhs < c_det log|R|^2 + live, c_det = 1/2 (full) or 1 (reduced): K4
(linalg/sdw_update.py, the immediate update) or K5
(linalg/sdw_delayed.py, chunks of ``delay`` sites, 8 by default, one
launch per slice with its flushes), each with instances for q = 4 complex
and q = 2 complex and real. The weight is phase-free (R is real and
non-negative by the model's antiunitary symmetry; the reduced weight is
|R_A|^2), so ``phase`` stays exactly 1. The JAX CPU route
(``fermion_repr="complex"``) accepts on u < |R| e^{jac - dS} (reduced:
|R_A|^2 e^{jac - dS}) and tracks the phase: the same weight. With
``turnoffFermions`` the update is the bosonic Metropolis step alone,
u < e^{jac - dS} site by site with G untouched, in plain PyTorch (no
kernel: the JAX model's scan route, sdw.py:1309-1313).

Routes, as the JAX model dispatches them (``SDWModel.routes``):
- update: K5 if ``update_kernel="delayed"`` or ``delay > 0``, or
  ``update_kernel="auto"`` at dim >= 128 (sdw.py:637-646 of the JAX
  model); else K4;
- wraps and the square B / B^H applies: K6 (linalg/sdw_wrap.py) if
  ``wrap_kernel="fused"``, or ``"auto"`` at dim >= 128 on a CUDA device
  (sdw.py:526-536); else the einsum/matmul applies;
- refactor QR: K2c (K2 on the real chain) within one block's shared
  memory, else K7; inner solve: K3c (K3), else K8 and K9 (linalg/qr.py,
  linalg/green_solve.py, linalg/trinv.py).
Kernel versus plain version is decided by the device of the tensors:
the kernels on a CUDA tensor, their plain PyTorch versions on a CPU
tensor.

Unequal-time measurements: ``_td_stacks`` gives both half-chain stacks
from the field (``_build_stack``, straight and transposed),
``time_displaced_greens`` / ``_rev`` solve G(tau, 0) / G(0, tau) at the
K+1 anchors with the dense-RHS inner solve (udv.green_tau_zero: K3c's or
K8's ``_rhs`` entry with K9 on the card), the ``_all`` variants wrap
between anchors to every slice (forward by ``b_mult_left``, K6's apply at
dim >= 128 on the card; backward by ``b_inv_mult_right``, plain applies
as in the JAX model), and ``measure_time_displaced`` and
``pair_susceptibilities`` reduce them. Walkers lead, then the anchor (or
slice) axis.

Global moves (``global_moves``, fired by the driver every
globalUpdateInterval sweeps): the global shift, the Wolff cluster
reflection and the Wolff reflection plus a perpendicular shift, batched
over walkers, with injected draws (``draws``) or a ``torch.Generator``.
Each accepts on ld_new - ld_old (- dS) with ld = ``_chain_logdet``, the
physical log-weight from the inverse-free log|det(1 + B_m ... B_1)| of
the whole chain (udv.clog_abs_det_one_plus_udv: K2c, K2 or K7 on the
card; twice sector A's on the reduced chain), and refreshes
every walker from the stack of the field it keeps (the two stacks the
log-dets were read from, selected per walker: bitwise the stack
refresh_from_field builds). The Wolff clusters grow in plain PyTorch on
the model's device, as the JAX model grows them in a lax.while_loop
outside any kernel; their dot products are summed in index order so the
card and the CPU give the same bits.

The parallel-tempering hooks (JAX sdw.py:2045-2071): ``control_parameter
= "r"``, ``exchange_action`` = dtau/2 sum phi^2 (the r-conjugate piece of
S_B), ``with_r`` and ``log_weight`` = ``_chain_logdet`` - S_B in float64
(``log_weight_and_stack`` returns the stack the log-det was read from, as
the global moves reuse theirs).

Not ported yet (each raises NotImplementedError naming ROADMAP.md, Queue
1 item 8 and Queue 2): the full (4N, 4N) matrix at opdim 1 (a real q = 4
chain), the real embedding, the refine green route, sparse checkerboard
applies, ``sweep_simple``, dims above 512
(L >= 12 full, L >= 17 reduced) on a CUDA device, and
``update_kernel="pallas"`` / ``"scan"`` (K4) at a dim whose G exceeds K4's
shared memory on a CUDA device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from detqmc_tpu_torch import lattice as lattice_mod
from detqmc_tpu_torch.lattice import kinetic_exponentials
from detqmc_tpu_torch.linalg import _kernels, sdw_delayed, sdw_update
from detqmc_tpu_torch.linalg import sdw_wrap
from detqmc_tpu_torch.linalg.qr import MAX_N_BIG
from detqmc_tpu_torch.linalg.udv import (UDV, clog_abs_det_one_plus_udv,
                                         green_from_two_udv, green_tau_zero,
                                         udv_refactor)
from detqmc_tpu_torch.models.unequal_time import (trapezoid_weights,
                                                  wrap_between_anchors)
from detqmc_tpu_torch.precision import mm

N_ORB = 4  # physical orbitals: (band x, band y) x (spin up, spin dn)
_DTYPES = {"float32": (torch.float32, torch.complex64),
           "float64": (torch.float64, torch.complex128)}
_ROADMAP = "ROADMAP.md Queue 1 item 8"
BIG_DIM = 128       # the JAX model's delayed-update and fused-wrap gate


def _unported(what: str, where: str = _ROADMAP) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {where}")


@dataclasses.dataclass(frozen=True)
class SDWConfig:
    """Static parameters, field for field those of
    detqmc_tpu.models.sdw.SDWConfig (see the module docstring for the
    fields the port maps, ignores or refuses)."""

    L: int = 4
    opdim: int = 2
    r: float = 0.0
    lam: float = 1.0
    u: float = 1.0
    c: float = 1.0
    txhor: float = -1.0
    txver: float = -0.5
    tyhor: float = -0.5
    tyver: float = -1.0
    mu: float = -0.5
    beta: float = 4.0
    m: int = 40
    s: int = 4
    delay: int = 0
    box_width: float = 1.0
    checkerboard: bool = False
    cb_apply: str = "auto"
    spinProposalMethod: str = "box"
    globalShift: bool = False
    wolffClusterUpdate: bool = False
    wolffClusterShiftUpdate: bool = False
    globalUpdateInterval: int = 5
    turnoffFermions: bool = False
    fermion_repr: str = "auto"
    fermion_matrix: str = "auto"
    green_kernel: str = "auto"
    green_refine_iters: int | None = None
    ozaki_chain_limbs: int | None = None
    update_kernel: str = "auto"
    wrap_prec: str = "auto"
    wrap_kernel: str = "auto"
    dtype: str = "float32"
    stab_dtype: str = "auto"

    def __post_init__(self):
        if self.m % self.s != 0:
            raise ValueError(f"m={self.m} must be divisible by s={self.s}")
        if self.opdim not in (1, 2, 3):
            raise ValueError("opdim must be 1, 2 or 3")
        if self.delay < 0:
            raise ValueError("delay must be >= 0")
        if self.checkerboard and self.L % 2 != 0:
            raise ValueError("checkerboard requires even L")
        if self.spinProposalMethod not in (
                "box", "rotate_then_scale", "rotate_and_scale"):
            raise ValueError("spinProposalMethod must be box|"
                             "rotate_then_scale|rotate_and_scale, got "
                             f"{self.spinProposalMethod!r}")
        if self.spinProposalMethod != "box" and self.opdim == 1:
            raise ValueError("rotate/scale proposals need opdim >= 2 "
                             "(an Ising field has no direction to rotate)")
        if self.update_kernel not in ("auto", "pallas", "delayed", "scan"):
            raise ValueError("update_kernel must be auto|pallas|delayed|"
                             f"scan, got {self.update_kernel!r}")
        if self.cb_apply not in ("auto", "dense", "sparse"):
            raise ValueError("cb_apply must be auto|dense|sparse, got "
                             f"{self.cb_apply!r}")
        if self.wrap_prec not in ("auto", "highest", "high"):
            raise ValueError("wrap_prec must be auto|highest|high, got "
                             f"{self.wrap_prec!r}")
        if self.wrap_kernel not in ("auto", "fused", "xla"):
            raise ValueError("wrap_kernel must be auto|fused|xla, got "
                             f"{self.wrap_kernel!r}")

    @property
    def dtau(self) -> float:
        return self.beta / self.m

    @property
    def n_sites(self) -> int:
        return self.L * self.L

    @property
    def reduced(self) -> bool:
        """The two-sector chain (sector A alone): the default at opdim <= 2
        (JAX sdw.py:406-413)."""
        if self.fermion_matrix == "auto":
            return self.opdim <= 2
        return self.fermion_matrix == "reduced"

    @property
    def n_orb(self) -> int:
        """Orbitals of the chain's matrix: q of its site blocks."""
        return 2 if self.reduced else N_ORB

    @property
    def dim(self) -> int:
        return self.n_orb * self.n_sites

    @property
    def n_stack(self) -> int:
        return self.m // self.s

    @property
    def torch_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be float32|float64, got "
                             f"{self.dtype!r}")
        return _DTYPES[self.dtype][0]

    @property
    def cdtype(self) -> torch.dtype:
        """Fermion-matrix dtype: complex for opdim >= 2 (sigma_y), real for
        the Ising case."""
        self.torch_dtype  # validates
        return _DTYPES[self.dtype][0 if self.opdim == 1 else 1]


class SDWState(NamedTuple):
    """Per-walker state, walkers leading (JAX's SDWState minus ``key``: the
    generator is held by the caller)."""

    phi: torch.Tensor          # (W, m, N, opdim) order-parameter field
    G: torch.Tensor            # (W, dim, dim) equal-time G at the sweep edge
    stack_U: torch.Tensor      # (W, K+1, dim, dim) cdtype
    stack_d: torch.Tensor      # (W, K+1, dim) float64
    stack_V: torch.Tensor      # (W, K+1, dim, dim) complex128 (float64 at
    #                            opdim 1)
    phase: torch.Tensor        # (W,) cdtype, exactly 1 (phase-free weight)
    box_width: torch.Tensor    # (W,) proposal width
    r: torch.Tensor            # (W,) control parameter
    next_dir: torch.Tensor     # (W,) int32: 0 = next sweep up, 1 = down
    sweeps_done: torch.Tensor  # (W,) int32
    green_dev: torch.Tensor    # (W,) f32 max |G_wrapped - G_stab| last sweep
    sv_min: torch.Tensor       # (W,) f32 log10 smallest stack scale
    sv_max: torch.Tensor       # (W,) f32


class SDWObservables(NamedTuple):
    """Per-walker measurement, the JAX package's observable set."""

    phiSquared: torch.Tensor
    phiFourth: torch.Tensor
    phiNorm: torch.Tensor
    sdwSusceptibility: torch.Tensor
    occupancy: torch.Tensor
    kineticEnergy: torch.Tensor
    bosonAction: torch.Tensor
    exchangeAction: torch.Tensor
    phase: torch.Tensor
    acceptance: torch.Tensor
    phiCorrelation: torch.Tensor        # (W, N)
    phiStructureFactor: torch.Tensor    # (W, N)
    chargeCorrelation: torch.Tensor     # (W, N)
    chargeStructureFactor: torch.Tensor
    spinZCorrelation: torch.Tensor
    spinZStructureFactor: torch.Tensor
    pairingCorrelation: torch.Tensor
    kOccupationX: torch.Tensor
    kOccupationY: torch.Tensor
    occupancyX: torch.Tensor
    occupancyY: torch.Tensor


def _pauli_stack(opdim: int) -> np.ndarray:
    sx = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    sy = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
    sz = np.array([[1, 0], [0, -1]], dtype=np.complex128)
    return np.stack([sx, sy, sz][:opdim])


def _dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_i a[..., i] b[..., i] over the (short) last axis, added in index
    order one rounded operation at a time: the same bits on the card and
    on the CPU (a reduction kernel may order the terms otherwise)."""
    out = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        out = out + a[..., i] * b[..., i]
    return out


def _cb_dense_product(partner: np.ndarray, cosh_og: np.ndarray,
                      sinh_og: np.ndarray, gamma: float):
    """Exact dense product matrices (E, E^{-1}) of the checkerboard
    breakup, E = gamma F_0 F_1 ... F_{g-1} per orbital with F_g = cosh_g I
    + sinh_g P_g; the inverse is the reversed product of the per-factor
    inverses (the sinh sign flips). partner: (n_g, N); cosh_og/sinh_og:
    (n_orb, n_g); returns two (n_orb, N, N) float64 arrays."""
    n_g, N = partner.shape
    n_orb = cosh_og.shape[0]
    E = np.broadcast_to(np.eye(N), (n_orb, N, N)).copy()
    Einv = E.copy()
    for g in reversed(range(n_g)):
        E = cosh_og[:, g][:, None, None] * E \
            + sinh_og[:, g][:, None, None] * E[:, partner[g], :]
    for g in range(n_g):
        Einv = cosh_og[:, g][:, None, None] * Einv \
            - sinh_og[:, g][:, None, None] * Einv[:, partner[g], :]
    return gamma * E, Einv / gamma


class SDWModel(nn.Module):
    """Config + device constants (registered buffers) + the sweep.

    ``vector_observables`` declares which observable names are vectors
    (the drivers register them with their observable handlers)."""

    vector_observables = ("phiCorrelation", "phiStructureFactor",
                          "chargeCorrelation", "chargeStructureFactor",
                          "spinZCorrelation", "spinZStructureFactor",
                          "pairingCorrelation", "kOccupationX",
                          "kOccupationY", "greenKTauVector")

    def __init__(self, cfg: SDWConfig, device=None):
        super().__init__()
        self._check_ported(cfg)
        if cfg.green_kernel not in ("auto", "xla", "df32", "pallas"):
            raise ValueError(f"unknown green_kernel {cfg.green_kernel!r}")
        self.cfg = cfg
        self.lat = lattice_mod.SquareLattice(cfg.L)
        self.rdtype, self.cdtype = cfg.torch_dtype, cfg.cdtype
        self.dim = cfg.dim
        self.n_orb = q = cfg.n_orb
        # the weight: |R| = (|R|^2)^(1/2) of the full block, |R_A|^2 of the
        # reduced one (sector B contributes conj(R_A)); the log-weight's
        # factor on sector A's log-det likewise (JAX logdet_fac)
        self.c_det = 1.0 if cfg.reduced else 0.5
        self.logdet_fac = 2.0 if cfg.reduced else 1.0
        N = cfg.n_sites
        # the card unless the caller names another device: on a machine
        # without one, torch's own error, never a silent CPU run
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            self._check_kernel_bounds(cfg)
        route = self.routes(cfg, dev.type)
        self._delayed = route["update"] == "delayed"
        self._fused = route["wrap"] == "fused"
        self._delay_k = cfg.delay if cfg.delay > 0 else 8
        Kx = self.lat.hopping_matrix(1.0, tx=cfg.txhor, ty=cfg.txver)
        Ky = self.lat.hopping_matrix(1.0, tx=cfg.tyhor, ty=cfg.tyver)
        expKx, expKx_inv = kinetic_exponentials(Kx, cfg.dtau, cfg.mu)
        expKy, expKy_inv = kinetic_exponentials(Ky, cfg.dtau, cfg.mu)
        # the orbitals' bands: (x_up, x_dn, y_up, y_dn), or sector A
        # (x_up, y_dn)
        bands = ["x", "y"] if cfg.reduced else ["x", "x", "y", "y"]
        per = {"x": (expKx, expKx_inv, Kx, cfg.txhor, cfg.txver),
               "y": (expKy, expKy_inv, Ky, cfg.tyhor, cfg.tyver)}
        ek = np.stack([per[b][0] for b in bands])
        eki = np.stack([per[b][1] for b in bands])
        if cfg.checkerboard:
            # per-orbital group coefficients: groups (0, 1) horizontal
            # bonds, (2, 3) vertical; applied as the exact dense product
            partner = self.lat.checkerboard_groups()
            th = np.array([per[b][3] for b in bands])
            tv = np.array([per[b][4] for b in bands])
            tg = np.stack([th, th, tv, tv], axis=1)           # (n_orb, 4)
            ek, eki = _cb_dense_product(
                partner, np.cosh(cfg.dtau * tg), np.sinh(cfg.dtau * tg),
                float(np.exp(cfg.dtau * cfg.mu)))

        def buf(name, a, dtype):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(a), dtype=dtype, device=dev))

        cdt, rdt = self.cdtype, self.rdtype
        buf("expK", ek, cdt)                                   # (q, N, N)
        buf("expK_inv", eki, cdt)
        # K6 reads the kinetic factors as real matrices: their real copies,
        # built once here (not saved: they follow from the config)
        self.register_buffer("expK_real", self.expK.real.contiguous(),
                             persistent=False)
        self.register_buffer("expK_inv_real", self.expK_inv.real.contiguous(),
                             persistent=False)
        buf("K_orb", np.stack([per[b][2] for b in bands]), cdt)
        if not cfg.reduced:
            buf("paulis", _pauli_stack(cfg.opdim), cdt)        # (3, 2, 2)
        self.register_buffer("_eye_q", torch.eye(q, dtype=cdt, device=dev),
                             persistent=False)
        nb = self.lat.neighbors()                              # (N, 4)
        buf("nb", nb, torch.int32)       # K4's table
        buf("nb_idx", nb, torch.int64)   # gathers
        s_ = np.arange(N)
        xs, ys = self.lat.xy(s_)
        buf("disp_idx", self.lat.site(xs[None, :] + xs[:, None],
                                      ys[None, :] + ys[:, None]), torch.int64)
        rg = np.stack([xs, ys], axis=1)
        kg = self.lat.k_grid()
        buf("four_cos", np.cos(kg @ rg.T), rdt)
        buf("four_sin", np.sin(kg @ rg.T), rdt)
        buf("_dwave_D", self.lat.dwave_form_factor(), rdt)

    @staticmethod
    def _check_ported(cfg: SDWConfig) -> None:
        if cfg.fermion_matrix not in ("auto", "full", "reduced"):
            raise ValueError(f"bad fermion_matrix {cfg.fermion_matrix!r}")
        if cfg.fermion_matrix == "reduced" and cfg.opdim == 3:
            raise ValueError("opdim=3 has no two-sector reduction (phi_z "
                             "couples the sectors)")
        if cfg.opdim == 1 and not cfg.reduced:
            raise _unported("fermion_matrix='full' at opdim=1 (a real "
                            "4x4-block chain)")
        if cfg.fermion_repr == "real_embed":
            raise _unported("fermion_repr='real_embed' (a TPU device, not "
                            "to be ported)", "ROADMAP.md Queue 1 item 12")
        if cfg.fermion_repr not in ("auto", "complex", "native_pair"):
            raise ValueError(f"bad fermion_repr {cfg.fermion_repr!r}")
        if cfg.green_kernel == "refine":
            raise _unported("green_kernel='refine'",
                            "ROADMAP.md Queue 1 item 9")
        if cfg.checkerboard and cfg.cb_apply == "sparse":
            raise _unported("cb_apply='sparse' (the dense checkerboard "
                            "product is ported)")
        if cfg.turnoffFermions and cfg.update_kernel in ("pallas",
                                                          "delayed"):
            raise ValueError(f"update_kernel={cfg.update_kernel!r} is a "
                             "fermionic update path (turnoffFermions is "
                             "set)")

    @staticmethod
    def routes(cfg: SDWConfig, device_type: str) -> dict:
        """{"update": "delayed" (K5) | "immediate" (K4) | "bosonic" (no
        kernel: turnoffFermions), "wrap": "fused" (K6) | "plain"} for a
        model on a device of this type (see the module docstring)."""
        big = cfg.dim >= BIG_DIM
        delayed = (cfg.update_kernel == "delayed" or cfg.delay > 0
                   or (cfg.update_kernel == "auto" and big))
        fused = (cfg.wrap_kernel == "fused"
                 or (cfg.wrap_kernel == "auto" and big
                     and device_type == "cuda"))
        update = ("bosonic" if cfg.turnoffFermions
                  else "delayed" if delayed else "immediate")
        return {"update": update, "wrap": "fused" if fused else "plain"}

    @staticmethod
    def _check_kernel_bounds(cfg: SDWConfig) -> None:
        """On a CUDA device the dim must be within the blocked kernels'
        bound (qr.MAX_N_BIG: K5 and K7-K9 all fit their shared memory up
        to it), K6 needs a plan (one orbital's kinetic factor in one
        block's shared memory: at q = 2 N <= 219 in complex64, 149 in
        complex128, 228 in float32, 158 in float64), and the immediate
        update K4 needs G in one block's shared memory."""
        dim = cfg.dim
        if dim > MAX_N_BIG:
            raise _unported(f"SDW at dim {dim} > {MAX_N_BIG} on a CUDA device",
                            "ROADMAP.md Queue 1 item 8")
        if SDWModel.routes(cfg, "cuda")["wrap"] == "fused":
            try:
                sdw_wrap.plan(cfg.n_sites, cfg.cdtype, q=cfg.n_orb)
            except ValueError:
                raise _unported(f"the fused wrap K6 at N = {cfg.n_sites} "
                                f"({cfg.cdtype}, q = {cfg.n_orb}) on a CUDA "
                                "device", "ROADMAP.md Queue 2") from None
        if SDWModel.routes(cfg, "cuda")["update"] == "immediate" and (
                dim > sdw_update.MAX_H or sdw_update.smem_bytes(
                    cfg.n_sites, cfg.opdim, cfg.cdtype, cfg.n_orb)
                > _kernels.MAX_SMEM_BYTES - 1024):
            raise _unported(f"update_kernel={cfg.update_kernel!r} (K4, G in "
                            f"one block's shared memory) at dim {dim} on a "
                            "CUDA device (update_kernel='delayed' runs K5)",
                            "ROADMAP.md Queue 1 item 8")

    @property
    def device(self) -> torch.device:
        return self.expK.device

    # ---- potential factor ---------------------------------------------------
    def exp_v_blocks(self, phi_slice: torch.Tensor, sign: float = -1.0
                     ) -> torch.Tensor:
        """exp(sign dtau V(phi)) as per-site q x q blocks: (..., N, q, q)
        from (..., N, opdim), closed form via V^2 = (lam |phi|)^2."""
        cfg, cdt = self.cfg, self.cdtype
        nrm = torch.sqrt(torch.sum(phi_slice ** 2, dim=-1))
        a = cfg.dtau * cfg.lam * nrm
        sh_over = torch.where(nrm > 0, torch.sinh(a) / torch.clamp(
            nrm, min=1e-30), torch.full_like(nrm, cfg.dtau * cfg.lam))
        if cfg.reduced:
            return self._assemble_reduced(phi_slice, torch.cosh(a),
                                          sign * sh_over)
        ch = torch.cosh(a).to(cdt)[..., None, None]
        Phi = torch.einsum("...o,oab->...ab", phi_slice.to(cdt), self.paulis)
        coef = (sign * sh_over).to(cdt)[..., None, None]
        eye2 = torch.eye(2, dtype=cdt, device=phi_slice.device)
        row1 = torch.cat([ch * eye2, coef * Phi], dim=-1)
        row2 = torch.cat([coef * Phi.mH, ch * eye2], dim=-1)
        return torch.cat([row1, row2], dim=-2)

    def _assemble_reduced(self, phi, ch, s):
        """Sector A's block exp(sign dtau V_A), V_A = lam [[0, p], [p*, 0]],
        p = phi_x - i phi_y (the JAX model's _assemble_reduced): cosh(a) 1
        + s V_A / lam with s = sign sinh(a) / |phi|; (..., 2, 2), real at
        opdim 1, complex at opdim 2."""
        off_re = s * phi[..., 0]
        if self.cfg.opdim == 1:
            return torch.stack([torch.stack([ch, off_re], -1),
                                torch.stack([off_re, ch], -1)], -2)
        off = torch.complex(off_re, -s * phi[..., 1])
        chc = ch.to(self.cdtype)
        return torch.stack([torch.stack([chc, off], -1),
                            torch.stack([off.conj(), chc], -1)], -2)

    def _exp_v_single(self, phi_i: torch.Tensor, sign: float) -> torch.Tensor:
        """exp(sign dtau V) for single sites: (..., q, q) from (..., opdim)."""
        return self.exp_v_blocks(phi_i, sign)

    # ---- B applies (X: (W, dim, dim)); the factors live in linalg/sdw_wrap.py
    def _apply(self, blocks, X, herm: bool):
        # the sweep applies B only to the square lazy U; K6 raises on any
        # other operand of a CUDA tensor
        if self._fused:
            return sdw_wrap.apply(X.contiguous(), self.expK_real, blocks, herm)
        return sdw_wrap.apply_plain(X, self.expK, blocks, herm)

    # B = D_V expK (potential leftmost, as in Hubbard)
    def b_mult_left(self, blocks, X):
        return self._apply(blocks, X, herm=False)

    def b_inv_mult_right(self, X, blocks_inv):
        """X @ B^{-1} = (X expK^{-1}) D_V^{-1}, plain applies (as in the
        JAX model, no fused kernel takes it)."""
        return sdw_wrap.dv_right(sdw_wrap.kin_right(X, self.expK_inv),
                                 blocks_inv)

    def bT_mult_left(self, blocks, X):
        """B^H @ X = expK^H (D_V^H X), for the conj-transposed right stack
        (expK is real)."""
        return self._apply(blocks, X, herm=True)

    # ---- boson action ---------------------------------------------------------
    def boson_action(self, phi, r=None):
        """S_B[phi] per walker: phi (W, m, N, opdim), r None (cfg.r) or
        (W,)."""
        cfg = self.cfg
        r = cfg.r if r is None else r
        dtau = cfg.dtau
        d_tau = phi - torch.roll(phi, 1, dims=1)
        s_tau = torch.sum(d_tau ** 2, dim=(1, 2, 3)) \
            / (2.0 * cfg.c ** 2 * dtau ** 2)
        dx = phi - phi[:, :, self.nb_idx[:, 0]]
        dy = phi - phi[:, :, self.nb_idx[:, 2]]
        s_grad = 0.5 * (torch.sum(dx ** 2, dim=(1, 2, 3))
                        + torch.sum(dy ** 2, dim=(1, 2, 3)))
        phi2 = torch.sum(phi ** 2, dim=-1).reshape(phi.shape[0], -1)
        s_pot = 0.5 * r * torch.sum(phi2, dim=1) \
            + 0.25 * cfg.u * torch.sum(phi2 ** 2, dim=1)
        return dtau * (s_tau + s_grad + s_pot)

    # ---- proposals -------------------------------------------------------------
    def _draw_proposal_randoms(self, W: int, generator: torch.Generator):
        """One sweep's draws, slice axis indexed by l - 1: (u01 (W, m, N),
        rnd) with rnd = (deltas (W, m, N, opdim) uniform in [-1, 1),) for
        box proposals, (dirs (W, m, N, opdim), gs (W, m, N)) standard
        normal for the rotate methods (JAX: _draw_proposal_randoms, whose
        box deltas are these times box_width)."""
        cfg = self.cfg
        shp = (W, cfg.m, cfg.n_sites)
        kw = dict(generator=generator, dtype=self.rdtype, device=self.device)
        u01 = torch.rand(shp, **kw)
        if cfg.spinProposalMethod == "box":
            return u01, (2.0 * torch.rand(shp + (cfg.opdim,), **kw) - 1.0,)
        return u01, (torch.randn(shp + (cfg.opdim,), **kw),
                     torch.randn(shp, **kw))

    def _propose_all(self, phi_l0, rnd, box_w, alt):
        """Proposals for every site of a slice (each site is visited once
        per slice, so every proposal sees the pre-scan field) ->
        (phi_new (W, N, opdim), log-measure jac (W, N)). rnd holds this
        slice's draws; box deltas are scaled by box_w (W,) here."""
        cfg = self.cfg
        if cfg.spinProposalMethod == "box":
            (deltas,) = rnd
            return (phi_l0 + deltas * box_w[:, None, None],
                    torch.zeros(phi_l0.shape[:-1], dtype=phi_l0.dtype,
                                device=phi_l0.device))
        dirs, gs = rnd
        tiny = 1e-30
        r2_old = torch.sum(phi_l0 ** 2, dim=-1)
        r_old = torch.sqrt(torch.clamp(r2_old, min=tiny))
        dir_new = dirs / torch.sqrt(torch.clamp(
            torch.sum(dirs ** 2, dim=-1, keepdim=True), min=tiny))
        r2_new = torch.abs(r2_old + box_w[:, None] * gs)
        r_new = torch.sqrt(torch.clamp(r2_new, min=tiny))
        jac_scale = 0.5 * (cfg.opdim - 2) * (
            torch.log(torch.clamp(r2_new, min=tiny))
            - torch.log(torch.clamp(r2_old, min=tiny)))
        if cfg.spinProposalMethod == "rotate_and_scale":
            return r_new[..., None] * dir_new, jac_scale
        rot = r_old[..., None] * dir_new
        scl = phi_l0 * (r_new / r_old)[..., None]
        first = (alt == 0)[:, None]
        return (torch.where(first[..., None], rot, scl),
                torch.where(first, torch.zeros_like(jac_scale), jac_scale))

    def _ds_static(self, phi_l0, phi_new, phi_lp, phi_lm, r):
        """Static part of the per-site boson-action difference (W, N): tau
        links, r/u potential and the gradient self terms, all functions of
        the pre-scan field; K4 adds the live -dtau dphi . sum phi[nb]."""
        cfg = self.cfg
        dtau = cfg.dtau

        def tau_t(p):
            return (torch.sum((p - phi_lp) ** 2, -1)
                    + torch.sum((p - phi_lm) ** 2, -1)) \
                / (2.0 * cfg.c ** 2 * dtau ** 2)

        p2n = torch.sum(phi_new ** 2, -1)
        p2o = torch.sum(phi_l0 ** 2, -1)
        pot = 0.5 * r[:, None] * (p2n - p2o) \
            + 0.25 * cfg.u * (p2n ** 2 - p2o ** 2)
        grad_self = 2.0 * (p2n - p2o)
        return dtau * (tau_t(phi_new) - tau_t(phi_l0) + grad_self + pot)

    # ---- site updates -------------------------------------------------------
    def update_slice(self, G, phi, l_1based: int, u01, rnd, box_w, r, alt):
        """Sequential single-site phi updates in slice l (the JAX model's
        kernel route, _update_slice_pallas): G (W, dim, dim), phi
        (W, m, N, opdim), u01 (W, N) and rnd this slice's draws. K5
        (delayed) or K4 on a CUDA tensor, their plain versions on a CPU
        tensor; with turnoffFermions the bosonic step alone
        (``_update_slice_bosonic``). Returns (G, phi, acc_rate (W,))."""
        cfg = self.cfg
        m, N = cfg.m, cfg.n_sites
        l_idx = l_1based - 1
        phi_lp = phi[:, (l_idx + 1) % m]
        phi_lm = phi[:, (l_idx - 1) % m]
        phi_l0 = phi[:, l_idx]
        phi_new, jac = self._propose_all(phi_l0, rnd, box_w, alt)
        if cfg.turnoffFermions:
            phi_l, acc = self._update_slice_bosonic(
                phi_l0, phi_new, jac, phi_lp, phi_lm, u01, r)
            phi = phi.clone()
            phi[:, l_idx] = phi_l
            return G, phi, acc / N
        lhs = (torch.log(u01) - jac
               + self._ds_static(phi_l0, phi_new, phi_lp, phi_lm, r))
        en = self.exp_v_blocks(phi_new, -1.0)
        eo_inv = self.exp_v_blocks(phi_l0, +1.0)
        delta = mm(en, eo_inv) - self._eye_q
        args = (G.contiguous(), phi_l0.contiguous(), phi_new.contiguous(),
                lhs.contiguous(), delta.contiguous(), self.nb, cfg.dtau,
                self.c_det)
        if self._delayed:
            G, phi_l, acc = sdw_delayed.sdw_delayed(*args, self._delay_k)
        else:
            G, phi_l, acc = sdw_update.sdw_update(*args)
        phi = phi.clone()
        phi[:, l_idx] = phi_l
        return G, phi, acc / N

    def _update_slice_bosonic(self, phi_l0, phi_new, jac, phi_lp, phi_lm,
                              u01, r):
        """The turnoffFermions site scan (the JAX model's update_slice
        with turnoffFermions, sdw.py:1290-1313): site by site, accept on
        u < exp(jac - dS) with dS the difference of the site's local
        boson action at the proposal and at the current value, the live
        field's neighbours included; G is not touched. Plain PyTorch,
        batched over walkers. Returns (phi_l (W, N, opdim), accepted
        sites (W,))."""
        cfg = self.cfg
        dtau = cfg.dtau
        phi_l = phi_l0.clone()
        acc = torch.zeros_like(jac[:, 0])
        nbs = self.nb_idx.tolist()

        def local(i, p):
            tau_t = (torch.sum((p - phi_lp[:, i]) ** 2, -1)
                     + torch.sum((p - phi_lm[:, i]) ** 2, -1)) \
                / (2.0 * cfg.c ** 2 * dtau ** 2)
            grad = 0.5 * torch.sum((p[:, None, :] - phi_l[:, nbs[i]]) ** 2,
                                   dim=(-2, -1))
            phi2 = torch.sum(p ** 2, -1)
            pot = 0.5 * r * phi2 + 0.25 * cfg.u * phi2 ** 2
            return dtau * (tau_t + grad + pot)

        for i in range(cfg.n_sites):
            old, new = phi_l[:, i].clone(), phi_new[:, i]
            d_s = local(i, new) - local(i, old)
            accept = u01[:, i] < torch.exp(jac[:, i] - d_s)
            phi_l[:, i] = torch.where(accept[:, None], new, old)
            acc = acc + accept.to(acc.dtype)
        return phi_l, acc

    # ---- wraps ----------------------------------------------------------------
    def _wrap(self, G, blocks, blocks_inv, up: bool):
        if self._fused:
            return sdw_wrap.wrap(G.contiguous(), self.expK_real,
                                 self.expK_inv_real, blocks, blocks_inv, up)
        return sdw_wrap.wrap_plain(G, self.expK, self.expK_inv, blocks,
                                   blocks_inv, up)

    def wrap_up(self, G, blocks, blocks_inv):
        """G(l) = B_l G(l-1) B_l^{-1}."""
        return self._wrap(G, blocks, blocks_inv, up=True)

    def wrap_down(self, G, blocks, blocks_inv):
        """G(l-1) = B_l^{-1} G(l) B_l."""
        return self._wrap(G, blocks, blocks_inv, up=False)

    # ---- measurement ------------------------------------------------------------
    def _phys_green_parts(self, G):
        """(re, im) of the physical 4-orbital Green blocks, (W, 4, 4, N, N)
        in the basis (x_up, x_dn, y_up, y_dn). The reduced chain carries
        sector A = (x_up, y_dn); sector B = (x_dn, y_up) is its conjugate
        and the cross-sector blocks are zero (the JAX model's
        _phys_green_parts, sdw.py:1509-1555)."""
        N, q = self.cfg.n_sites, self.n_orb
        g = G.reshape(-1, q, N, q, N).permute(0, 1, 3, 2, 4)
        a, b = (g.real, g.imag) if g.is_complex() else (g, torch.zeros_like(g))
        if not self.cfg.reduced:
            return a, b
        z = torch.zeros_like(a[:, 0, 0])

        def blocks(rows):
            return torch.stack([torch.stack([z if e is None else e
                                             for e in r], 1) for r in rows], 1)

        re4 = blocks([[a[:, 0, 0], None, None, a[:, 0, 1]],
                      [None, a[:, 0, 0], a[:, 0, 1], None],
                      [None, a[:, 1, 0], a[:, 1, 1], None],
                      [a[:, 1, 0], None, None, a[:, 1, 1]]])
        im4 = blocks([[b[:, 0, 0], None, None, b[:, 0, 1]],
                      [None, -b[:, 0, 0], -b[:, 0, 1], None],
                      [None, -b[:, 1, 0], -b[:, 1, 1], None],
                      [b[:, 1, 0], None, None, b[:, 1, 1]]])
        return re4, im4

    def _translation_average(self, X):
        """(W, N, N) -> (W, N): c(d) = mean_i X[i, i + d]."""
        rows = torch.arange(self.cfg.n_sites, device=X.device)[None, :]
        return X[:, rows, self.disp_idx].mean(dim=-1)

    def _fermion_correlations(self, G):
        """Equal-time Wick-contracted correlators from the 4-orbital
        blocks: a dict of (W, N) vectors and per-band occupancies (W,)."""
        N = self.cfg.n_sites
        rdt, dev = self.rdtype, G.device
        re, im = self._phys_green_parts(G)                 # (W, 4, 4, N, N)
        eyeN = torch.eye(N, dtype=rdt, device=dev)
        d4 = torch.eye(4, dtype=rdt, device=dev)
        # A[o, o', i, j] = <c+_{o,i} c_{o',j}> = delta delta - G[o', o]_ji
        A_re = d4[:, :, None, None] * eyeN - re.permute(0, 2, 1, 4, 3)
        A_im = -im.permute(0, 2, 1, 4, 3)
        n_oi = torch.stack([torch.diagonal(A_re[:, o, o], dim1=-2, dim2=-1)
                            for o in range(4)], dim=1)     # (W, 4, N)
        n_i = n_oi.sum(dim=1)
        prod = A_re * re - A_im * im

        def exch(w):
            return torch.einsum("o,p,wopij->wij", w, w, prod)

        ones4 = torch.ones(4, dtype=rdt, device=dev)
        wz = torch.tensor([0.5, -0.5, 0.5, -0.5], dtype=rdt, device=dev)
        exch_nn, exch_zz = exch(ones4), exch(wz)
        nn_ = n_i[:, :, None] * n_i[:, None, :] + exch_nn
        sz_i = torch.einsum("o,won->wn", wz, n_oi)
        szsz = sz_i[:, :, None] * sz_i[:, None, :] + exch_zz
        # onsite s-wave pairing (see the JAX model for the sector argument)
        pair = torch.zeros_like(exch_nn)
        for up, dn in ((0, 1), (2, 3)):
            pair = pair + (A_re[:, up, up] * A_re[:, dn, dn]
                           - A_im[:, up, up] * A_im[:, dn, dn])
        for (a1, a2), (b1, b2) in (((0, 3), (1, 2)), ((2, 1), (3, 0))):
            pair = pair - (A_re[:, a1, a2] * A_re[:, b1, b2]
                           - A_im[:, a1, a2] * A_im[:, b1, b2])
        ta = self._translation_average

        def ft(F, v):
            return torch.einsum("kd,wd->wk", F, v)

        kocc = []
        for orbs in ((0, 1), (2, 3)):
            cre = sum(ta(A_re[:, o, o]) for o in orbs)
            cim = sum(ta(A_im[:, o, o]) for o in orbs)
            kocc.append(ft(self.four_cos, cre) + ft(self.four_sin, cim))
        return {
            "chargeCorrelation": ta(nn_),
            "chargeStructureFactor": ft(self.four_cos, ta(exch_nn)),
            "spinZCorrelation": ta(szsz),
            "spinZStructureFactor": ft(self.four_cos, ta(exch_zz)),
            "pairingCorrelation": ta(pair),
            "kOccupationX": kocc[0],
            "kOccupationY": kocc[1],
            "occupancyX": n_oi[:, 0].mean(-1) + n_oi[:, 1].mean(-1),
            "occupancyY": n_oi[:, 2].mean(-1) + n_oi[:, 3].mean(-1),
        }

    def _phi_correlations(self, phi):
        """Equal-time order-parameter observables, tau-averaged: S_phi(k)
        (W, N) and its inverse FT c(d) = <phi_0 . phi_d> (W, N)."""
        N = self.cfg.n_sites
        C = torch.einsum("kn,wlno->wlko", self.four_cos, phi)
        S = torch.einsum("kn,wlno->wlko", self.four_sin, phi)
        sk = (C ** 2 + S ** 2).sum(-1).mean(1) / N
        cd = torch.einsum("kd,wk->wd", self.four_cos, sk) / N
        return cd, sk

    def measure(self, G, phi, phase, acc_rate) -> SDWObservables:
        cfg = self.cfg
        N = cfg.n_sites
        phi2 = torch.sum(phi ** 2, dim=-1)                     # (W, m, N)
        phibar = phi.mean(dim=(1, 2))                          # (W, opdim)
        chi = cfg.beta * N * torch.sum(phibar ** 2, dim=-1)
        # sector B contributes as much as sector A to every real trace
        sector = 2.0 if cfg.reduced else 1.0
        q = self.n_orb
        occ = N_ORB - sector * torch.diagonal(
            G, dim1=-2, dim2=-1).sum(-1).real / N
        Gorb = G.reshape(-1, q, N, q, N)
        e_kin = -sector * sum(torch.sum(self.K_orb[o].T * Gorb[:, o, :, o, :],
                                        dim=(-2, -1)) for o in range(q)).real / N
        phicorr, phisf = self._phi_correlations(phi)
        return SDWObservables(
            phiSquared=phi2.mean(dim=(1, 2)),
            phiFourth=(phi2 ** 2).mean(dim=(1, 2)),
            phiNorm=torch.sqrt(phi2).mean(dim=(1, 2)),
            sdwSusceptibility=chi,
            occupancy=occ,
            kineticEnergy=e_kin,
            bosonAction=self.boson_action(phi) / (cfg.m * N),
            exchangeAction=0.5 * cfg.dtau * torch.sum(phi ** 2,
                                                      dim=(1, 2, 3)),
            phase=phase.real,
            acceptance=acc_rate,
            phiCorrelation=phicorr,
            phiStructureFactor=phisf,
            **self._fermion_correlations(G))

    # ---- sweeps -------------------------------------------------------------------
    @property
    def vdtype(self) -> torch.dtype:
        """The stack's V dtype: complex128, float64 on the real chain."""
        return torch.complex128 if self.cdtype.is_complex else torch.float64

    def _eye_mixed(self, W: int) -> UDV:
        """Identity UdV per walker: U in cdtype, d float64, V in vdtype
        (the stack layout)."""
        dim, dev = self.dim, self.device
        return UDV(torch.eye(dim, dtype=self.cdtype, device=dev).expand(
                       W, dim, dim),
                   torch.ones(W, dim, dtype=torch.float64, device=dev),
                   torch.eye(dim, dtype=self.vdtype,
                             device=dev).expand(W, dim, dim))

    def _sweep(self, state: SDWState, up: bool, measure: bool, draws=None,
               generator=None):
        """One full pass over all time slices (up: l = 1..m, down:
        l = m..1), consuming the opposite-direction UdV stack and emitting
        this direction's. ``draws``: this sweep's (u01, rnd) as
        ``_draw_proposal_randoms`` returns them; None draws from
        ``generator``."""
        cfg = self.cfg
        K, s_int = cfg.n_stack, cfg.s
        phi, G, phase = state.phi, state.G, state.phase
        W = phi.shape[0]
        if draws is None:
            if generator is None:
                raise ValueError("_sweep needs draws or a torch.Generator")
            draws = self._draw_proposal_randoms(W, generator)
        u01, rnd = draws
        alt = state.sweeps_done % 2
        eye_f = self._eye_mixed(W)
        lazy_U, d_c, V_c = eye_f
        rdt = self.rdtype
        dev = torch.zeros(W, dtype=rdt, device=self.device)
        acc_sum = torch.zeros(W, dtype=rdt, device=self.device)
        obs_sum = None
        emitted = []
        for k in (range(1, K + 1) if up else range(K, 0, -1)):
            ci = k if up else k - 1
            other = UDV(state.stack_U[:, ci], state.stack_d[:, ci],
                        state.stack_V[:, ci])
            for l_rel in range(s_int):
                l = (k - 1) * s_int + 1 + l_rel if up else k * s_int - l_rel
                if up:
                    G = self.wrap_up(G, self.exp_v_blocks(phi[:, l - 1]),
                                     self.exp_v_blocks(phi[:, l - 1], +1.0))
                G, phi, acc = self.update_slice(
                    G, phi, l, u01[:, l - 1], tuple(x[:, l - 1] for x in rnd),
                    state.box_width, state.r, alt)
                blocks_new = self.exp_v_blocks(phi[:, l - 1])
                if up:
                    lazy_U = self.b_mult_left(blocks_new, lazy_U)
                else:
                    lazy_U = self.bT_mult_left(blocks_new, lazy_U)
                    G = self.wrap_down(G, blocks_new, self.exp_v_blocks(
                        phi[:, l - 1], +1.0))
                acc_sum = acc_sum + acc
            # re-orthogonalize: run-dtype QR (K2c) of the lazy block, f64 d,
            # complex128 V; stabilized G through K3c
            f_new = udv_refactor(lazy_U, d_c, V_c)
            G_stab = (green_from_two_udv(f_new, other) if up
                      else green_from_two_udv(other, f_new))
            dev = torch.maximum(dev, (G - G_stab).abs().amax((-2, -1)))
            G = G_stab
            if measure:
                obs = self.measure(G, phi, phase, torch.zeros_like(acc_sum))
                obs_sum = obs if obs_sum is None else SDWObservables(
                    *[a + b for a, b in zip(obs_sum, obs)])
            lazy_U, d_c, V_c = f_new
            emitted.append(f_new)

        if not up:
            emitted = emitted[::-1]

        def assemble(leaves, eye_leaf):
            parts = [eye_leaf] + leaves if up else leaves + [eye_leaf]
            return torch.stack(parts, dim=1)

        logd = torch.log10(torch.clamp(
            torch.stack([f.d for f in emitted], dim=1), min=1e-38))
        new_state = state._replace(
            phi=phi, G=G,
            stack_U=assemble([f.U for f in emitted], eye_f.U),
            stack_d=assemble([f.d for f in emitted], eye_f.d),
            stack_V=assemble([f.V for f in emitted], eye_f.V),
            next_dir=torch.full_like(state.next_dir, 1 if up else 0),
            sweeps_done=state.sweeps_done + 1,
            green_dev=dev.float(),
            sv_min=logd.amin((1, 2)).float(),
            sv_max=logd.amax((1, 2)).float())
        if obs_sum is None:
            zero = self.measure(G, phi, phase, acc_sum)
            obs_sum = SDWObservables(*[torch.zeros_like(a) for a in zero])
        obs_mean = SDWObservables(*[a / K for a in obs_sum])
        obs_mean = obs_mean._replace(
            acceptance=acc_sum / cfg.m,
            # one configuration (the sweep's final field), not an average
            exchangeAction=0.5 * cfg.dtau * torch.sum(phi ** 2,
                                                      dim=(1, 2, 3)))
        return new_state, obs_mean

    def sweep_up(self, state, measure=False, draws=None, generator=None):
        return self._sweep(state, True, measure, draws, generator)

    def sweep_down(self, state, measure=False, draws=None, generator=None):
        return self._sweep(state, False, measure, draws, generator)

    def sweep_pair(self, state: SDWState, measure: bool, draws=None,
                   generator=None):
        """Up + down; measurements averaged, exchangeAction from the
        pair's final field. ``draws``: None or the (up, down) pair of
        per-sweep draws."""
        d_up, d_dn = (None, None) if draws is None else draws
        state, o1 = self._sweep(state, True, measure, d_up, generator)
        state, o2 = self._sweep(state, False, measure, d_dn, generator)
        obs = SDWObservables(*[0.5 * (a + b) for a, b in zip(o1, o2)])
        return state, obs._replace(exchangeAction=o2.exchangeAction)

    # ---- setup -----------------------------------------------------------------------
    def _build_stack(self, phi, transposed: bool) -> UDV:
        """A UdV stack from the field, (W, K+1, ...): straight (left)
        entries k hold B_{ks} .. B_1 (identity at 0); transposed (right)
        entries k hold (B_m .. B_{ks+1})^H (identity at K, the whole chain
        at 0)."""
        cfg = self.cfg
        K, s_int = cfg.n_stack, cfg.s
        eye_f = self._eye_mixed(phi.shape[0])
        f = eye_f
        emitted = []
        for k in (range(K, 0, -1) if transposed else range(1, K + 1)):
            lazy_U = f.U
            for l_rel in range(s_int):
                l = (k * s_int - l_rel if transposed
                     else (k - 1) * s_int + 1 + l_rel)
                blocks = self.exp_v_blocks(phi[:, l - 1])
                lazy_U = (self.bT_mult_left(blocks, lazy_U) if transposed
                          else self.b_mult_left(blocks, lazy_U))
            f = udv_refactor(lazy_U, f.d, f.V)
            emitted.append(f)
        parts = emitted[::-1] + [eye_f] if transposed else [eye_f] + emitted
        return UDV(*[torch.stack([getattr(p, leaf) for p in parts], dim=1)
                     for leaf in ("U", "d", "V")])

    def refresh_from_field(self, state: SDWState) -> SDWState:
        """Recompute the right stack and G(0) from the field alone."""
        return self.refresh_from_stack(
            state, self._build_stack(state.phi, transposed=True))

    def refresh_from_stack(self, state: SDWState, stack: UDV) -> SDWState:
        """refresh_from_field's second half: G(0) from the right stack
        ``stack`` of ``state.phi`` (entry 0 is the whole chain)."""
        full_t = UDV(stack.U[:, 0], stack.d[:, 0], stack.V[:, 0])
        G = green_from_two_udv(self._eye_mixed(state.phi.shape[0]), full_t)
        return state._replace(G=G, stack_U=stack.U, stack_d=stack.d,
                              stack_V=stack.V,
                              next_dir=torch.zeros_like(state.next_dir))

    def init_state(self, n_walkers: int,
                   generator: torch.Generator) -> SDWState:
        """Gaussian field (0.5 N(0, 1) per component); stack and G(0) built
        from scratch."""
        cfg = self.cfg
        W, dim, K, dev = n_walkers, self.dim, cfg.n_stack, self.device
        rdt, i32, f32 = self.rdtype, torch.int32, torch.float32
        phi = 0.5 * torch.randn((W, cfg.m, cfg.n_sites, cfg.opdim),
                                generator=generator, dtype=rdt, device=dev)
        zeros_w = torch.zeros(W, dtype=f32, device=dev)
        state0 = SDWState(
            phi=phi,
            G=torch.zeros(W, dim, dim, dtype=self.cdtype, device=dev),
            stack_U=torch.zeros(W, K + 1, dim, dim, dtype=self.cdtype,
                                device=dev),
            stack_d=torch.zeros(W, K + 1, dim, dtype=torch.float64,
                                device=dev),
            stack_V=torch.zeros(W, K + 1, dim, dim, dtype=self.vdtype,
                                device=dev),
            phase=torch.ones(W, dtype=self.cdtype, device=dev),
            box_width=torch.full((W,), cfg.box_width, dtype=rdt, device=dev),
            r=torch.full((W,), cfg.r, dtype=rdt, device=dev),
            next_dir=torch.zeros(W, dtype=i32, device=dev),
            sweeps_done=torch.zeros(W, dtype=i32, device=dev),
            green_dev=zeros_w, sv_min=zeros_w, sv_max=zeros_w)
        return self.refresh_from_field(state0)

    # ---- unequal-time measurements ----------------------------------------------------
    def _td_stacks(self, phi):
        """Both half-chain stacks from the field: (left, right_t)."""
        return (self._build_stack(phi, transposed=False),
                self._build_stack(phi, transposed=True))

    def time_displaced_greens(self, phi) -> torch.Tensor:
        """Stable G(tau = k s dtau, 0) for k = 0..K: (W, K+1, dim, dim),
        both half-chain stacks built fresh, one batched stable solve."""
        return green_tau_zero(*self._td_stacks(phi))

    def time_displaced_greens_rev(self, phi) -> torch.Tensor:
        """Stable G(0, tau = k s dtau) at the anchors: with A = B(tau, 0)
        and C = B(beta, tau), G(0, tau) = -(1 + C A)^{-1} C =
        -[gtz(right_t, left)]^H, the swapped-stack solve."""
        left, right_t = self._td_stacks(phi)
        return -green_tau_zero(right_t, left).mH

    def _per_slice(self, anchors, phi, step):
        """Wrap anchors (W, K+1, dim, dim) to every slice with
        ``step(G (W, K, dim, dim), phi (W, K, N, opdim))`` applied with
        slice k s + j + 1's blocks (``phi`` -> blocks is the caller's)."""
        cfg = self.cfg
        W = phi.shape[0]
        blk = phi.reshape(W, cfg.n_stack, cfg.s, *phi.shape[2:])
        (G_all,), dev = wrap_between_anchors(
            [anchors], cfg.s, lambda j, ch: [step(ch[0], blk[:, :, j])])
        return G_all, dev

    def time_displaced_greens_all(self, phi):
        """G(tau, 0) at every slice tau = 0..m: (W, m+1, dim, dim), and the
        wrap deviation (W,) against the stabilized anchors; G(ks+j+1, 0)
        = B_{ks+j+1} G(ks+j, 0), all walkers and intervals in one apply
        (K6 at dim >= 128 on the card)."""
        def step(G, phi_j):
            flat = G.flatten(0, 1)
            return self.b_mult_left(self.exp_v_blocks(phi_j.flatten(0, 1)),
                                    flat).view_as(G)

        return self._per_slice(self.time_displaced_greens(phi), phi, step)

    def time_displaced_greens_rev_all(self, phi):
        """G(0, tau) at every slice, and the wrap deviation (W,):
        G(0, tau+1) = G(0, tau) B_{tau+1}^{-1} between anchors."""
        def step(G, phi_j):
            return self.b_inv_mult_right(G, self.exp_v_blocks(phi_j, +1.0))

        return self._per_slice(self.time_displaced_greens_rev(phi), phi,
                               step)

    def pair_susceptibilities(self, G_tau):
        """tau-integrated onsite s-wave and d_{x2-y2}-wave pairing
        susceptibilities (W,) each from per-slice G(tau, 0) (W, m+1, dim,
        dim), for the equal-time pairingCorrelation's pair operator
        Delta_i = sum_b c_{b dn, i} c_{b up, i}. Wick at fixed phi:

            <Delta_i(tau) Delta_j+(0)> = Re[ G00 G11 + G22 G33
                                            - G03 G12 - G21 G30 ]_ij

        in the physical orbital basis (x_up, x_dn, y_up, y_dn). The d-wave
        form factor dresses the dn operators: D from the left where a
        factor annihilates a dn orbital, D^T from the right where it
        creates one. Trapezoid over all m+1 slices."""
        cfg = self.cfg
        W, T = G_tau.shape[:2]
        re, im = self._phys_green_parts(G_tau)         # (W T, 4, 4, N, N)
        D = self._dwave_D
        # ((ann1, cre1), (ann2, cre2), sign): dn orbitals are odd
        terms = (((0, 0), (1, 1), 1.0), ((2, 2), (3, 3), 1.0),
                 ((0, 3), (1, 2), -1.0), ((2, 1), (3, 0), -1.0))

        def dress(x, ann, cre):
            if ann % 2 == 1:
                x = mm(D, x)
            if cre % 2 == 1:
                x = mm(x, D.T)
            return x

        ps = pd = 0.0
        for (a1, c1), (a2, c2), sgn in terms:
            r1, i1, r2, i2 = (re[:, a1, c1], im[:, a1, c1],
                              re[:, a2, c2], im[:, a2, c2])
            ps = ps + sgn * (r1 * r2 - i1 * i2).sum((-2, -1))
            pd = pd + sgn * (dress(r1, a1, c1) * dress(r2, a2, c2)
                             - dress(i1, a1, c1) * dress(i2, a2, c2)
                             ).sum((-2, -1))
        w = trapezoid_weights(cfg.m, cfg.dtau, re.dtype, re.device)
        return (ps.reshape(W, T) @ w / cfg.n_sites,
                pd.reshape(W, T) @ w / cfg.n_sites)

    def measure_time_displaced(self, state: SDWState,
                               per_slice: bool = False,
                               susceptibilities: bool = False):
        """Momentum-diagonal G(k, tau) averaged over the 4 physical
        orbitals: (W, K+1, N) on the stabilization grid, or (W, m+1, N) at
        every slice with ``per_slice`` (returned with the wrap deviation
        (W,)). ``susceptibilities`` (needs ``per_slice``) also returns the
        tau-integrated pairing susceptibilities (W,) each."""
        if susceptibilities and not per_slice:
            raise ValueError("susceptibilities need per_slice=True "
                             "(trapezoid over every tau slice)")
        if per_slice:
            G_tau, dev = self.time_displaced_greens_all(state.phi)
        else:
            G_tau = self.time_displaced_greens(state.phi)
        W, T = G_tau.shape[:2]
        Fc, Fs = self.four_cos, self.four_sin
        re, im = self._phys_green_parts(G_tau)         # (W T, 4, 4, N, N)
        gr = torch.diagonal(re, dim1=1, dim2=2).sum(-1)   # sum over o of
        gi = torch.diagonal(im, dim1=1, dim2=2).sum(-1)   # G[o, o]
        # Re (F G F^H)_kk with F = exp(-i k r): the cos / sin split
        gk = (torch.einsum("ki,bij,kj->bk", Fc, gr, Fc)
              + torch.einsum("ki,bij,kj->bk", Fs, gr, Fs)
              + torch.einsum("ki,bij,kj->bk", Fs, gi, Fc)
              - torch.einsum("ki,bij,kj->bk", Fc, gi, Fs))
        gk = gk.reshape(W, T, -1) / (4.0 * self.cfg.n_sites)
        if susceptibilities:
            return (gk, dev) + self.pair_susceptibilities(G_tau)
        return (gk, dev) if per_slice else gk

    # ---- global moves ------------------------------------------------------
    @property
    def has_global_moves(self) -> bool:
        cfg = self.cfg
        return (cfg.globalShift or cfg.wolffClusterUpdate
                or cfg.wolffClusterShiftUpdate)

    def global_moves(self, state: SDWState, generator=None, draws=None
                     ) -> SDWState:
        """The configured global moves in the JAX model's order (shift,
        Wolff, Wolff + shift); the driver fires this every
        globalUpdateInterval sweeps. ``draws``: None (draw from
        ``generator``) or a dict with the draws of each configured move
        under "shift", "wolff" and "wolff_shift" (see the attempt_*
        methods)."""
        cfg, draws = self.cfg, draws or {}
        if cfg.globalShift:
            state, _ = self.attempt_global_shift(
                state, generator, draws.get("shift"))
        if cfg.wolffClusterUpdate:
            state, _, _ = self.attempt_wolff_update(
                state, generator, draws.get("wolff"))
        if cfg.wolffClusterShiftUpdate:
            state, _, _ = self.attempt_wolff_shift_update(
                state, generator, draws.get("wolff_shift"))
        return state

    def _chain_logdet(self, phi) -> torch.Tensor:
        """The physical fermionic log-weight per walker (W,), float64:
        logdet_fac x log|det(1 + B_m ... B_1)| of the chain's matrix, the
        whole chain from the right stack's entry 0, through the
        inverse-free udv.clog_abs_det_one_plus_udv (its QR K2c, K2 or K7 on
        the card; also on the real opdim-1 chain, where the JAX model takes
        an LU: log_det_one_plus_udv). logdet_fac is 2 on the reduced chain
        (log|det M_A|^2) and 1 on the full one. The global moves accept on
        ld_new - ld_old of this, which is the JAX model's logdet_fac x its
        _chain_logdet (0.5 x 2 clog on the native route, 1 x log|det| on
        the complex one, 2 x log|det M_A| reduced)."""
        return self._logdet_and_stack(phi)[0]

    def _logdet_and_stack(self, phi):
        stack = self._build_stack(phi, transposed=True)
        return (self.logdet_fac * clog_abs_det_one_plus_udv(
            UDV(stack.U[:, 0], stack.d[:, 0], stack.V[:, 0])), stack)

    # ---- parallel tempering hooks -------------------------------------------
    # the parameter the label-swap exchange swaps: r enters S_B linearly and
    # the determinant not at all
    control_parameter = "r"

    def exchange_action(self, state: SDWState) -> torch.Tensor:
        """The r-conjugate action piece a = dS_B/dr = dtau/2 sum phi^2 per
        walker (W,)."""
        return 0.5 * self.cfg.dtau * torch.sum(state.phi ** 2, dim=(1, 2, 3))

    def with_r(self, state: SDWState, r) -> SDWState:
        """Set every walker's r ((W,) or a scalar); G and the stack stay
        valid."""
        return state._replace(r=torch.as_tensor(
            r, dtype=self.rdtype, device=self.device).expand_as(
                state.r).contiguous())

    def log_weight(self, phi, r=None) -> torch.Tensor:
        """The configuration's log-weight log w(phi) = ``_chain_logdet`` -
        S_B[phi] per walker (W,), float64 (S_B evaluated in float64), up to
        a phi-independent constant; ``r``: None (cfg.r) or (W,).
        Det-coupled parallel tempering swaps configurations on it."""
        return self.log_weight_and_stack(phi, r)[0]

    def log_weight_and_stack(self, phi, r=None):
        """(log_weight, the transposed stack its log-det was read from):
        the stack refresh_from_field builds for this field."""
        ld, stack = self._logdet_and_stack(phi)
        if r is not None:
            r = torch.as_tensor(r).to(device=phi.device, dtype=torch.float64)
        return ld - self.boson_action(phi.to(torch.float64), r), stack

    def _metropolis(self, state: SDWState, phi_new, d_action, u):
        """Accept phi_new per walker when log u < ld_new - ld_old - dS
        (``d_action`` None: dS = 0), then refresh every walker. The
        refresh reuses the right stacks the two log-dets were read from,
        selected per walker: the stack of the field each walker keeps is
        bitwise the one refresh_from_field would build. With
        turnoffFermions the accept is log u < -dS alone (``d_action`` None:
        always) and the refresh builds the kept field's stack (the JAX
        model's fermion-free branches, sdw.py:1868, 1952, 1996). Returns
        (state, accept (W,) bool)."""
        if self.cfg.turnoffFermions:
            accept = (torch.ones_like(u, dtype=torch.bool) if d_action is None
                      else torch.log(u) < -d_action)
            phi = torch.where(accept.view(-1, 1, 1, 1), phi_new, state.phi)
            return self.refresh_from_field(state._replace(phi=phi)), accept
        ld_old, st_old = self._logdet_and_stack(state.phi)
        ld_new, st_new = self._logdet_and_stack(phi_new)
        log_ratio = ld_new - ld_old
        if d_action is not None:
            log_ratio = log_ratio - d_action.to(log_ratio.dtype)
        accept = torch.log(u).to(log_ratio.dtype) < log_ratio

        def pick(new, old):
            return torch.where(accept.view(-1, *[1] * (new.ndim - 1)),
                               new, old)

        stack = UDV(*[pick(a, b) for a, b in zip(st_new, st_old)])
        state = state._replace(phi=pick(phi_new, state.phi))
        return self.refresh_from_stack(state, stack), accept

    def _normal(self, shape, generator):
        return torch.randn(shape, generator=generator, dtype=self.rdtype,
                           device=self.device)

    def _uniform(self, shape, generator):
        return torch.rand(shape, generator=generator, dtype=self.rdtype,
                          device=self.device)

    def _wolff_draws(self, W: int, generator):
        """(axis (W, opdim) normal, seed (W, 2) int64 (slice, site), None:
        the growth draws its bond uniforms from ``generator``)."""
        cfg = self.cfg
        axis = self._normal((W, cfg.opdim), generator)
        seed = torch.stack([
            torch.randint(n, (W,), generator=generator, device=self.device)
            for n in (cfg.m, cfg.n_sites)], dim=1)
        return axis, seed, None

    def attempt_global_shift(self, state: SDWState, generator=None,
                             draws=None):
        """phi -> phi + delta on every slice and site, delta = box_width x
        a normal (opdim,) per walker; Metropolis on the full stabilized
        determinant recompute and the boson action (the JAX model's
        attempt_global_shift). ``draws``: (normal (W, opdim), uniform (W,))
        or None to draw them from ``generator``. Returns (state, accept
        (W,))."""
        W = state.phi.shape[0]
        if draws is None:
            draws = (self._normal((W, self.cfg.opdim), generator),
                     self._uniform((W,), generator))
        normal, u = draws
        delta = normal * state.box_width[:, None]
        phi_new = state.phi + delta[:, None, None, :]
        d_action = (self.boson_action(phi_new, state.r)
                    - self.boson_action(state.phi, state.r))
        return self._metropolis(state, phi_new, d_action, u)

    def _grow_wolff_cluster(self, phi, e, seed, bonds=None, generator=None):
        """Wolff clusters on the (m, N) space-time lattice of each walker
        for the unit reflection axis e (W, opdim), grown from seed (W, 2)
        (the JAX model's _grow_wolff_cluster, batched): bonds activate with
        p = 1 - exp(min(0, -2 K s_i s_j)), s = phi . e, K = dtau on the
        four spatial bonds and 1/(c^2 dtau) on the two tau bonds. Each
        iteration takes every frontier bond at once with one (W, 6, m, N)
        uniform draw, ``bonds[t]`` or from ``generator``, and the loop runs
        while any walker's frontier is non-empty (a walker whose frontier
        is empty adds nothing). Plain PyTorch on the model's device: the
        JAX package grows it in a lax.while_loop, outside any kernel.
        Returns (in_cluster (W, m, N) bool, the reflected field
        phi - 2 (phi . e) e inside the cluster, iterations)."""
        cfg = self.cfg
        W, m, N = phi.shape[0], cfg.m, cfg.n_sites
        nb = self.nb_idx
        s = _dot_last(phi, e[:, None, None, :])

        def neighbours(x):
            return torch.stack([x[:, :, nb[:, d]] for d in range(4)]
                               + [torch.roll(x, 1, dims=1),
                                  torch.roll(x, -1, dims=1)], dim=1)

        k_bond = torch.tensor([cfg.dtau] * 4 + [1.0 / (cfg.c ** 2 * cfg.dtau)]
                              * 2, dtype=s.dtype, device=s.device)
        p = 1.0 - torch.exp(torch.clamp(
            -2.0 * k_bond[None, :, None, None] * s[:, None] * neighbours(s),
            max=0.0))
        in_c = torch.zeros((W, m, N), dtype=torch.bool, device=phi.device)
        in_c[torch.arange(W, device=phi.device), seed[:, 0], seed[:, 1]] = True
        frontier, t = in_c, 0
        while bool(frontier.any()):
            if bonds is None:
                u = self._uniform((W, 6, m, N), generator)
            elif t < bonds.shape[0]:
                u = bonds[t]
            else:
                raise ValueError(f"Wolff growth needs more than the "
                                 f"{bonds.shape[0]} injected iterations")
            frontier = (neighbours(frontier) & (u < p)).any(dim=1) & ~in_c
            in_c = in_c | frontier
            t += 1
        refl = phi - 2.0 * s[..., None] * e[:, None, None, :]
        return in_c, torch.where(in_c[..., None], refl, phi), t

    def attempt_wolff_update(self, state: SDWState, generator=None,
                             draws=None):
        """Embedded O(n) Wolff cluster reflection (the JAX model's
        attempt_wolff_update): the cluster construction balances the
        gradient and tau terms and the r/u terms are reflection-invariant,
        so only the fermion determinant enters the accept. ``draws``: (axis
        normal (W, opdim), seed (W, 2) int64 (slice, site), bond uniforms
        (T, W, 6, m, N) or None, accept uniform (W,)), or None to draw all
        from ``generator``. Returns (state, accept (W,), cluster sizes
        (W,))."""
        W = state.phi.shape[0]
        if draws is None:
            draws = (*self._wolff_draws(W, generator),
                     self._uniform((W,), generator))
        axis, seed, bonds, u = draws
        e = axis / torch.sqrt(_dot_last(axis, axis))[:, None]
        in_c, phi_new, _ = self._grow_wolff_cluster(state.phi, e, seed,
                                                    bonds, generator)
        state, accept = self._metropolis(state, phi_new, None, u)
        return state, accept, in_c.sum(dim=(1, 2))

    def attempt_wolff_shift_update(self, state: SDWState, generator=None,
                                   draws=None):
        """Cluster reflection plus a global shift perpendicular to the
        reflection axis (the JAX model's attempt_wolff_shift_update): s =
        phi . e is shift-invariant, so the cluster stays balanced, and
        reflection and shift commute; the accept carries the r/u potential
        difference and the fermion determinant ratio. ``draws``: (axis,
        seed, bonds, shift normal (W, opdim), accept uniform (W,)) as in
        attempt_wolff_update, or None. Returns (state, accept (W,), cluster
        sizes (W,))."""
        cfg = self.cfg
        W = state.phi.shape[0]
        if draws is None:
            draws = (*self._wolff_draws(W, generator),
                     self._normal((W, cfg.opdim), generator),
                     self._uniform((W,), generator))
        axis, seed, bonds, normal, u = draws
        e = axis / torch.sqrt(_dot_last(axis, axis))[:, None]
        g = normal * state.box_width[:, None]
        delta = g - _dot_last(g, e)[:, None] * e
        in_c, phi_refl, _ = self._grow_wolff_cluster(state.phi, e, seed,
                                                     bonds, generator)
        phi_new = phi_refl + delta[:, None, None, :]

        def s_pot(phi):
            phi2 = torch.sum(phi ** 2, dim=-1)
            return cfg.dtau * (0.5 * state.r * torch.sum(phi2, dim=(1, 2))
                               + 0.25 * cfg.u * torch.sum(phi2 ** 2,
                                                          dim=(1, 2)))

        state, accept = self._metropolis(state, phi_new,
                                         s_pot(phi_new) - s_pot(state.phi), u)
        return state, accept, in_c.sum(dim=(1, 2))

    # ---- not ported yet -------------------------------------------------------------
    def sweep_simple(self, *args, **kwargs):
        raise _unported("sweep_simple (the naive cross-check sweep)")

    def green_at_slice(self, *args, **kwargs):
        raise _unported("green_at_slice (the sweep_simple primitive)")
