"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``detqmc_tpu_torch/csrc/*.cu`` into ONE shared
library with a plain C interface (no PyTorch headers: seconds, not
minutes), under ``build/detqmc_tpu_torch/`` at the repository root: one
``nvcc -c`` per source, all started together, then one link. The file
name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. The build happens at the first
launch, never at import: this module imports nothing CUDA-specific, so
the CPU test suite imports every port module on a machine without nvcc.

Every C entry point takes the device index, raw device pointers, sizes
and the stream (``torch.cuda.current_stream(device).cuda_stream``),
launches one kernel on that device and returns ``cudaGetLastError()``;
``launch`` raises on a non-zero code. All pointers and the stream are
declared ``c_void_p`` in ``argtypes`` (ctypes otherwise passes a Python
int as a 32-bit C int and cuts the pointer).

``LAUNCHES`` counts kernel launches per kernel name. Only ``launch``
increments it, right after a launch that returned no error, so a count
proves that the kernel ran.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "detqmc_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dynamic shared memory a block may use on Hopper (227 KB); the kernels
# size theirs exactly and the wrappers refuse shapes beyond it
MAX_SMEM_BYTES = 232448
# at most this much, two CTAs share an SM: 2 x (smem + the 1 KB each CTA
# reserves) within the SM's 228 KB
TWO_CTA_SMEM_BYTES = 115712
# the H100 SXM's SM count, for plans computed without a device at hand
H100_SMS = 132

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C entry point -> argtypes (all return int = cudaError_t)
_SIGNATURES = {
    # device, G, field, u01, sign, G_out, field_out, sign_out, acc_out,
    # W, C, N, tr, tc, alpha, stream
    "dq_slice_update_f32": [_I] + [_P] * 8 + [_I] * 5 + [_D, _P],
    "dq_slice_update_f64": [_I] + [_P] * 8 + [_I] * 5 + [_D, _P],
    # the same, then the phase probe's record (W x 7 int64)
    "dq_slice_update_probe_f32": [_I] + [_P] * 8 + [_I] * 5 + [_D, _P, _P],
    "dq_slice_update_probe_f64": [_I] + [_P] * 8 + [_I] * 5 + [_D, _P, _P],
    # device, A, Q, R, batch, n, stream
    "dq_qr_f32": [_I, _P, _P, _P, _I, _I, _P],
    "dq_qr_f64": [_I, _P, _P, _P, _I, _I, _P],
    "dq_qr_c64": [_I, _P, _P, _P, _I, _I, _P],
    "dq_qr_c128": [_I, _P, _P, _P, _I, _I, _P],
    # the same, then the phase probe's record (batch x 8 int64)
    "dq_qr_probe_f32": [_I, _P, _P, _P, _I, _I, _P, _P],
    "dq_qr_probe_f64": [_I, _P, _P, _P, _I, _I, _P, _P],
    "dq_qr_probe_c64": [_I, _P, _P, _P, _I, _I, _P, _P],
    # CTAs per SM of the one-CTA QR (no launch): device, dtype code, n
    "dq_qr_blocks_per_sm": [_I, _I, _I],
    # device, inner, r1, mid, batch, n, stream
    "dq_solve_inner_f64": [_I, _P, _P, _P, _I, _I, _P],
    "dq_solve_inner_c128": [_I, _P, _P, _P, _I, _I, _P],
    # device, inner, rhs, out, batch, n, stream
    "dq_solve_inner_rhs_f64": [_I, _P, _P, _P, _I, _I, _P],
    "dq_solve_inner_rhs_c128": [_I, _P, _P, _P, _I, _I, _P],
    # the same, then the phase probe's record (batch x 8 int64)
    "dq_solve_inner_rhs_probe_f64": [_I, _P, _P, _P, _I, _I, _P, _P],
    "dq_solve_inner_rhs_probe_c128": [_I, _P, _P, _P, _I, _I, _P, _P],
    # CTAs per SM of the one-CTA solves (no launch): device, n, rhs (K3r,
    # K3c-rhs)
    "dq_solve_inner_c128_blocks_per_sm": [_I, _I, _I],
    "dq_solve_inner_f64_blocks_per_sm": [_I, _I, _I],
    # device, G, phi, phi_new, lhs, delta, nb, G_out, phi_out, acc_out,
    # W, N, opdim, dtau, c_det, stream
    **{f"dq_sdw_update_{t}": [_I] + [_P] * 9 + [_I, _I, _I, _D, _D, _P]
       for t in ("c64", "c128", "f32", "f64")},
    # the same, then the phase probe's record (W x 13 int64)
    **{f"dq_sdw_update_probe_{t}": [_I] + [_P] * 9
       + [_I, _I, _I, _D, _D, _P, _P] for t in ("c64", "f32", "q2_c64",
                                                 "q2_f32")},
    # device, G, G_out, phi, phi_new, lhs, delta, nb, phi_out, acc_out,
    # slots, W, N, opdim, K, resident, dtau, c_det, stream
    **{f"dq_sdw_delayed_{t}": [_I] + [_P] * 10 + [_I] * 5 + [_D, _D, _P]
       for t in ("c64", "c128", "f32", "f64")},
    # the same, then the phase probe's record (W x 8 int64)
    **{f"dq_sdw_delayed_probe_{t}": [_I] + [_P] * 10 + [_I] * 5
       + [_D, _D, _P, _P] for t in ("c64", "f32", "q2_c64", "q2_f32")},
    # device, G, tmp, G_out, E, Einv, D, Dinv, W, N, up, TL, og, nb, tpc,
    # stream
    "dq_sdw_wrap_c64": [_I] + [_P] * 7 + [_I] * 7 + [_P],
    "dq_sdw_wrap_c128": [_I] + [_P] * 7 + [_I] * 7 + [_P],
    # device, X, X_out, E, D, W, N, herm, TL, og, nb, tpc, stream
    "dq_sdw_apply_c64": [_I] + [_P] * 4 + [_I] * 7 + [_P],
    "dq_sdw_apply_c128": [_I] + [_P] * 4 + [_I] * 7 + [_P],
    # the same, then the phase probe's record (CTAs x 6 int64)
    **{f"dq_sdw_wrap_probe_{t}": [_I] + [_P] * 7 + [_I] * 7 + [_P, _P]
       for t in ("c64", "q2_c64", "q2_f32")},
    **{f"dq_sdw_apply_probe_{t}": [_I] + [_P] * 4 + [_I] * 7 + [_P, _P]
       for t in ("c64", "q2_c64", "q2_f32")},
    # device, G, field, u01, sign, G_out, field_out, sign_out, acc_out,
    # W, C, N, k, alpha, stream
    "dq_slice_update_delayed_f32": [_I] + [_P] * 8 + [_I] * 4 + [_D, _P],
    "dq_slice_update_delayed_f64": [_I] + [_P] * 8 + [_I] * 4 + [_D, _P],
    # the same, then the phase probe's record (W x 8 int64)
    "dq_slice_update_delayed_probe_f32": [_I] + [_P] * 8 + [_I] * 4
    + [_D, _P, _P],
    "dq_slice_update_delayed_probe_f64": [_I] + [_P] * 8 + [_I] * 4
    + [_D, _P, _P],
    # device, A, Q, R, batch, n, b, tc, nbuf, stream
    "dq_qr_big_f32": [_I, _P, _P, _P] + [_I] * 5 + [_P],
    "dq_qr_big_f64": [_I, _P, _P, _P] + [_I] * 5 + [_P],
    "dq_qr_big_c64": [_I, _P, _P, _P] + [_I] * 5 + [_P],
    "dq_qr_big_c128": [_I, _P, _P, _P] + [_I] * 5 + [_P],
    # the same, then the phase probe's record (batch x 8 int64)
    "dq_qr_big_probe_f64": [_I, _P, _P, _P] + [_I] * 5 + [_P, _P],
    "dq_qr_big_probe_c64": [_I, _P, _P, _P] + [_I] * 5 + [_P, _P],
    # device, inner, r1, mid, work, batch, n, b, tc, nbuf, stream
    "dq_solve_inner_big_f64": [_I] + [_P] * 4 + [_I] * 5 + [_P],
    "dq_solve_inner_big_c128": [_I] + [_P] * 4 + [_I] * 5 + [_P],
    # device, inner, rhs, out, work, batch, n, b, tc, nbuf, stream
    "dq_solve_inner_big_rhs_f64": [_I] + [_P] * 4 + [_I] * 5 + [_P],
    "dq_solve_inner_big_rhs_c128": [_I] + [_P] * 4 + [_I] * 5 + [_P],
    # device, R, X, batch, n, b, tc, nbuf, stream
    "dq_trinv_big_f32": [_I, _P, _P] + [_I] * 5 + [_P],
    "dq_trinv_big_f64": [_I, _P, _P] + [_I] * 5 + [_P],
    "dq_trinv_big_c64": [_I, _P, _P] + [_I] * 5 + [_P],
    "dq_trinv_big_c128": [_I, _P, _P] + [_I] * 5 + [_P],
    # device, A, B, C, D, stream (one FP64 tensor-core product)
    "dq_mma884_check": [_I] + [_P] * 5,
    # CTAs per SM (no launch): device, complex, rhs, n, b, tc, nbuf
    "dq_solve_inner_big_blocks_per_sm": [_I] * 7,
    # device, dtype code, n, b, tc, nbuf
    "dq_trinv_big_blocks_per_sm": [_I] * 6,
    "dq_qr_big_blocks_per_sm": [_I] * 6,
    # device, complex128, N, TL, og, nb
    "dq_sdw_wrap_blocks_per_sm": [_I] * 6,
    # device, dtype code (0 float32, 1 float64, 2 complex64, 3 complex128),
    # q, N, opdim, K, resident
    "dq_sdw_delayed_blocks_per_sm": [_I] * 7,
    # device, dtype code, q, N, opdim
    "dq_sdw_update_blocks_per_sm": [_I] * 5,
    # the reduced sector's q = 2 instances of K4, K5 and K6 (signatures as
    # their q = 4 ones) and K6's CTAs per SM (its complex128 flag replaced
    # by the dtype code)
    **{f"dq_sdw_update_q2_{t}": [_I] + [_P] * 9 + [_I, _I, _I, _D, _D, _P]
       for t in ("c64", "c128", "f32", "f64")},
    **{f"dq_sdw_delayed_q2_{t}": [_I] + [_P] * 10 + [_I] * 5 + [_D, _D, _P]
       for t in ("c64", "c128", "f32", "f64")},
    **{f"dq_sdw_wrap_q2_{t}": [_I] + [_P] * 7 + [_I] * 7 + [_P]
       for t in ("c64", "c128", "f32", "f64")},
    **{f"dq_sdw_apply_q2_{t}": [_I] + [_P] * 4 + [_I] * 7 + [_P]
       for t in ("c64", "c128", "f32", "f64")},
    "dq_sdw_wrap_q2_blocks_per_sm": [_I] * 6,
    # device, float64, C, N, tr, tc
    "dq_slice_update_blocks_per_sm": [_I] * 6,
}

LAUNCHES = {"slice_update": 0, "qr": 0, "solve_inner": 0, "sdw_update": 0,
            "qr_complex": 0, "solve_inner_complex": 0, "sdw_delayed": 0,
            "sdw_wrap": 0, "sdw_apply": 0, "qr_complex_big": 0,
            "solve_inner_complex_big": 0, "trinv_big": 0,
            "solve_inner_rhs": 0, "solve_inner_complex_rhs": 0,
            "solve_inner_complex_big_rhs": 0, "slice_update_delayed": 0,
            "qr_big": 0, "solve_inner_big": 0, "solve_inner_big_rhs": 0,
            "mma884": 0, "sdw_update_real": 0, "sdw_delayed_real": 0,
            # the q = 2 instances of K4, K5 and K6: complex, real
            **{f"{k}_q2{r}": 0 for k in ("sdw_update", "sdw_delayed",
                                         "sdw_wrap", "sdw_apply")
               for r in ("", "_real")}}

_lib = None
build_log = ""          # nvcc's output (-Xptxas -v: registers, smem)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libdetqmc_kernels_{h.hexdigest()[:16]}.so"


def load():
    """Build (if needed) and load the kernel library; returns the ctypes
    handle. Raises on any build or load failure."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            nvcc = _nvcc()
            objs, procs = [], []
            for src in sorted(SRC_DIR.glob("*.cu")):
                obj = str(Path(tmpdir) / (src.stem + ".o"))
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", "-o",
                       obj, str(src)]
                objs.append(obj)
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                    str(Path(tmpdir) / "lib.so"), *objs]
            logs, failed = [], []
            for cmd, proc in procs:
                logs.append(proc.communicate()[0])
                if proc.returncode != 0:
                    failed.append(" ".join(cmd))
            if not failed:
                proc = subprocess.run(link, capture_output=True, text=True)
                logs.append(proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    failed.append(" ".join(link))
            build_log = "".join(logs)
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed)
                                   + "\n" + build_log)
            # atomic: concurrent builders see whole files
            os.replace(Path(tmpdir) / "lib.so", out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry ``entry`` on the device of the tensor arguments (passed
    as their data pointers) and its current stream; raise on a launch
    error; count it."""
    import torch

    lib = load()
    devs = {a.get_device() for a in args if isinstance(a, torch.Tensor)}
    if len(devs) != 1 or min(devs) < 0:
        raise ValueError(f"{entry}: tensors on several devices or off the "
                         f"card {devs}")
    dev = devs.pop()
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    err = getattr(lib, entry)(dev, *cargs, _raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[kernel] += 1


def _raw_stream(index: int) -> int:
    """The current stream of CUDA device ``index`` as a pointer: torch's
    raw getter where it has one (a Stream object costs microseconds a
    launch), else the Stream's own."""
    import torch

    getter = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if getter is not None:
        return getter(index)
    return torch.cuda.current_stream(index).cuda_stream


def row_pad(dtype) -> int:
    """Row padding, in elements, of the tensor-core kernels' shared-memory
    operands (tc_blocked.cuh pad_of): 2 for complex128, else 4."""
    return 2 if dtype.itemsize == 16 else 4


def query(entry: str, device, *ints) -> int:
    """Call the C query ``entry`` (no launch) on ``device`` with int
    arguments; raise on a negative (error) result."""
    import torch

    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    res = getattr(load(), entry)(index, *ints)
    if res < 0:
        raise RuntimeError(f"{entry}{ints}: cudaError {-res}")
    return res


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The number of SMs of a CUDA device (asked once a device)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def accept_rate(acc_n, N: int):
    """accepted / N rounded once, as the kernels and JAX's mean divide (a
    CUDA tensor divided by a Python number is multiplied by its rounded
    reciprocal instead)."""
    return acc_n / acc_n.new_full(acc_n.shape, N)


def check_cuda_tensor(name: str, t, dtypes, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    with ``ndim`` dimensions."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
