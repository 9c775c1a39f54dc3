"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``detqmc_tpu_torch/csrc/*.cu`` into ONE shared
library with a plain C interface (no PyTorch headers: seconds, not
minutes), under ``build/detqmc_tpu_torch/`` at the repository root. The
file name carries a hash of the sources and flags, so an edited source
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dynamic shared memory a block may use on Hopper (227 KB); the kernels
# size theirs exactly and the wrappers refuse shapes beyond it
MAX_SMEM_BYTES = 232448

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C entry point -> argtypes (all return int = cudaError_t)
_SIGNATURES = {
    # device, G, field, u01, sign, G_out, field_out, sign_out, acc_out,
    # W, C, N, alpha, stream
    "dq_slice_update_f32": [_I] + [_P] * 8 + [_I, _I, _I, _D, _P],
    "dq_slice_update_f64": [_I] + [_P] * 8 + [_I, _I, _I, _D, _P],
    # device, A, Q, R, batch, n, stream
    "dq_qr_f32": [_I, _P, _P, _P, _I, _I, _P],
    "dq_qr_f64": [_I, _P, _P, _P, _I, _I, _P],
    # device, inner, r1, mid, batch, n, stream
    "dq_solve_inner_f64": [_I, _P, _P, _P, _I, _I, _P],
}

LAUNCHES = {"slice_update": 0, "qr": 0, "solve_inner": 0}

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
        cu = [str(p) for p in sorted(SRC_DIR.glob("*.cu"))]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", tmp, *cu]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{build_log}")
        os.replace(tmp, out)   # atomic: concurrent builders see whole files
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
    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"{entry}: tensors on several devices {devs}")
    dev = devs.pop()
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, entry)(dev.index, *cargs, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[kernel] += 1


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
