"""Build the hand-written CUDA kernels (``csrc/*.cu``) on first use.

``nvcc`` compiles every source in ``csrc/`` into one shared library with a
plain C interface for Hopper (``sm_90a``), and ``ctypes`` loads it.  No
PyTorch header is included, so the build takes seconds.  The library goes
into ``build/mas_tpu_torch/`` at the root of the checkout, named by a hash
of the sources and flags: a changed source builds a new library, an
unchanged one is loaded as it is.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "mas_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "mas_tpu_torch are built from source and need the CUDA toolkit")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources if no library for their hash exists; returns
    the library path.  ``verbose`` adds ``-Xptxas -v`` (registers, shared
    memory and spills per kernel) to a fresh build and prints its log."""
    srcs = _sources()
    lib = BUILD_DIR / f"libmas_kernels_{_digest(srcs)}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mas_flash_fwd.argtypes = [p, p, p, p, p,          # q k v out lse
                                  ctypes.POINTER(ctypes.c_longlong),
                                  i, i, i, i, i, p]
    lib.mas_flash_fwd.restype = i
    # q kq ks vq vs index out, B H T q_sb q_sh bits is_bf16, stream
    lib.mas_decode_quant.argtypes = [p, p, p, p, p, p, p,
                                     i, i, i, i, i, i, i, p]
    lib.mas_decode_quant.restype = i
    lib.mas_cuda_error_string.argtypes = [i]
    lib.mas_cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _LIB = lib
    return _LIB


def check(status: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if status != 0:
        msg = library().mas_cuda_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {status} ({msg})")
