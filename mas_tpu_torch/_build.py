"""Build the hand-written CUDA kernels (``csrc/*.cu``) on first use.

``nvcc`` compiles every source in ``csrc/`` for Hopper (``sm_90a``), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which ``ctypes`` loads.  No
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

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "mas_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

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


def _run(cmds, verbose: bool) -> None:
    """Run the commands in parallel; raise with the log of the first that
    fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in procs]
    for cmd, log, code in logs:
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n"
                               f"{log}")
        if verbose:
            print(log)


def build(verbose: bool = False) -> Path:
    """Compile the sources if no library for their hash exists; returns
    the library path.  ``verbose`` adds ``-Xptxas -v`` (registers, shared
    memory and spills per kernel) to a fresh build and prints its log."""
    srcs = _sources()
    digest = _digest(srcs)
    lib = BUILD_DIR / f"libmas_kernels_{digest}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in srcs]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    try:
        _run([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(srcs, objs)], verbose)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]], verbose)
        os.replace(tmp, lib)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    # q k v out lse, strides, B H T prefix head_dim, scale, is_bf16, stream
    lib.mas_flash_fwd.argtypes = [p, p, p, p, p,
                                  ctypes.POINTER(ctypes.c_longlong),
                                  i, i, i, i, i, f, i, p]
    lib.mas_flash_fwd.restype = i
    # q k v out dout lse delta dqkv, strides, B H T prefix head_dim, scale,
    # is_bf16, stream
    lib.mas_flash_bwd.argtypes = [p, p, p, p, p, p, p, p,
                                  ctypes.POINTER(ctypes.c_longlong),
                                  i, i, i, i, i, f, i, p]
    lib.mas_flash_bwd.restype = i
    # q kq ks vq vs index out, B KV group T pos_stride q_sb q_sh width d
    # bits scale_bf16 is_bf16 split, scale, stream
    lib.mas_decode_quant.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                     i, i, i, i, i, i, i, f, p]
    lib.mas_decode_quant.restype = i
    # q k v index out, B KV group T q_sb q_sh width d cache_bf16 is_bf16
    # split, scale, stream
    lib.mas_decode_float.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                     i, i, i, f, p]
    lib.mas_decode_float.restype = i
    # k_new v_new kq ks vq vs index, B H, k strides, v strides, T d width
    # bits scale_bf16 packed is_bf16, stream
    lib.mas_kv_write.argtypes = [p, p, p, p, p, p, p, i, i, ll, ll, ll, ll,
                                 i, i, i, i, i, i, i, p]
    lib.mas_kv_write.restype = i
    # device -> its SM count, after the one-time set-up there
    lib.mas_vq_argmin_prepare.argtypes = [i]
    lib.mas_vq_argmin_prepare.restype = i
    # N K D is_bf16 sms -> scratch floats
    lib.mas_vq_argmin_scratch.argtypes = [i, i, i, i, i]
    lib.mas_vq_argmin_scratch.restype = ll
    # z codebook scratch out, N K D is_bf16 sms, stream
    lib.mas_vq_argmin.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.mas_vq_argmin.restype = i
    # x w b y, n d eps is_bf16, stream
    lib.mas_layer_norm_fwd.argtypes = [p, p, p, p, i, i, f, i, p]
    lib.mas_layer_norm_fwd.restype = i
    # n d -> fp32 partials the backward takes
    lib.mas_layer_norm_bwd_scratch.argtypes = [i, i]
    lib.mas_layer_norm_bwd_scratch.restype = ll
    lib.mas_layer_norm_bwd_tickets.argtypes = []
    lib.mas_layer_norm_bwd_tickets.restype = i
    # x g w dx part tickets dscale dbias, n d eps is_bf16, stream
    lib.mas_layer_norm_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, f, i, p]
    lib.mas_layer_norm_bwd.restype = i
    # device is_bf16 -> resident blocks
    lib.mas_gn_swish_fwd_grid.argtypes = [i, i]
    lib.mas_gn_swish_fwd_grid.restype = i
    # batch rows channels groups resident is_bf16 -> scratch floats
    lib.mas_gn_swish_fwd_scratch.argtypes = [i, i, i, i, i, i]
    lib.mas_gn_swish_fwd_scratch.restype = ll
    # x w b y stats scratch, batch rows channels groups, eps, resident
    # is_bf16, stream
    lib.mas_gn_swish_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, f, i, i, p]
    lib.mas_gn_swish_fwd.restype = i
    # device is_bf16 -> blocks of a launch
    lib.mas_gn_swish_bwd_grid.argtypes = [i, i]
    lib.mas_gn_swish_bwd_grid.restype = i
    # batch rows channels groups grid -> scratch floats
    lib.mas_gn_swish_bwd_scratch.argtypes = [i, i, i, i, i]
    lib.mas_gn_swish_bwd_scratch.restype = ll
    # x g w b stats dx scratch dscale dbias, batch rows channels groups
    # inv_count grid is_bf16, stream
    lib.mas_gn_swish_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, f,
                                     i, i, p]
    lib.mas_gn_swish_bwd.restype = i
    # a w0 w1 out weight order offsets routed, pairs n k topk experts up,
    # stream
    lib.mas_moe_swiglu.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.mas_moe_swiglu.restype = i
    # pointers [4, total] (p, g, mu, nu), total first count, numels
    # tile_starts, 1 - b1 b1 1 - b2 b2 bc1 bc2 eps -lr, device, stream
    lib.mas_adam_update.argtypes = [p, i, i, i, ctypes.POINTER(ll),
                                    ctypes.POINTER(i)] + [f] * 8 + [i, p]
    lib.mas_adam_update.restype = i
    # state xbc dt a d y, rows heads head_dim state_dim, stream
    lib.mas_ssm_update.argtypes = [p] * 6 + [i] * 4 + [p]
    lib.mas_ssm_update.restype = i
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


def stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on CUDA device
    ``device_index`` (the capturing stream inside ``torch.cuda.graph``):
    what ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    making a Stream object, which costs several microseconds of host time
    on every decode-step launch."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check(status: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if status != 0:
        msg = library().mas_cuda_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {status} ({msg})")
