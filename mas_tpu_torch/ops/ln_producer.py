"""Residual add with the LayerNorm row statistics in one pass (kernel B11),
and ``AddLNProducerFunction``, the producer-fused ``(a + b, LN(a + b))``.

B11 replaces ``benchmarks/ln_producer.py::_add_stats_kernel`` (launched
by ``add_stats_pallas``), the JAX package's experiment in computing a
LayerNorm's statistics in the epilogue of the op that produces its input,
so that the statistics never re-read the residual stream.  Same
semantics: ``x = a + b`` summed in fp32 and rounded to a's dtype once;
the row mean and ``rsqrt(var + eps)`` (biased variance) taken from the
ROUNDED x, the numbers a LayerNorm of x would see; returns (x, stats
[rows, 2] fp32: mean, rstd).  ``normalize_with`` finishes the LayerNorm
from the stats, in torch, as the harness does.

What bounds it on the H100: bytes.  At the harness shape [16 * 1408, 1024]
bf16 it reads a and b (92 MB) and writes x (46 MB) with ~8 flops per
element.

What the design does about it, in Triton: one program per row (d <= 8192
fits in registers): one read of a and b, one write of x, the two-pass
mean and variance over registers, one 8-byte stats store.  Any row count
is taken: the TPU kernel's ``rows % 512 == 0`` is its tile size.

The JAX package has no backward kernel: ``AddLNProducerFunction``'s
backward recomputes the plain ``add_ln`` under autograd, as the harness's
``_producer_bwd`` does.
"""

from __future__ import annotations

import torch

tl = None  # triton.language, bound on first launch
EPS = 1e-5
_JIT = {}


def _add_stats_kernel(a_ptr, b_ptr, x_ptr, st_ptr, d, eps,
                      BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    m = cols < d
    offs = row * d + cols
    a = tl.load(a_ptr + offs, mask=m, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + offs, mask=m, other=0.0).to(tl.float32)
    xb = (a + b).to(x_ptr.dtype.element_ty)
    tl.store(x_ptr + offs, xb, mask=m)
    xf = xb.to(tl.float32)                  # stats of the rounded x
    mean = tl.sum(xf, axis=0) / d
    xc = tl.where(m, xf - mean, 0.0)
    rstd = 1.0 / tl.sqrt_rn(tl.sum(xc * xc, axis=0) / d + eps)
    tl.store(st_ptr + row * 2, mean)
    tl.store(st_ptr + row * 2 + 1, rstd)


def _kernels():
    """Import triton and JIT-wrap the kernel on first launch (the CPU tests
    import this module where triton does not exist)."""
    global tl
    if not _JIT:
        import triton
        import triton.language as language

        tl = language
        _JIT["add_stats"] = triton.jit(_add_stats_kernel)
    return _JIT


def add_stats_plain(a: torch.Tensor, b: torch.Tensor, eps: float = EPS):
    """Plain twin of B11: (x = a + b in a's dtype, stats [rows, 2] fp32)."""
    x = (a.float() + b.float()).to(a.dtype)
    xf = x.float()
    mean = xf.mean(dim=-1)
    var = (xf - mean[:, None]).square().mean(dim=-1)
    return x, torch.stack([mean, torch.rsqrt(var + eps)], dim=-1)


def _check(a, b):
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"a and b must be [rows, d] of one shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype not in (torch.bfloat16, torch.float32) or b.dtype != a.dtype:
        raise TypeError(f"a and b must be bf16 or fp32 of one dtype, got "
                        f"{a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if a.shape[1] > 8192:
        raise ValueError(f"add_stats kernel takes d <= 8192, got "
                         f"{a.shape[1]}")


def add_stats(a: torch.Tensor, b: torch.Tensor, eps: float = EPS):
    """(x = a + b, stats [rows, 2] fp32 = row mean and rstd of x) for
    contiguous a, b [rows, d].  Kernel B11 for CUDA tensors, plain twin
    for CPU tensors."""
    if a.device.type == "cpu":
        return add_stats_plain(a, b, eps)
    if a.device.type != "cuda":
        raise ValueError(f"add_stats runs on cpu or cuda, got {a.device}")
    _check(a, b)
    jit = _kernels()
    n, d = a.shape
    x = torch.empty_like(a)
    stats = torch.empty((n, 2), dtype=torch.float32, device=a.device)
    block = 1 << (d - 1).bit_length()
    with torch.cuda.device(a.device):
        jit["add_stats"][(n,)](a, b, x, stats, d, float(eps), BLOCK=block,
                               num_warps=4 if block <= 1024 else 8)
    add_stats.launches += 1
    return x, stats


add_stats.launches = 0


def normalize_with(x: torch.Tensor, stats: torch.Tensor, g: torch.Tensor,
                   beta: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm of x from its stats: (x - mean) * rstd * g + beta in fp32,
    rounded to ``dtype``."""
    out = ((x.float() - stats[:, 0:1]) * stats[:, 1:2] * g.float()
           + beta.float())
    return out.to(dtype)


def add_ln_plain(a, b, g, beta, eps: float = EPS):
    """The unfused ``(a + b, LN(a + b))`` of the harness (``_jnp_add_ln``):
    torch ops, differentiable."""
    x = a + b
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * g.float() + beta.float()
    return x, out.to(a.dtype)


class AddLNProducerFunction(torch.autograd.Function):
    """``(x, y) = (a + b, LN(a + b) * g + beta)``: B11 for x and the stats,
    then ``normalize_with``; the backward recomputes ``add_ln_plain`` under
    autograd (the harness's ``_producer_bwd``)."""

    @staticmethod
    def forward(ctx, a, b, g, beta):
        x, stats = add_stats(a, b)
        ctx.save_for_backward(a, b, g, beta)
        return x, normalize_with(x, stats, g, beta, a.dtype)

    @staticmethod
    def backward(ctx, gx, gy):
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad)]
        with torch.enable_grad():
            x, y = add_ln_plain(*leaves)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad((x, y), wanted, (gx, gy),
                                         allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None
                     for t in leaves)
