"""LayerNorm over the last axis: forward and backward (kernel B7), and
``LayerNormFunction``, which joins them for autograd.

B7 replaces ``mas_tpu/ops/pallas/layer_norm.py::_fwd_kernel`` and
``_bwd_kernel`` (launched by ``_ln_fwd_pallas`` / ``_ln_bwd_pallas``
under ``ln_pallas``), the opt-in ``layernorm_impl: "pallas"`` LayerNorm of
the transformer.  Same semantics: fp32 statistics whatever the input
dtype, biased variance, eps inside the rsqrt; the forward returns
(x - mean) * rstd * scale + bias in x's dtype, the backward recomputes
mean and rstd from x (nothing is saved but x) and returns

  dx = rstd * (g s - mean(g s) - x^ mean(g s x^)),  x^ = (x - mean) rstd

(means over the row) in x's dtype, dscale = sum g x^ and dbias = sum g over
all rows in fp32.

What bounds both on the H100: bytes.  At the train step's [11264, 1024]
bf16 the forward reads and writes 23 MB each, the backward reads x and g
and writes dx, with ~10 flops per element in between.

What the design does about it, in Triton (a row of d <= 8192 values fits
in one program):
  * forward: one program per row: one read, the two-pass mean and
    variance over registers, one write;
  * backward, pass 1: one program per 16 rows recomputes each row's
    statistics, writes dx, and keeps fp32 partial sums of g x^ and g per
    column, stored once per program;
  * backward, pass 2: one program per 128 columns sums the partials of all
    programs in a fixed order — no atomics, so dscale and dbias do not
    depend on the launch order (B8 does the same).
"""

from __future__ import annotations

import torch

tl = None  # triton.language, bound on first launch
_BWD_ROWS = 16        # rows per program in backward pass 1
_REDUCE_COLS = 128    # columns per program in backward pass 2
_REDUCE_PARTS = 32    # partial rows summed per loop step in pass 2
_JIT = {}


def _ln_fwd_kernel(x_ptr, y_ptr, w_ptr, b_ptr, d, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    m = cols < d
    x = tl.load(x_ptr + row * d + cols, mask=m, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / d
    xc = tl.where(m, x - mean, 0.0)
    rstd = tl.rsqrt(tl.sum(xc * xc, axis=0) / d + eps)
    w = tl.load(w_ptr + cols, mask=m, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + cols, mask=m, other=0.0).to(tl.float32)
    y = xc * rstd * w + b
    tl.store(y_ptr + row * d + cols, y.to(y_ptr.dtype.element_ty), mask=m)


def _ln_bwd_kernel(x_ptr, g_ptr, w_ptr, dx_ptr, part_ptr, n_rows, d, eps,
                   ROWS: tl.constexpr, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    m = cols < d
    w = tl.load(w_ptr + cols, mask=m, other=0.0).to(tl.float32)
    acc_gx = tl.zeros([BLOCK], tl.float32)
    acc_g = tl.zeros([BLOCK], tl.float32)
    start = pid * ROWS
    for row in range(start, tl.minimum(start + ROWS, n_rows)):
        offs = row.to(tl.int64) * d + cols
        x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        g = tl.load(g_ptr + offs, mask=m, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / d
        xc = tl.where(m, x - mean, 0.0)
        rstd = tl.rsqrt(tl.sum(xc * xc, axis=0) / d + eps)
        xhat = xc * rstd
        gs = g * w
        m1 = tl.sum(gs, axis=0) / d
        m2 = tl.sum(gs * xhat, axis=0) / d
        dx = rstd * (gs - m1 - xhat * m2)
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=m)
        acc_gx += g * xhat
        acc_g += g
    out = part_ptr + pid.to(tl.int64) * 2 * d + cols
    tl.store(out, acc_gx, mask=m)
    tl.store(out + d, acc_g, mask=m)


def _ln_bwd_reduce_kernel(part_ptr, dw_ptr, db_ptr, n_parts, d,
                          COLS: tl.constexpr, NB: tl.constexpr):
    cols = tl.program_id(0) * COLS + tl.arange(0, COLS)
    cm = cols < d
    acc_w = tl.zeros([NB, COLS], tl.float32)
    acc_b = tl.zeros([NB, COLS], tl.float32)
    for start in range(0, n_parts, NB):
        pi = start + tl.arange(0, NB)
        mask = (pi < n_parts)[:, None] & cm[None, :]
        ptr = part_ptr + (pi.to(tl.int64) * 2 * d)[:, None] + cols[None, :]
        acc_w += tl.load(ptr, mask=mask, other=0.0)
        acc_b += tl.load(ptr + d, mask=mask, other=0.0)
    tl.store(dw_ptr + cols, tl.sum(acc_w, axis=0), mask=cm)
    tl.store(db_ptr + cols, tl.sum(acc_b, axis=0), mask=cm)


def _kernels():
    """Import triton and JIT-wrap the kernels on first launch (the CPU tests
    import this module where triton does not exist)."""
    global tl
    if not _JIT:
        import triton
        import triton.language as language

        tl = language
        _JIT["fwd"] = triton.jit(_ln_fwd_kernel)
        _JIT["bwd"] = triton.jit(_ln_bwd_kernel)
        _JIT["reduce"] = triton.jit(_ln_bwd_reduce_kernel)
    return _JIT


def _stats(xf: torch.Tensor, eps: float):
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    return xc, torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)


def layer_norm_fwd_plain(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5):
    """Plain twin of the B7 forward: x [N, d] -> LayerNorm(x) in x's
    dtype, fp32 two-pass statistics and affine."""
    xc, rstd = _stats(x.float(), eps)
    return (xc * rstd * scale.float() + bias.float()).to(x.dtype)


def layer_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                         scale: torch.Tensor, eps: float = 1e-5):
    """Plain twin of the B7 backward: (dx in x's dtype, dscale, dbias in
    fp32) from x, the output gradient g [N, d] and scale."""
    xc, rstd = _stats(x.float(), eps)
    xhat = xc * rstd
    gf = g.float()
    gs = gf * scale.float()
    dx = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                 - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), (gf * xhat).sum(dim=0), gf.sum(dim=0)


def _check(x, scale, bias=None, g=None):
    if x.dim() != 2:
        raise ValueError(f"x must be [N, d], got shape {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    d = x.shape[1]
    if d > 8192:
        raise ValueError(f"layer_norm kernel takes d <= 8192, got {d}")
    params = [("scale", scale)] + ([("bias", bias)] if bias is not None
                                   else [])
    for name, p in params:
        if tuple(p.shape) != (d,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{d}] tensor")
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
    if g is not None and (g.shape != x.shape or g.dtype != x.dtype
                          or not g.is_contiguous() or g.device != x.device):
        raise ValueError(f"g must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} tensor on {x.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")


def _block(d: int):
    block = 1 << (d - 1).bit_length()
    return block, 4 if block <= 1024 else 8


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of contiguous rows x [N, d] in x's dtype.  Kernel B7 for
    CUDA tensors, plain twin for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_fwd_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd runs on cpu or cuda, got "
                         f"{x.device}")
    _check(x, scale, bias)
    jit = _kernels()
    n, d = x.shape
    y = torch.empty_like(x)
    block, warps = _block(d)
    with torch.cuda.device(x.device):
        jit["fwd"][(n,)](x, y, scale, bias, d, float(eps), BLOCK=block,
                         num_warps=warps)
    layer_norm_fwd.launches += 1
    return y


layer_norm_fwd.launches = 0


def layer_norm_bwd(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5):
    """Backward of ``layer_norm_fwd`` -> (dx in x's dtype, dscale, dbias in
    fp32).  Kernel B7 for CUDA tensors, plain twin for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, g, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd runs on cpu or cuda, got "
                         f"{x.device}")
    _check(x, scale, g=g)
    jit = _kernels()
    n, d = x.shape
    n_parts = -(-n // _BWD_ROWS)
    part = torch.empty((n_parts, 2, d), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    dbias = torch.empty(d, dtype=torch.float32, device=x.device)
    block, warps = _block(d)
    with torch.cuda.device(x.device):
        jit["bwd"][(n_parts,)](x, g, scale, dx, part, n, d, float(eps),
                               ROWS=_BWD_ROWS, BLOCK=block, num_warps=warps)
        jit["reduce"][(-(-d // _REDUCE_COLS),)](
            part, dscale, dbias, n_parts, d, COLS=_REDUCE_COLS,
            NB=_REDUCE_PARTS, num_warps=4)
    layer_norm_bwd.launches += 1
    return dx, dscale, dbias


layer_norm_bwd.launches = 0


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm over the last axis with a gradient: B7 forward and
    backward (their plain twins on CPU tensors); saves x and scale only.

    The kernels fill outputs made with ``torch.empty``, which carry no
    ``grad_fn``: every differentiable use goes through this Function."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = layer_norm_fwd(x2, scale, bias, eps)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        ctx.dtypes = (scale.dtype, bias.dtype)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        x2, scale = ctx.saved_tensors
        g2 = g.reshape(x2.shape).contiguous()
        dx, dscale, dbias = layer_norm_bwd(x2, g2, scale, ctx.eps)
        return (dx.view(g.shape), dscale.to(ctx.dtypes[0]),
                dbias.to(ctx.dtypes[1]), None)
