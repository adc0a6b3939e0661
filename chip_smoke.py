"""Smoke run of the PyTorch port (``mas_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. print the card (nvidia-smi name and power limit) and the versions;
     no CUDA device is an error — there is no CPU path;
  2. build the CUDA kernels from ``mas_tpu_torch/csrc`` (nvcc, sm_90a);
  3. hold each hand-written kernel (B1-B11) against its plain PyTorch
     twin on the card at the main paths' shapes, and time both, and one
     PyTorch library call that computes the same function where there is
     one (CUDA events, median); each kernel's bound is the larger of its
     bytes over 3.35 TB/s and its operations over the peak for their type;
  4. run the serving path at full width — ``configs/sample_256.json``
     (24 layers, hidden 1024, int4 cache, guidance 3.0, top-k 64), seeded
     random weights, its 4 captions — through ``sample_images``, check the
     images and that every kernel of that path was launched; then check
     teacher-forced logits through the kernels against the plain twins on
     the card, and print end-to-end img/s at batch 4 and 64;
  5. train VQ-SEG at full width — ``configs/seg_256.json`` with
     codebook.init_steps 4 and samples_per_image 256 — for 16 micro-steps
     through ``run_pretrain_segmentation``: pass-through, reservoir
     collection, k-means at counters 12, 14 and 16, quantization through
     B5, five Adam updates; check losses, the phase schedule, the launch
     floors of B4/B5/B8, a bitwise resume from the final checkpoint, and
     one micro-step through the kernels against the plain twins;
  6. tokenize 8 random 512^2 images with the ``configs/img_512.json``
     model (bf16, K = 8192) through ``encode_tokens``;
  7. train the transformer at full width — ``configs/transformer_512.json``
     as shipped (24 layers, hidden 1024, T = 1408, batch 8, bf16, remat
     'mlp') — for 8 steps through ``run_train_transformer`` (B1, B6), then
     2 resumed steps with ``layernorm_impl: "pallas"`` (B7) and CFG dropout
     forced; check losses, fp32 parameters, a nonzero gradient for every
     parameter, the exact launch counts, a bitwise resume, and one step
     through the kernels against the plain twins;
  8. serve 512^2 images over the float KV cache from the checkpoint that
     phase 7 wrote, loaded as the CLI loads ``transformer_checkpoint``: the
     ``transformer`` section of ``configs/transformer_512.json`` as it is
     (``kv_cache_dtype`` "compute"), the ``model`` section of
     ``configs/img_512.json`` (seeded random weights) and the sampling
     keys of ``configs/sample_256.json``, built in memory
     (``sample_512_raw``); exact launch counts (B1 24, B9 24 x 1023, B2 =
     B3 = B10 = 0), teacher-forced logits through the kernels against the
     twins, end-to-end s and img/s at batch 4 and 64;
  9. serve 256^2 images over the packed int4 cache (``configs/
     sample_256.json`` with ``kv_cache_layout: "packed"``) at batch 4:
     exact counts (B10 = B2 = 24 x 255, B3 = 0), and greedy tokens equal to
     the lane cache's on the same weights;
 10. the producer-fused LayerNorm harness of ``benchmarks/ln_producer.py``
     at its shape (rows 16 x 1408, d 1024, bf16, 20 chained steps of
     ``x + LN(a + b) @ W``): parity, then the plain and the B11 path,
     forward and forward + backward.
Each path's launch counts are zeroed just before it and read just after.
The line before the last is a JSON object with one entry per kernel
(``launches`` summed over the paths); the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack
from unittest import mock

import torch
from torch.nn import functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "sample_256.json")
SEG_CONFIG = os.path.join(ROOT, "configs", "seg_256.json")
IMG_CONFIG = os.path.join(ROOT, "configs", "img_512.json")
TRANSFORMER_CONFIG = os.path.join(ROOT, "configs", "transformer_512.json")
TRAIN_STEPS = 16
TRANSFORMER_STEPS = 8
DEVICE = "cuda"
# H100 SXM data sheet (dense): device memory rate and peak rates by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def timed_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a, b, atol: float, rtol: float) -> bool:
    return bool(((a.float() - b.float()).abs()
                 <= atol + rtol * b.float().abs()).all())


def bound(nbytes: float, ops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate, and its operations over the peak for the inputs'
    type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def prefix_causal_pairs(t: int, prefix: int) -> int:
    """Visible (query, key) pairs of one (b, h) under the prefix mask."""
    return prefix * prefix + sum(r + 1 for r in range(prefix, t))


def prefix_causal_mask(t: int, prefix: int):
    pos = torch.arange(t, device="cuda")
    q, k = pos[:, None], pos[None, :]
    return (k <= q) | ((q < prefix) & (k < prefix))


# --- phase 1 / 2 ------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; "
                           "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from mas_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")


# --- phase 3: kernels vs plain twins ----------------------------------------

def check_b1(gen) -> dict:
    """Prefill attention at [8, 16, 384, 64] bf16, q/k/v as views into one
    fused qkv tensor as the model passes them.  Tolerance: both versions
    accumulate in fp32 and round the output to bf16 once, so they differ by
    at most about one bf16 ulp (2^-8 relative): atol 1e-2, rtol 1e-2; lse
    is fp32: atol 1e-4."""
    from mas_tpu_torch.ops import attention

    b, h, t, d = 8, 16, 384, 64
    qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=gen,
                      dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    err, out = 0.0, {}
    for prefix in (384, 0):
        o, lse = attention.flash_attention(q, k, v, prefix)
        po, plse = attention.prefix_causal_attention_plain(q, k, v, prefix)
        torch.cuda.synchronize()
        require(close(o, po, 1e-2, 1e-2), f"B1 out, prefix {prefix}: "
                f"max err {max_err(o, po)}")
        require(close(lse, plse, 1e-4, 0.0), f"B1 lse, prefix {prefix}: "
                f"max err {max_err(lse, plse)}")
        err = max(err, max_err(o, po))
        print(f"B1 prefix {prefix}: out max err {max_err(o, po):.3e}, "
              f"lse max err {max_err(lse, plse):.3e}")
    # fp32, T = 200 (no multiple of the 32-row or 64-key tile), prefixes at
    # and between the ends; fp32 sums in another order: atol 1e-5
    q32, k32, v32 = (torch.randn(2, 4, 200, d, device="cuda", generator=gen)
                     for _ in range(3))
    for prefix in (0, 37, 100, 200):
        o, lse = attention.flash_attention(q32, k32, v32, prefix)
        po, plse = attention.prefix_causal_attention_plain(q32, k32, v32,
                                                           prefix)
        torch.cuda.synchronize()
        require(close(o, po, 1e-5, 1e-5) and close(lse, plse, 1e-5, 0.0),
                f"B1 fp32 T=200 prefix {prefix}: max err {max_err(o, po)}")
    print("B1 fp32 T=200 prefix 0/37/100/200: ok")
    out["ms"] = timed_ms(lambda: attention.flash_attention(q, k, v, 384))
    out["plain_ms"] = timed_ms(
        lambda: attention.prefix_causal_attention_plain(q, k, v, 384))
    mask = prefix_causal_mask(t, 384)
    out["library_ms"] = timed_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))
    out.update(bound(4 * b * h * t * d * 2 + b * h * t * 4,
                     4 * d * prefix_causal_pairs(t, 384) * b * h,
                     torch.bfloat16))
    out["max_abs_err"] = err
    return out


def _caches(gen, bits, b=128, h=16, t=640, d=64):
    from mas_tpu_torch.ops import quant

    mk = lambda: quant.quantize_kv(torch.randn(
        b, h, t, d, device="cuda", generator=gen), bits)
    return mk(), mk()


def check_b2(gen) -> dict:
    """Decode read: q [128, 16, 1, 64] bf16 (a view into qkv), int4 and int8
    caches with T = 640, index 384 / 511 / 639.  Tolerance: both versions
    accumulate in fp32 and round to bf16 once: atol 1e-2, rtol 1e-2.  The
    packed cache is read through strided views of its k and v halves: it
    must give the lane read of the same values bit for bit (same kernel,
    same arithmetic, another position stride), and match its plain twin."""
    from mas_tpu_torch.ops import decode_cache, quant

    b, h, d = 128, 16, 64
    qkv = torch.randn(b, 1, 3, h, d, device="cuda", generator=gen,
                      dtype=torch.bfloat16)
    q = qkv[:, :, 0].transpose(1, 2)
    err, out = 0.0, {}
    for bits in (4, 8):
        kc, vc = _caches(gen, bits)
        for index in (384, 511, 639):
            idx = torch.tensor([index], dtype=torch.int32, device="cuda")
            o = quant.decode_attention_quant(q, kc, vc, idx)
            p = quant.decode_attention_quant_plain(q, kc, vc, idx)
            torch.cuda.synchronize()
            require(close(o, p, 1e-2, 1e-2),
                    f"B2 int{bits} index {index}: max err {max_err(o, p)}")
            err = max(err, max_err(o, p))
            print(f"B2 int{bits} index {index}: max err {max_err(o, p):.3e}")
            # fp32 q: only the fp32 summation order differs, atol 1e-5
            q32 = q.float()
            require(close(quant.decode_attention_quant(q32, kc, vc, idx),
                          quant.decode_attention_quant_plain(q32, kc, vc, idx),
                          1e-5, 1e-5), f"B2 fp32 int{bits} index {index}")
        if bits == 4:   # the config's cache; 511 is mid-way through decode
            idx = torch.tensor([511], dtype=torch.int32, device="cuda")
            out["ms"] = timed_ms(
                lambda: quant.decode_attention_quant(q, kc, vc, idx))
            out["plain_ms"] = timed_ms(
                lambda: quant.decode_attention_quant_plain(q, kc, vc, idx))
        packed = decode_cache.seed_packed_cache(
            torch.randn(b, h, 640, d, device="cuda", generator=gen),
            torch.randn(b, h, 640, d, device="cuda", generator=gen), 640,
            bits)
        lane = [quant.QuantCache(c.q.contiguous(), c.scale.contiguous(),
                                 bits) for c in packed.views()]
        for index in (384, 511, 639):
            idx = torch.tensor([index], dtype=torch.int32, device="cuda")
            o = decode_cache.decode_attention_packed(q, packed, idx)
            p = decode_cache.decode_attention_packed_plain(q, packed, idx)
            o_lane = quant.decode_attention_quant(q, *lane, idx)
            torch.cuda.synchronize()
            require(torch.equal(o, o_lane), f"B2 packed int{bits} index "
                    f"{index}: differs from the lane read of the same values")
            require(close(o, p, 1e-2, 1e-2), f"B2 packed int{bits} index "
                    f"{index}: max err {max_err(o, p)}")
            err = max(err, max_err(o, p))
        idx = torch.tensor([511], dtype=torch.int32, device="cuda")
        out[f"packed_int{bits}_ms"] = timed_ms(
            lambda: decode_cache.decode_attention_packed(q, packed, idx))
        out[f"lane_int{bits}_ms"] = timed_ms(
            lambda: quant.decode_attention_quant(q, *lane, idx))
        print(f"B2 packed int{bits}: equal to the lane read at 384/511/639; "
              f"index 511 packed {out[f'packed_int{bits}_ms']:.4f} ms, lane "
              f"{out[f'lane_int{bits}_ms']:.4f} ms")
    valid = 512
    out.update(bound(2 * b * h * valid * (d // 2 + 4) + 2 * b * h * d * 2,
                     4 * d * valid * b * h, torch.bfloat16))
    out["library_ms"] = None
    out["max_abs_err"] = err
    return out


def check_b3(gen) -> dict:
    """Cache write into the same [128, 16, 640, *] caches: the kernel and
    the plain twin must store identical bits (IEEE division and
    round-half-even in both)."""
    from mas_tpu_torch.ops import decode_cache, quant

    b, h, d = 128, 16, 64
    qkv = torch.randn(b, 1, 3, h, d, device="cuda", generator=gen,
                      dtype=torch.bfloat16) * 3
    kn, vn = qkv[:, 0, 1], qkv[:, 0, 2]
    out = {}
    for bits in (4, 8):
        kc, vc = _caches(gen, bits)
        clone = lambda c: quant.QuantCache(c.q.clone(), c.scale.clone(),
                                           c.bits)
        pk, pv = clone(kc), clone(vc)
        for index in (384, 511, 639):
            idx = torch.tensor([index], dtype=torch.int32, device="cuda")
            decode_cache.write_quant_kv(kc, vc, kn, vn, idx)
            decode_cache.write_quant_kv_plain(pk, pv, kn, vn, idx)
        torch.cuda.synchronize()
        for got, want in ((kc, pk), (vc, pv)):
            require(torch.equal(got.q, want.q)
                    and torch.equal(got.scale, want.scale),
                    f"B3 int{bits}: kernel and plain twin stored different "
                    "bits")
        print(f"B3 int{bits}: bitwise equal")
        if bits == 4:
            idx = torch.tensor([511], dtype=torch.int32, device="cuda")
            out["ms"] = timed_ms(
                lambda: decode_cache.write_quant_kv(kc, vc, kn, vn, idx))
            out["plain_ms"] = timed_ms(
                lambda: decode_cache.write_quant_kv_plain(pk, pv, kn, vn,
                                                          idx))
    # int4: read k, v [b, h, d] bf16; write d/2 bytes and a scale each
    out.update(bound(2 * b * h * d * 2 + 2 * b * h * (d // 2 + 4),
                     2 * b * h * d * 4, torch.bfloat16))
    out["library_ms"] = None
    out["max_abs_err"] = 0.0
    return out


def check_b4(gen) -> dict:
    """GroupNorm+swish at [4, 256, 256, 128] and [4, 16, 16, 512] bf16.
    Tolerance: outputs are rounded to bf16 once from fp32 values that
    differ only in summation order: atol 3e-2, rtol 1e-2 (two bf16 ulps at
    |y| < 4); stats are fp32 sums of up to 2^21 terms: rtol 1e-4."""
    from mas_tpu_torch.ops import gn_swish

    err, out = 0.0, {}
    for shape in ((4, 256, 256, 128), (4, 16, 16, 512)):
        c = shape[-1]
        x = (torch.randn(*shape, device="cuda", generator=gen) * 2 + 0.5
             ).to(torch.bfloat16)
        s = torch.randn(c, device="cuda", generator=gen)
        bias = torch.randn(c, device="cuda", generator=gen)
        y, st = gn_swish.gn_swish(x, s, bias)
        py, pst = gn_swish.gn_swish_plain(x, s, bias)
        torch.cuda.synchronize()
        require(close(y, py, 3e-2, 1e-2), f"B4 {shape} out: max err "
                f"{max_err(y, py)}")
        require(close(st, pst, 1e-6, 1e-4), f"B4 {shape} stats: max err "
                f"{max_err(st, pst)}")
        err = max(err, max_err(y, py))
        print(f"B4 {shape}: out max err {max_err(y, py):.3e}, stats max err "
              f"{max_err(st, pst):.3e}")
        if c == 512:
            # fp32 input: only the summation order differs, atol 1e-5
            x32 = x.float()
            y32, st32 = gn_swish.gn_swish(x32, s, bias)
            py32, pst32 = gn_swish.gn_swish_plain(x32, s, bias)
            require(close(y32, py32, 1e-5, 1e-5)
                    and close(st32, pst32, 1e-6, 1e-5), "B4 fp32 [4,16,16,512]")
        if c == 128:
            out["ms"] = timed_ms(lambda: gn_swish.gn_swish(x, s, bias))
            out["plain_ms"] = timed_ms(
                lambda: gn_swish.gn_swish_plain(x, s, bias))
            n = x.numel()
            out.update(bound(2 * n * 2 + shape[0] * 32 * 2 * 4, 12 * n,
                             torch.bfloat16))
    out["library_ms"] = None
    out["max_abs_err"] = err
    return out


def check_b5(gen) -> dict:
    """VQ argmin at (N=512, K=1024, D=256) fp32, the seg training shape,
    and (N=8192, K=8192, D=256) bf16 z and codebook, the img_512
    tokenization shape, against the plain twin.  Tolerance: the agreement
    rule of ``mas_tpu_torch/ops/vq.py`` (where the indices differ, the
    twin's distance of the kernel's choice within 1e-5 * (||z||^2 + max
    ||e||^2) of the minimum; every chosen code the first of its exact
    copies), since the kernel sums each dot product in another order.
    Exactly duplicated codebook rows must resolve to the first index.
    max_abs_err is the largest such distance gap."""
    from mas_tpu_torch.ops import vq

    out, gap = {}, 0.0
    for n, k, dtype in ((512, 1024, torch.float32),
                        (8192, 8192, torch.bfloat16)):
        z = torch.randn(n, 256, device="cuda", generator=gen).to(dtype)
        cb = torch.randn(k, 256, device="cuda", generator=gen).to(dtype)
        got = vq.vq_argmin(z, cb)
        want = vq.vq_argmin_plain(z, cb)
        torch.cuda.synchronize()
        require(got.dtype == torch.int32 and got.shape == (n,),
                f"B5 output {got.dtype} {tuple(got.shape)}")
        require(vq.argmin_agrees(z, cb, got, want),
                f"B5 ({n}, {k}, {dtype}): indices disagree beyond near-ties "
                f"({int((got != want).sum())} rows differ)")
        dist = vq.vq_distances(z, cb)
        gap = max(gap, float((dist.gather(1, got.long()[:, None])[:, 0]
                              - dist.min(dim=1).values).max()))
        print(f"B5 ({n}, {k}, 256) {dtype}: agreement "
              f"{float((got == want).float().mean()):.6f}")
    # z and cb are the tokenization shape now: time both there
    out["ms"] = timed_ms(lambda: vq.vq_argmin(z, cb))
    out["plain_ms"] = timed_ms(lambda: vq.vq_argmin_plain(z, cb))
    out.update(bound((n + k) * 256 * 2 + n * 4, 2 * n * k * 256 + 2 * k * 256,
                     torch.bfloat16))
    out["library_ms"] = None
    dup = torch.randn(1024, 256, device="cuda", generator=gen)
    dup[700] = dup[5]
    dup[900] = dup[5]
    ties = vq.vq_argmin(dup[[900, 700, 5, 17]].contiguous(), dup)
    require(ties.tolist() == [5, 5, 5, 17], f"B5 ties: {ties.tolist()}")
    out["max_abs_err"] = gap
    return out


def check_b8(gen) -> dict:
    """GroupNorm+swish backward at [2,256,256,128] fp32 (the seg encoder's
    largest), [2,16,16,512] fp32 and [4,256,256,128] bf16, against the
    closed-form twin and against torch.autograd through gn_swish_plain.
    Tolerances: fp32 dx atol 1e-5 (elementwise work in another order; the
    per-group sums enter divided by N); dscale/dbias are sums over B*H*W
    rows, whose fp32 rounding grows like sqrt(rows): atol 1e-4 * sqrt(rows),
    rtol 1e-5; bf16 dx is rounded to bf16 once on each side: atol 3e-2,
    rtol 1e-2, as the B4 check.  Also: GroupNormSwish's output carries a
    grad_fn on the card and its gradients through GNSwishFunction (B4 +
    B8) match autograd of the plain twin."""
    from mas_tpu_torch.models.layers import GroupNormSwish
    from mas_tpu_torch.ops import gn_swish

    err, out = 0.0, {}
    for shape, dtype in (((2, 256, 256, 128), torch.float32),
                         ((2, 16, 16, 512), torch.float32),
                         ((4, 256, 256, 128), torch.bfloat16)):
        c = shape[-1]
        rows = shape[0] * shape[1] * shape[2]
        x = (torch.randn(*shape, device="cuda", generator=gen) * 2 + 0.5
             ).to(dtype)
        g = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
        s = torch.randn(c, device="cuda", generator=gen) * 0.5 + 1.0
        b = torch.randn(c, device="cuda", generator=gen) * 0.1
        _, stats = gn_swish.gn_swish(x, s, b)
        got = gn_swish.gn_swish_bwd(x, g, s, b, stats)
        plain = gn_swish.gn_swish_bwd_plain(x, g, s, b, stats)
        leaves = [t.detach().clone().requires_grad_() for t in (x, s, b)]
        auto = torch.autograd.grad(gn_swish.gn_swish_plain(*leaves)[0],
                                   leaves, g)
        torch.cuda.synchronize()
        dx_tol = (1e-5, 0.0) if dtype == torch.float32 else (3e-2, 1e-2)
        p_tol = (1e-4 * rows ** 0.5, 1e-5)
        for name, want in (("plain twin", plain), ("autograd", auto)):
            require(close(got[0], want[0], *dx_tol),
                    f"B8 {shape} {dtype} dx vs {name}: max err "
                    f"{max_err(got[0], want[0])}")
            for i, what in ((1, "dscale"), (2, "dbias")):
                require(close(got[i], want[i], *p_tol),
                        f"B8 {shape} {dtype} {what} vs {name}: max err "
                        f"{max_err(got[i], want[i])}")
        err = max(err, max_err(got[0], plain[0]))
        print(f"B8 {shape} {dtype}: dx max err {max_err(got[0], plain[0]):.3e}"
              f", dscale {max_err(got[1], plain[1]):.3e}, dbias "
              f"{max_err(got[2], plain[2]):.3e}")
        if shape == (2, 256, 256, 128):
            norm = GroupNormSwish(c).cuda()
            with torch.no_grad():
                norm.weight.copy_(s)
                norm.bias.copy_(b)
            xin = x.permute(0, 3, 1, 2).detach().requires_grad_()
            y = norm(xin)
            require(y.requires_grad and y.grad_fn is not None,
                    "GroupNormSwish output carries no grad_fn on the card")
            fn = torch.autograd.grad(y, (xin, norm.weight, norm.bias),
                                     g.permute(0, 3, 1, 2))
            require(close(fn[0].permute(0, 2, 3, 1), auto[0], *dx_tol)
                    and close(fn[1], auto[1], *p_tol)
                    and close(fn[2], auto[2], *p_tol),
                    "GNSwishFunction gradients vs autograd of the twin")
            out["ms"] = timed_ms(
                lambda: gn_swish.gn_swish_bwd(x, g, s, b, stats))
            out["plain_ms"] = timed_ms(
                lambda: gn_swish.gn_swish_bwd_plain(x, g, s, b, stats))
            n = x.numel()
            out.update(bound(3 * n * 4, 20 * n, torch.float32))
    out["library_ms"] = None
    out["max_abs_err"] = err
    return out


def bf16_ulps(a: torch.Tensor, b: torch.Tensor, n: int) -> bool:
    """|a - b| <= n bf16 ulps of max |b| everywhere."""
    top = float(b.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return max_err(a, b) <= n * ulp


def check_b6(gen) -> dict:
    """Attention backward at [8, 16, 1408, 64] bf16 at prefix 384 and 0
    (the training geometry) and [2, 16, 640, 64] fp32 at prefix 384, q/k/v
    as views into one fused qkv tensor, out and lse from B1 and dO laid out
    [B, T, H, d] as the model passes them.  Tolerances, per tensor against
    the plain twin: fp32 atol 1e-4 * max |grad| (both sum over up to T
    products in fp32, in other orders); bf16 two bf16 ulps of max |grad|
    (both round an fp32 value to bf16 once)."""
    from mas_tpu_torch.ops import attention

    out, err = {}, 0.0
    for (b, h, t, d), dtype, prefix in (
            ((8, 16, 1408, 64), torch.bfloat16, 384),
            ((8, 16, 1408, 64), torch.bfloat16, 0),
            ((2, 16, 640, 64), torch.float32, 384)):
        qkv = torch.randn(b, t, 3, h, d, device="cuda", generator=gen,
                          dtype=dtype)
        q, k, v = attention.split_qkv(qkv)
        o, lse = attention.flash_attention(q, k, v, prefix)
        do = torch.randn(b, t, h, d, device="cuda", generator=gen,
                         dtype=dtype).transpose(1, 2)
        got = attention.flash_attention_bwd(q, k, v, o, lse, do, prefix)
        want = attention.prefix_causal_attention_bwd_plain(q, k, v, o, lse,
                                                           do, prefix)
        torch.cuda.synchronize()
        for i, name in enumerate(("dq", "dk", "dv")):
            g, w = got[:, :, i].transpose(1, 2), want[i]
            ok = (bf16_ulps(g, w, 2) if dtype == torch.bfloat16 else
                  max_err(g, w) <= 1e-4 * float(w.abs().max()))
            require(ok, f"B6 {name} [{b},{h},{t},{d}] {dtype} prefix "
                    f"{prefix}: max err {max_err(g, w):.3e}, max |grad| "
                    f"{float(w.float().abs().max()):.3e}")
            err = max(err, max_err(g, w))
            print(f"B6 {name} [{b},{h},{t},{d}] {dtype} prefix {prefix}: "
                  f"max err {max_err(g, w):.3e}, max |grad| "
                  f"{float(w.float().abs().max()):.3e}")
        if dtype == torch.bfloat16 and prefix == 384:
            args = (q, k, v, o, lse, do, prefix)
            out["ms"] = timed_ms(lambda: attention.flash_attention_bwd(*args))
            out["plain_ms"] = timed_ms(
                lambda: attention.prefix_causal_attention_bwd_plain(*args),
                reps=5)
            # the library call's backward, from its own forward's graph
            leaves = [x.detach().contiguous().requires_grad_()
                      for x in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(
                *leaves, attn_mask=prefix_causal_mask(t, prefix))
            out["library_ms"] = timed_ms(lambda: torch.autograd.grad(
                lib_out, leaves, do, retain_graph=True), reps=10)
            del leaves, lib_out
            n = b * h * t * d
            out.update(bound(8 * n * 2 + b * h * t * 4,
                             10 * d * prefix_causal_pairs(t, prefix) * b * h,
                             torch.bfloat16))
        del got, want
    out["max_abs_err"] = err
    return out


def check_b7(gen) -> dict:
    """LayerNorm forward and backward at [11264, 1024] (the train step's
    B * T rows) in bf16 and fp32 against the plain twins.  Tolerances: y
    and dx are rounded to x's dtype once from fp32 values that differ only
    in summation order: fp32 atol 1e-5, rtol 1e-5; bf16 atol 1e-2, rtol
    1e-2 (one bf16 ulp is 2^-8 to 2^-7 relative).  dscale and dbias are
    fp32 sums over 11264 rows, whose rounding grows like sqrt(rows): atol
    1e-4 * sqrt(rows), rtol 1e-5, as for B8."""
    from mas_tpu_torch.ops import layer_norm as ln

    n, d = 11264, 1024
    out, err = {}, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(n, d, device="cuda", generator=gen) * 2 + 0.5
             ).to(dtype)
        g = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
        s = torch.randn(d, device="cuda", generator=gen) * 0.5 + 1.0
        b = torch.randn(d, device="cuda", generator=gen) * 0.1
        y = ln.layer_norm_fwd(x, s, b)
        py = ln.layer_norm_fwd_plain(x, s, b)
        got = ln.layer_norm_bwd(x, g, s)
        want = ln.layer_norm_bwd_plain(x, g, s)
        torch.cuda.synchronize()
        tol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 1e-2)
        p_tol = (1e-4 * n ** 0.5, 1e-5)
        require(y.dtype == dtype and close(y, py, *tol),
                f"B7 fwd {dtype}: max err {max_err(y, py):.3e}")
        require(got[0].dtype == dtype and close(got[0], want[0], *tol),
                f"B7 dx {dtype}: max err {max_err(got[0], want[0]):.3e}")
        for i, what in ((1, "dscale"), (2, "dbias")):
            require(close(got[i], want[i], *p_tol), f"B7 {what} {dtype}: "
                    f"max err {max_err(got[i], want[i]):.3e}")
        err = max(err, max_err(y, py), max_err(got[0], want[0]))
        print(f"B7 [{n},{d}] {dtype}: y max err {max_err(y, py):.3e}, dx "
              f"{max_err(got[0], want[0]):.3e}, dscale "
              f"{max_err(got[1], want[1]):.3e}, dbias "
              f"{max_err(got[2], want[2]):.3e}")
        if dtype == torch.bfloat16:
            out["ms"] = timed_ms(lambda: (ln.layer_norm_fwd(x, s, b),
                                          ln.layer_norm_bwd(x, g, s)))
            out["plain_ms"] = timed_ms(lambda: (
                ln.layer_norm_fwd_plain(x, s, b),
                ln.layer_norm_bwd_plain(x, g, s)))
            # the library call needs bf16 parameters on a bf16 input
            lib_in = [t.detach().to(dtype).requires_grad_() for t in (x, s, b)]
            out["library_ms"] = timed_ms(lambda: torch.autograd.grad(
                F.layer_norm(lib_in[0], (d,), lib_in[1], lib_in[2], 1e-5),
                lib_in, g))
            out.update(bound(4 * n * d * 2, 20 * n * d, torch.bfloat16))
            out["fwd_ms"] = timed_ms(lambda: ln.layer_norm_fwd(x, s, b))
            out["fwd_plain_ms"] = timed_ms(
                lambda: ln.layer_norm_fwd_plain(x, s, b))
            print(f"B7 bf16 forward alone: kernel {out['fwd_ms']:.4f} ms, "
                  f"plain {out['fwd_plain_ms']:.4f} ms")
    out["max_abs_err"] = err
    return out


def check_b9(gen) -> dict:
    """Float-cache decode read at the 512^2 serving shape: q [128, 16, 1, 64]
    bf16 (a view into qkv, batch 64 with guidance) against bf16 caches
    [128, 16, 1408, 64] at index 383 (the last prefix position), 895 and
    1407, and the batch-4 shape (8 rows); fp32 caches [8, 16, 640, 64].
    Tolerance: both versions accumulate in fp32 and round the output to
    bf16 once: atol 1e-2, rtol 1e-2; fp32 q and caches: only the fp32
    summation order differs, atol 1e-5, rtol 1e-5.  Timed at index 1407,
    where every position is read; the library call is
    ``F.scaled_dot_product_attention`` over the valid prefix."""
    from mas_tpu_torch.ops import decode_attention as da

    h, t, d = 16, 1408, 64
    out, err = {}, 0.0
    for rows in (128, 8):
        qkv = torch.randn(rows, 1, 3, h, d, device="cuda", generator=gen,
                          dtype=torch.bfloat16)
        q = qkv[:, :, 0].transpose(1, 2)
        kc, vc = (da.FloatCache(torch.randn(rows, h, t, d, device="cuda",
                                            generator=gen,
                                            dtype=torch.bfloat16))
                  for _ in range(2))
        for index in (383, 895, 1407):
            idx = torch.tensor([index], dtype=torch.int32, device="cuda")
            o = da.decode_attention_float(q, kc, vc, idx)
            p = da.decode_attention_float_plain(q, kc, vc, idx)
            torch.cuda.synchronize()
            require(close(o, p, 1e-2, 1e-2), f"B9 [{rows},{h},{t},{d}] bf16 "
                    f"index {index}: max err {max_err(o, p)}")
            err = max(err, max_err(o, p))
            print(f"B9 [{rows},{h},{t},{d}] bf16 index {index}: max err "
                  f"{max_err(o, p):.3e}")
        idx = torch.tensor([1407], dtype=torch.int32, device="cuda")
        ms = timed_ms(lambda: da.decode_attention_float(q, kc, vc, idx))
        mid = torch.tensor([895], dtype=torch.int32, device="cuda")
        ms_mid = timed_ms(lambda: da.decode_attention_float(q, kc, vc, mid))
        print(f"B9 [{rows},{h},{t},{d}]: index 1407 {ms:.4f} ms, index 895 "
              f"{ms_mid:.4f} ms")
        if rows == 128:
            out["ms"], out["mid_ms"] = ms, ms_mid
            out["plain_ms"] = timed_ms(
                lambda: da.decode_attention_float_plain(q, kc, vc, idx))
            qc = q.contiguous()
            out["library_ms"] = timed_ms(lambda: F.scaled_dot_product_attention(
                qc, kc.data, vc.data))
            out.update(bound(2 * rows * h * t * d * 2 + 2 * rows * h * d * 2,
                             4 * d * t * rows * h, torch.bfloat16))
        else:
            out["batch4_ms"] = ms
        del kc, vc
    q32 = torch.randn(8, h, 1, d, device="cuda", generator=gen)
    k32, v32 = (da.FloatCache(torch.randn(8, h, 640, d, device="cuda",
                                          generator=gen)) for _ in range(2))
    for index in (0, 383, 639):
        idx = torch.tensor([index], dtype=torch.int32, device="cuda")
        o = da.decode_attention_float(q32, k32, v32, idx)
        p = da.decode_attention_float_plain(q32, k32, v32, idx)
        torch.cuda.synchronize()
        require(close(o, p, 1e-5, 1e-5), f"B9 fp32 index {index}: max err "
                f"{max_err(o, p)}")
    print("B9 fp32 [8,16,640,64] index 0/383/639: ok")
    out["max_abs_err"] = err
    return out


def check_b10(gen) -> dict:
    """Packed cache write, int8 and int4, at the 256^2 serving shape: new
    k/v [128, 16, 64] bf16 (views into qkv) into [128, 16, 640, *] packed
    caches at index 384, 511, 639.  The kernel and the plain twin must
    store identical bits (IEEE division and round-half-even in both), and
    so must B3 into lane caches: the packed halves equal the lane caches."""
    from mas_tpu_torch.ops import decode_cache, quant

    b, h, t, d = 128, 16, 640, 64
    qkv = torch.randn(b, 1, 3, h, d, device="cuda", generator=gen,
                      dtype=torch.bfloat16) * 3
    kn, vn = qkv[:, 0, 1], qkv[:, 0, 2]
    out = {}
    for bits in (8, 4):
        k0, v0 = (torch.randn(b, h, 384, d, device="cuda", generator=gen)
                  for _ in range(2))
        cache = decode_cache.seed_packed_cache(k0, v0, t, bits)
        plain = decode_cache.PackedQuantCache(cache.kv.clone(),
                                              cache.scale.clone(), bits)
        lane = [quant.QuantCache(c.q.contiguous(), c.scale.contiguous(), bits)
                for c in cache.views()]
        for index in (384, 511, 639):
            idx = torch.tensor([index], dtype=torch.int32, device="cuda")
            decode_cache.write_packed_kv(cache, kn, vn, idx)
            decode_cache.write_packed_kv_plain(plain, kn, vn, idx)
            decode_cache.write_quant_kv(*lane, kn, vn, idx)
        torch.cuda.synchronize()
        require(torch.equal(cache.kv, plain.kv)
                and torch.equal(cache.scale, plain.scale),
                f"B10 int{bits}: kernel and plain twin stored different bits")
        for view, want in zip(cache.views(), lane):
            require(torch.equal(view.q, want.q)
                    and torch.equal(view.scale, want.scale),
                    f"B10 int{bits}: packed halves differ from B3's lane "
                    "caches")
        print(f"B10 int{bits}: bitwise equal to its twin and to B3")
        if bits == 4:
            idx = torch.tensor([511], dtype=torch.int32, device="cuda")
            out["ms"] = timed_ms(
                lambda: decode_cache.write_packed_kv(cache, kn, vn, idx))
            out["plain_ms"] = timed_ms(
                lambda: decode_cache.write_packed_kv_plain(plain, kn, vn,
                                                           idx))
    out.update(bound(2 * b * h * d * 2 + 2 * b * h * (d // 2 + 4),
                     2 * b * h * d * 4, torch.bfloat16))
    out["library_ms"] = None
    out["max_abs_err"] = 0.0
    return out


LN_ROWS, LN_D = 16 * 1408, 1024


def check_b11(gen) -> dict:
    """Residual add + LayerNorm stats at the harness shape [16 * 1408, 1024]
    bf16, and at [1000, 1000] fp32 (no power of two, no multiple of the
    TPU kernel's 512-row tile).  x must be bitwise equal (one fp32 add,
    rounded once); the stats are fp32 row sums in another order, and
    rstd a reciprocal square root: atol 1e-6, rtol 1e-6."""
    from mas_tpu_torch.ops import ln_producer

    out, err = {}, 0.0
    for (rows, d), dtype in (((LN_ROWS, LN_D), torch.bfloat16),
                             ((1000, 1000), torch.float32)):
        a, b = (torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        x, st = ln_producer.add_stats(a, b)
        px, pst = ln_producer.add_stats_plain(a, b)
        torch.cuda.synchronize()
        require(torch.equal(x, px), f"B11 [{rows},{d}] {dtype}: x differs "
                "from the plain twin")
        require(close(st, pst, 1e-6, 1e-6), f"B11 [{rows},{d}] {dtype}: "
                f"stats max err {max_err(st, pst)}")
        err = max(err, max_err(st, pst))
        print(f"B11 [{rows},{d}] {dtype}: x bitwise equal, stats max err "
              f"{max_err(st, pst):.3e}")
        if dtype == torch.bfloat16:
            out["ms"] = timed_ms(lambda: ln_producer.add_stats(a, b))
            out["plain_ms"] = timed_ms(
                lambda: ln_producer.add_stats_plain(a, b))
            n = rows * d
            out.update(bound(3 * n * 2 + rows * 8, 6 * n, torch.bfloat16))
    out["library_ms"] = None
    out["max_abs_err"] = err
    return out


KERNELS = (
    # id, name, route, source, replaces, check
    ("B1", "B1 flash_attention", "cuda", "mas_tpu_torch/csrc/flash_fwd.cu",
     "mas_tpu/ops/attention.py:117", check_b1),
    ("B2", "B2 decode_attention_quant", "cuda",
     "mas_tpu_torch/csrc/decode_quant.cu", "mas_tpu/ops/quant.py:187",
     check_b2),
    ("B3", "B3 write_quant_kv", "triton", "mas_tpu_torch/ops/decode_cache.py",
     "mas_tpu/ops/decode_cache.py:270", check_b3),
    ("B4", "B4 gn_swish", "triton", "mas_tpu_torch/ops/gn_swish.py",
     "mas_tpu/ops/pallas/gn_swish.py:50", check_b4),
    ("B5", "B5 vq_argmin", "cuda", "mas_tpu_torch/csrc/vq_argmin.cu",
     "mas_tpu/ops/vq.py:33", check_b5),
    ("B6", "B6 flash_attention_bwd", "cuda", "mas_tpu_torch/csrc/flash_bwd.cu",
     "mas_tpu/ops/attention.py:354", check_b6),
    ("B7", "B7 layer_norm_fwd + layer_norm_bwd", "triton",
     "mas_tpu_torch/ops/layer_norm.py", "mas_tpu/ops/pallas/layer_norm.py:47",
     check_b7),
    ("B8", "B8 gn_swish_bwd", "triton", "mas_tpu_torch/ops/gn_swish.py",
     "mas_tpu/ops/pallas/gn_swish.py:117", check_b8),
    ("B9", "B9 decode_attention_float", "cuda",
     "mas_tpu_torch/csrc/decode_quant.cu", "mas_tpu/ops/decode_attention.py:69",
     check_b9),
    ("B10", "B10 write_packed_kv", "triton",
     "mas_tpu_torch/ops/decode_cache.py", "mas_tpu/ops/decode_cache.py:111",
     check_b10),
    ("B11", "B11 add_stats", "triton", "mas_tpu_torch/ops/ln_producer.py",
     "benchmarks/ln_producer.py:49", check_b11),
)


def wrappers() -> dict:
    """The launch-counting wrappers of each kernel, keyed by its id in
    KERNELS order (B7's forward and backward are two wrappers)."""
    from mas_tpu_torch.ops import (attention, decode_attention, decode_cache,
                                   gn_swish, layer_norm, ln_producer, quant,
                                   vq)

    return {"B1": (attention.flash_attention,),
            "B2": (quant.decode_attention_quant,),
            "B3": (decode_cache.write_quant_kv,),
            "B4": (gn_swish.gn_swish,), "B5": (vq.vq_argmin,),
            "B6": (attention.flash_attention_bwd,),
            "B7": (layer_norm.layer_norm_fwd, layer_norm.layer_norm_bwd),
            "B8": (gn_swish.gn_swish_bwd,),
            "B9": (decode_attention.decode_attention_float,),
            "B10": (decode_cache.write_packed_kv,),
            "B11": (ln_producer.add_stats,)}


def reset_counts() -> None:
    for fns in wrappers().values():
        for fn in fns:
            fn.launches = 0


def read_counts() -> dict:
    """Launches since ``reset_counts``, per kernel id."""
    return {k: sum(fn.launches for fn in fns)
            for k, fns in wrappers().items()}


def phase_kernels(gen) -> list:
    rows = []
    for kid, name, route, source, replaces, check in KERNELS:
        res = check(gen)
        lib = res["library_ms"]
        print(f"{name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f}"
              f" ms, library {'none' if lib is None else f'{lib:.4f} ms'}, "
              f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
        rows.append(dict(id=kid, name=name, route=route, source=source,
                         replaces=replaces, **res))
    return rows


# --- phase 4: the main path at full width -----------------------------------

def load_pipeline(raw, gen):
    """Transformer and VQ-IMG as ``mas_tpu_torch.cli.run_sample`` loads
    them, and the prompts' tokens on the card."""
    from mas_tpu_torch.cli import load_transformer, load_vq, prompt_tokens
    from mas_tpu_torch.utils.config import TransformerConfig, VQModelConfig

    tcfg = TransformerConfig.from_dict(raw["transformer"])
    vcfg = VQModelConfig.from_dict(raw["model"])
    transformer = load_transformer(tcfg, raw.get("transformer_checkpoint"),
                                   "cuda", gen)
    vq = load_vq(vcfg, raw.get("vq_checkpoint"), "cuda", gen)
    text, seg = prompt_tokens(raw, tcfg, raw["train"]["batch_size"])
    return transformer, vq, torch.from_numpy(text).cuda(), \
        torch.from_numpy(seg).cuda()


def run_slice(raw, transformer, vq, text, seg, seed: int):
    from mas_tpu_torch.models.sampler import sample_images

    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = sample_images(transformer, vq, text, seg, gen,
                         guidance_scale=raw["guidance_scale"],
                         temperature=raw["temperature"], top_k=raw["top_k"])
    torch.cuda.synchronize()
    return imgs, time.perf_counter() - t0


def count_gns(module) -> int:
    from mas_tpu_torch.models.layers import GroupNormSwish

    return sum(isinstance(m, GroupNormSwish) for m in module.modules())


def phase_slice(gen) -> dict:
    """The serving path; returns its launch count per kernel."""
    with open(CONFIG) as f:
        raw = json.load(f)
    transformer, vq, text, seg = load_pipeline(raw, gen)
    cfg = transformer.cfg
    n_gns = count_gns(vq.decoder)
    reset_counts()
    imgs, secs = run_slice(raw, transformer, vq, text, seg, seed=1)
    counts = read_counts()
    print(f"slice: images {tuple(imgs.shape)} in {secs:.2f} s (first run, "
          f"includes kernel JIT); launches {counts}")
    require(tuple(imgs.shape) == (4, 256, 256, 3), f"image shape "
            f"{tuple(imgs.shape)}")
    require(bool(torch.isfinite(imgs).all()), "images are finite")
    steps = cfg.image_length - 1
    floors = {"B1": cfg.num_layers, "B2": cfg.num_layers * steps,
              "B3": cfg.num_layers * steps, "B4": n_gns}
    for kid, floor in floors.items():
        require(counts[kid] >= floor, f"{kid} launched {counts[kid]} times "
                f"on the serving path, expected >= {floor}")

    teacher_forced_check(transformer, text, seg, gen)

    _, secs4 = run_slice(raw, transformer, vq, text, seg, seed=2)
    print(f"e2e batch 4: {secs4:.3f} s, {4 / secs4:.3f} img/s")
    rep = 16
    _, secs64 = run_slice(raw, transformer, vq, text.repeat(rep, 1),
                          seg.repeat(rep, 1), seed=3)
    print(f"e2e batch 64: {secs64:.3f} s, {64 / secs64:.3f} img/s")
    return counts


def teacher_forced_check(transformer, text, seg, gen, steps: int = 16,
                         margin_ulps: int = 0):
    """Prefill + ``steps`` decode steps over the same forced tokens, once
    through the kernels and once through the plain twins on the card (bf16
    model; every decode kernel is patched, whichever cache the model
    allocates).  Tolerance: the two differ only inside attention and the
    cache write, by bf16 rounding of the attention output (2^-8 relative),
    which 24 bf16 layers carry on: max |d logit| <= 0.1 * max |logit| and
    top-1 agreement >= 90%.  With ``margin_ulps`` the top-1 agreement
    counts only the positions whose twin logits put the top choice more
    than that many bf16 ulps of max |logit| above the second: a model
    trained for a few steps has near-uniform logits (loss ~ ln 8192), and
    bf16 rounding then flips near-ties, not decisions."""
    from mas_tpu_torch.ops import (attention, decode_attention, decode_cache,
                                   quant)

    cfg = transformer.cfg
    text2 = torch.cat([text, torch.zeros_like(text)])
    seg2 = torch.cat([seg, seg])
    forced = torch.randint(0, cfg.image_vocab_size, (text2.shape[0], steps),
                           device="cuda", generator=gen)

    def run():
        with torch.inference_mode():
            logits, kvs = transformer.prefill(text2, seg2)
            caches = transformer.allocate_caches(kvs, text2.shape[0])
            out = [logits]
            for step in range(steps):
                out.append(transformer.decode_step(
                    forced[:, step:step + 1], step, caches))
            return torch.stack(out, dim=1)

    kern = run()
    with ExitStack() as stack:
        for mod, name, plain in (
                (attention, "flash_attention",
                 attention.prefix_causal_attention_plain),
                (quant, "decode_attention_quant",
                 quant.decode_attention_quant_plain),
                (decode_cache, "write_quant_kv",
                 decode_cache.write_quant_kv_plain),
                (decode_cache, "write_packed_kv",
                 decode_cache.write_packed_kv_plain),
                (decode_attention, "decode_attention_float",
                 decode_attention.decode_attention_float_plain)):
            stack.enter_context(mock.patch.object(mod, name, plain))
        ref = run()
    diff = (kern - ref).abs()
    scale = float(ref.abs().max())
    margin = margin_ulps * 2.0 ** (math.floor(math.log2(scale)) - 7)
    best = ref.topk(2, dim=-1).values
    decided = ((best[..., 0] - best[..., 1]) > margin) | (margin_ulps == 0)
    same = (kern.argmax(-1) == ref.argmax(-1))[decided]
    top1 = float(same.float().mean())
    print(f"teacher-forced ({steps} steps, {text2.shape[0]} rows): max |d| "
          f"{float(diff.max()):.4e}, mean |d| {float(diff.mean()):.4e}, "
          f"max |logit| {scale:.4e}, top-1 agreement {top1:.4f} over the "
          f"{same.numel()} of {decided.numel()} positions with a twin "
          f"margin above {margin:.4g}")
    require(same.numel() > 0, "teacher-forced: some position is decided")
    require(float(diff.max()) <= 0.1 * scale, "teacher-forced logits close")
    require(top1 >= 0.9, "teacher-forced top-1 agreement >= 90%")


# --- phase 5: VQ-SEG training at full width ---------------------------------

def seg_training_configs(tmp: str):
    """configs/seg_256.json as it is, with two overrides in memory:
    codebook.init_steps 4 and samples_per_image 256, so 16 micro-steps run
    pass-through (counter < 12), reservoir collection (counter > 4: 4,096
    rows by counter 12), k-means re-inits at 12, 14 and 16, quantization
    through B5 from 12 and five optimizer updates (accumulate_grad 3)."""
    from mas_tpu_torch.utils.config import (SegLossConfig, TrainConfig,
                                            VQModelConfig)

    with open(SEG_CONFIG) as f:
        raw = json.load(f)
    model = dict(raw["model"])
    model["codebook"] = dict(model["codebook"], init_steps=4,
                             samples_per_image=256)
    train = dict(raw["train"], total_steps=TRAIN_STEPS,
                 checkpoint_dir=os.path.join(tmp, "checkpoints"))
    return (TrainConfig.from_dict(train), VQModelConfig.from_dict(model),
            SegLossConfig.from_dict(raw["loss"]), raw["data"])


def phase_train(smi: str) -> dict:
    """16 micro-steps of seg_256 training through ``run_pretrain_
    segmentation`` with B4, B5 and B8; returns the launch counts."""
    from mas_tpu_torch.data.dataset import SyntheticSegBatches
    from mas_tpu_torch.train.loop import (build_seg_state,
                                          run_pretrain_segmentation)
    from mas_tpu_torch.utils.logging import Logger

    with tempfile.TemporaryDirectory() as tmp:
        train_cfg, model_cfg, loss_cfg, data = seg_training_configs(tmp)
        cb = model_cfg.codebook
        source = iter(SyntheticSegBatches(train_cfg.batch_size,
                                          data["resolution"],
                                          data.get("seed", 0)))
        batches = [{"mask": torch.from_numpy(next(source)["mask"]).to(DEVICE)}
                   for _ in range(TRAIN_STEPS)]
        record, snap = [], {}

        def on_step(step_no, state, metrics):
            torch.cuda.synchronize()
            counter = state.vq_state.counter
            trig = metrics["kmeans_triggered"]
            record.append(dict(t=time.perf_counter(), counter=counter,
                               loss=float(metrics["loss"]), trig=trig,
                               filled=state.vq_state.filled))
            if trig:
                require(torch.equal(state.model.quantize.embedding.weight,
                                    metrics["centroids"]),
                        f"codebook != k-means centroids after counter "
                        f"{counter}")
            if counter == cb.q_init:
                snap["state"] = copy.deepcopy(state)

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run_pretrain_segmentation(
            train_cfg, model_cfg, batches, loss_cfg, DEVICE,
            logger=Logger(os.path.join(tmp, "logs")), on_step=on_step)
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"train: {TRAIN_STEPS} micro-steps in "
              f"{time.perf_counter() - t0:.2f} s (first run, includes "
              f"kernel JIT); launches {counts}")

        losses = [r["loss"] for r in record]
        print("train losses: " + " ".join(f"{v:.5f}" for v in losses))
        require(len(record) == TRAIN_STEPS and state.step == TRAIN_STEPS,
                f"ran {len(record)} micro-steps")
        require(all(math.isfinite(v) for v in losses), "losses are finite")
        fired = [r["counter"] for r in record if r["trig"]]
        require(fired == [12, 14, 16], f"k-means fired at {fired}")
        require(record[11]["filled"] == 4096,
                f"reservoir rows at counter 12: {record[11]['filled']}")
        require(state.opt.count == TRAIN_STEPS // 3, "optimizer updates")
        n_gns = count_gns(state.model)
        quantizing = sum(r["counter"] >= cb.q_init for r in record)
        floors = {"B4": n_gns * TRAIN_STEPS, "B5": quantizing,
                  "B8": n_gns * TRAIN_STEPS}
        for name, floor in floors.items():
            require(counts[name] >= floor, f"{name} launched "
                    f"{counts[name]} times in training, expected >= {floor}")

        step_ms = {r["counter"]: 1e3 * (r["t"] - prev["t"])
                   for prev, r in zip(record, record[1:])}
        quant = sorted(step_ms[c] for c in (13, 15))
        print(f"train micro-step, quantize phase (counters 13, 15): median "
              f"{statistics.median(quant):.1f} ms; k-means micro-step "
              f"(counters 14, 16): {step_ms[14]:.1f} / {step_ms[16]:.1f} ms;"
              f" pass-through (counters 6-11) median "
              f"{statistics.median(step_ms[c] for c in range(6, 12)):.1f} "
              f"ms [{smi}]")

        resume_check(train_cfg, model_cfg, state)
        kmeans_repeat_check(state, cb)
        kernels_vs_twins_step(snap["state"], batches[TRAIN_STEPS // 2],
                              loss_cfg)
    return counts


def resume_check(train_cfg, model_cfg, state) -> None:
    """The checkpoint written at the end resumes bitwise."""
    from mas_tpu_torch.train.loop import build_seg_state

    resumed = build_seg_state(dataclasses.replace(train_cfg, resume=True),
                              model_cfg, DEVICE)
    require(resumed.step == state.step
            and resumed.vq_state.counter == state.vq_state.counter
            and resumed.vq_state.filled == state.vq_state.filled
            and torch.equal(resumed.vq_state.reservoir,
                            state.vq_state.reservoir), "resume: codebook")
    for k, v in state.model.state_dict().items():
        require(torch.equal(resumed.model.state_dict()[k], v),
                f"resume: model {k}")
    a, b = resumed.opt.state_dict(), state.opt.state_dict()
    require((a["count"], a["mini_step"]) == (b["count"], b["mini_step"]),
            "resume: optimizer counters")
    for part in ("mu", "nu", "acc"):
        for k, v in b[part].items():
            require(torch.equal(a[part][k], v), f"resume: {part} {k}")
    print(f"resume: step {resumed.step}, counter "
          f"{resumed.vq_state.counter}, filled {resumed.vq_state.filled}: "
          "bitwise equal")


def kmeans_repeat_check(state, cb) -> None:
    """One Lloyd iteration over the final reservoir, twice from one init.
    The assignments are equal (one deterministic matmul and argmin), but
    ``index_add_`` sums each cluster with atomics in a varying order, so
    the centroids are held to fp32 rounding (atol 1e-5, rtol 1e-5), not
    to bitwise equality."""
    from mas_tpu_torch.ops import kmeans

    res, n = state.vq_state.reservoir, state.vq_state.filled
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    init = kmeans.kmeans_init(res, gen, cb.codebook_size, n)
    a, b = (kmeans.lloyd(res, init, 1, n) for _ in range(2))
    torch.cuda.synchronize()
    require(close(a, b, 1e-5, 1e-5), f"k-means repeat: max |d| "
            f"{max_err(a, b)}")
    print(f"k-means repeat over {n} rows: max |d| {max_err(a, b):.3e}, "
          f"bitwise equal: {torch.equal(a, b)}")


def kernels_vs_twins_step(state, batch, loss_cfg) -> None:
    """One micro-step at counter 13 (quantize phase, no k-means) from two
    copies of the state after micro-step 12, once through B4/B5/B8 and
    once with their plain twins patched in.  Tolerances: fp32 summation
    order differs inside every GroupNorm forward and backward and is
    carried through the dozens of conv layers of encoder and decoder, so
    the loss agrees to rel 1e-4 and every parameter gradient to max |d| <=
    1e-3 * max |g| of its tensor, or 1e-6 * the largest gradient of the
    model for a tensor whose gradient is zero up to rounding (the conv
    bias ahead of the BN).  The kernel's indices obey the B5 rule on its
    own latents, and >= 99% equal the twins' (the latents themselves differ
    by that rounding).  A row whose index differs moves its share of the
    codebook gradient from one code to another, so the codebook rows of
    such codes are left out of its gradient comparison."""
    from mas_tpu_torch.ops import gn_swish, vq
    from mas_tpu_torch.train.steps import seg_loss_and_grads

    def run(st):
        gen = torch.Generator(device=DEVICE).manual_seed(13)
        st.model.train()
        return seg_loss_and_grads(st.model, st.vq_state, batch["mask"], gen,
                                  loss_cfg)

    loss, aux, grads = run(copy.deepcopy(state))
    with ExitStack() as stack:
        for mod, name, plain in (
                (gn_swish, "gn_swish", gn_swish.gn_swish_plain),
                (gn_swish, "gn_swish_bwd", gn_swish.gn_swish_bwd_plain),
                (vq, "vq_argmin", vq.vq_argmin_plain)):
            stack.enter_context(mock.patch.object(mod, name, plain))
        ploss, paux, pgrads = run(copy.deepcopy(state))
    torch.cuda.synchronize()
    require(aux["vq_state"].counter == 13 and not aux["kmeans_triggered"],
            "kernels-vs-twins step runs at counter 13")
    rel = abs(float(loss) - float(ploss)) / abs(float(ploss))
    emb = state.model.quantize.embedding.weight
    z = aux["latent"].reshape(-1, emb.shape[1])
    idx, pidx = aux["indices"].reshape(-1), paux["indices"].reshape(-1)
    own = vq.vq_argmin_plain(z, emb)
    require(vq.argmin_agrees(z, emb, idx, own),
            f"kernel indices vs the twin on the kernel's latents "
            f"({int((idx != own).sum())} of {len(own)} rows differ)")
    agree = float((idx == pidx).float().mean())
    flipped = idx != pidx
    moved = torch.cat([idx[flipped], pidx[flipped]]).long()
    top = max(float(g.abs().max()) for g in pgrads)
    worst, bad = 0.0, []
    names = [n for n, _ in state.model.named_parameters()]
    for name, g, pg in zip(names, grads, pgrads):
        if name == "quantize.embedding.weight" and len(moved):
            keep = torch.ones(len(g), dtype=torch.bool, device=g.device)
            keep[moved] = False
            g, pg = g[keep], pg[keep]
        d = float((g - pg).abs().max())
        bound = max(1e-3 * float(pg.abs().max()), 1e-6 * top)
        worst = max(worst, d / bound)
        if d > bound:
            bad.append(f"{name}: max |d| {d:.3e} > {bound:.3e}")
    print(f"kernels vs twins, one micro-step at counter 13: loss "
          f"{float(loss)!r} vs {float(ploss)!r} (rel {rel:.2e}), index "
          f"agreement {agree:.4f} ({int(flipped.sum())} rows), worst "
          f"gradient |d| / bound {worst:.3f}")
    require(not bad, "kernels-vs-twins gradients: " + "; ".join(bad))
    require(rel <= 1e-4, "kernels-vs-twins loss")
    require(agree >= 0.99, "kernels-vs-twins indices")


# --- phase 6: tokenization at img_512 width ---------------------------------

def phase_tokenize(gen, smi: str) -> dict:
    """``encode_tokens`` of the img_512 model (bf16, K = 8192, seeded
    random weights) on 8 random 512^2 images; returns the launch counts.
    The random codebook (U(-1/K, 1/K)) would make every distance a near-tie,
    so the codebook is first set to the 8192 latents of another batch, as
    the k-means re-init places a trained codebook among the latents; the
    tokens are then held to the B5 agreement rule against the plain twin
    on the same latents."""
    from mas_tpu_torch.cli import load_vq
    from mas_tpu_torch.ops import vq as vq_ops
    from mas_tpu_torch.utils.config import VQModelConfig

    with open(IMG_CONFIG) as f:
        cfg = VQModelConfig.from_dict(json.load(f)["model"])
    model = load_vq(cfg, None, DEVICE, gen)
    shape = (8, cfg.resolution, cfg.resolution, 3)
    with torch.no_grad():
        book = model.encode_latent(torch.rand(*shape, device=DEVICE,
                                              generator=gen))
        model.quantize.embedding.weight.copy_(
            book.reshape(-1, cfg.embed_dim)[:cfg.codebook.codebook_size])
    x = torch.rand(*shape, device=DEVICE, generator=gen)
    reset_counts()
    with torch.inference_mode():
        tokens = model.encode_tokens(x)
        torch.cuda.synchronize()
        counts = read_counts()
        z = model.encode_latent(x).reshape(-1, cfg.embed_dim)
        emb = model.quantize.embedding.weight.to(z.dtype)
        plain = vq_ops.vq_argmin_plain(z, emb)
        ms = timed_ms(lambda: model.encode_tokens(x), reps=10)
    side = cfg.latent_resolution
    agree = float((tokens.reshape(-1) == plain).float().mean())
    require(tuple(tokens.shape) == (8, side, side), f"token shape "
            f"{tuple(tokens.shape)}")
    require(not tokens.is_floating_point()
            and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.codebook.codebook_size,
            "tokens are integer codebook indices")
    require(vq_ops.argmin_agrees(z, emb, tokens.reshape(-1), plain),
            f"tokens vs the plain twin on the same latents (agreement "
            f"{agree:.5f})")
    require(counts["B5"] >= 1, f"B5 launched {counts['B5']} times in "
            "tokenization")
    require(counts["B4"] >= count_gns(model.encoder),
            f"B4 launched {counts['B4']} times in tokenization")
    print(f"tokenize: 8 x {cfg.resolution}^2 -> {tuple(tokens.shape)}, "
          f"{len(torch.unique(tokens))} distinct codes, agreement with the "
          f"twin {agree:.5f}; {ms:.2f} ms per batch (device, CUDA events); "
          f"launches {counts} [{smi}]")
    return counts


# --- phase 7: transformer training at full width ----------------------------

def transformer_configs(tmp: str, **train_overrides):
    """configs/transformer_512.json as shipped (24 layers, hidden 1024, 16
    heads, T = 1408, batch 8, bf16, remat 'mlp', Adam lr 4.5e-6, betas
    0.9/0.95), with its checkpoints under ``tmp``."""
    from mas_tpu_torch.utils.config import TrainConfig, TransformerConfig

    with open(TRANSFORMER_CONFIG) as f:
        raw = json.load(f)
    train = dict(raw["train"], checkpoint_dir=os.path.join(tmp, "ckpt"),
                 **train_overrides)
    return (TrainConfig.from_dict(train),
            TransformerConfig.from_dict(raw["transformer"]), raw["data"])


def phase_train_transformer(smi: str, tmp: str):
    """``run_train_transformer`` at full width: 8 steps as configured, then
    2 resumed steps with ``layernorm_impl: "pallas"`` (B7) and uncond_p 1.0
    from step 9.  Checks finite losses, fp32 parameters, a finite nonzero
    gradient for every parameter at step 1 (Adam's first moment after one
    update is 0.1 g), moved parameters, the CFG dropout schedule, the exact
    B1/B6/B7 launch counts, one step through the kernels against the plain
    twins, and a bitwise resume; returns the launch counts and the final
    checkpoint's path (checkpoints go under ``tmp``)."""
    from mas_tpu_torch.data.dataset import SyntheticTokenBatches
    from mas_tpu_torch.train.loop import (build_transformer_state,
                                          run_train_transformer)
    from mas_tpu_torch.utils.checkpoint import checkpoint_path
    from mas_tpu_torch.utils.logging import Logger

    steps_a, steps_b = TRANSFORMER_STEPS, 2
    train_cfg, tcfg, data = transformer_configs(
        tmp, total_steps=steps_a)
    source = iter(SyntheticTokenBatches(train_cfg.batch_size, tcfg,
                                        data.get("seed", 0)))
    batches = [{k: torch.from_numpy(v).to(DEVICE)
                for k, v in next(source).items()}
               for _ in range(steps_a + steps_b)]
    init = build_transformer_state(train_cfg, tcfg, DEVICE)
    before = {k: v.clone() for k, v in init.model.state_dict().items()}
    del init
    record = []

    def on_step(step_no, state, metrics):
        torch.cuda.synchronize()
        record.append(dict(t=time.perf_counter(), step=step_no,
                           loss=float(metrics["loss"]),
                           uncond=bool(metrics["uncond"])))
        if step_no == 1:
            first_step_checks(state, before)

    logger = Logger(os.path.join(tmp, "logs"))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run_train_transformer(train_cfg, tcfg, batches[:steps_a],
                                  DEVICE, logger, on_step)
    torch.cuda.synchronize()
    counts_a = read_counts()
    secs_a = time.perf_counter() - t0

    ln_cfg = dataclasses.replace(tcfg, layernorm_impl="pallas")
    train_b = dataclasses.replace(train_cfg, total_steps=steps_a + steps_b,
                                  resume=True, uncond_p=1.0,
                                  start_uncond=steps_a + 1)
    reset_counts()
    state = run_train_transformer(train_b, ln_cfg, batches[steps_a:],
                                  DEVICE, logger, on_step)
    torch.cuda.synchronize()
    counts_b = read_counts()
    print(f"train_transformer: {steps_a} steps in {secs_a:.2f} s (first "
          f"run); launches {counts_a}, then {steps_b} steps with B7: "
          f"{counts_b}")

    losses = [r["loss"] for r in record]
    print("train_transformer losses: "
          + " ".join(f"{v:.5f}" for v in losses))
    require(len(record) == steps_a + steps_b
            and state.step == steps_a + steps_b,
            f"ran {len(record)} steps, state at {state.step}")
    require(all(math.isfinite(v) for v in losses), "losses are finite")
    require(all(p.dtype == torch.float32
                for p in state.model.parameters()), "fp32 parameters")
    uncond = [r["uncond"] for r in record[steps_a:]]
    require(uncond == [False, True],
            f"uncond with uncond_p 1.0 from step {steps_a + 1}: {uncond}")
    n_layers, n_ln = tcfg.num_layers, 4 * tcfg.num_layers + 2
    want_a = dict(B1=n_layers * steps_a, B6=n_layers * steps_a, B7=0)
    want_b = dict(B1=n_layers * steps_b, B6=n_layers * steps_b,
                  B7=2 * n_ln * steps_b)
    for want, got, what in ((want_a, counts_a, "as configured"),
                            (want_b, counts_b, "with B7")):
        for kid, n in want.items():
            require(got[kid] == n, f"{kid} launched {got[kid]} times in "
                    f"transformer training {what}, expected {n}")
        require(all(got[k] == 0 for k in ("B2", "B3", "B4", "B5", "B8")),
                f"serving or VQ kernels launched in transformer training:"
                f" {got}")

    step_ms = [1e3 * (r["t"] - prev["t"])
               for prev, r in zip(record, record[1:])]
    tokens = train_cfg.batch_size * tcfg.total_length
    steady = statistics.median(step_ms[1:steps_a - 1])
    print(f"train_transformer step (steps 3-{steps_a}, host clock, "
          f"synchronized): median {steady:.1f} ms, {tokens / steady * 1e3:.0f}"
          f" tokens/s; with B7 (step {steps_a + 2}): {step_ms[-1]:.1f} ms"
          f" [{smi}]")

    transformer_resume_check(train_b, ln_cfg, state)
    transformer_kernels_vs_twins(state, batches[-1])
    return ({k: counts_a[k] + counts_b[k] for k in counts_a},
            checkpoint_path(train_cfg.checkpoint_dir, steps_a + steps_b))


def first_step_checks(state, before) -> None:
    """After step 1: every parameter moved and got a finite, nonzero
    gradient (Adam's first moment is 0.1 g), every layer's qkv weight
    included (the attention Function passes the gradient through B6)."""
    bad = []
    for name, p in state.model.named_parameters():
        mu = state.opt.mu[name]
        if not bool(torch.isfinite(mu).all()) or float(mu.abs().max()) == 0:
            bad.append(f"{name}: gradient zero or not finite")
        if torch.equal(p, before[name]):
            bad.append(f"{name}: unchanged after step 1")
    require(not bad, "after step 1: " + "; ".join(bad))
    qkv = [f"transformer.layers.{i}.attn.qkv.weight"
           for i in range(state.model.cfg.num_layers)]
    require(all(name in state.opt.mu for name in qkv), "qkv weights in Adam")
    print(f"step 1: all {len(before)} parameters moved with finite nonzero "
          f"gradients, qkv weight gradient max |g| per layer from "
          f"{min(float(state.opt.mu[n].abs().max()) * 10 for n in qkv):.3e}"
          f" to {max(float(state.opt.mu[n].abs().max()) * 10 for n in qkv):.3e}")


def transformer_resume_check(train_cfg, tcfg, state) -> None:
    """The checkpoint written at the end resumes bitwise."""
    from mas_tpu_torch.train.loop import build_transformer_state

    resumed = build_transformer_state(train_cfg, tcfg, DEVICE)
    require(resumed.step == state.step, f"resume: step {resumed.step}")
    for k, v in state.model.state_dict().items():
        require(torch.equal(resumed.model.state_dict()[k], v),
                f"resume: model {k}")
    a, b = resumed.opt.state_dict(), state.opt.state_dict()
    require((a["count"], a["mini_step"]) == (b["count"], b["mini_step"]),
            "resume: optimizer counters")
    for part in ("mu", "nu", "acc"):
        for k, v in b[part].items():
            require(torch.equal(a[part][k], v), f"resume: {part} {k}")
    print(f"resume: step {resumed.step}, model and Adam state bitwise equal")


def transformer_kernels_vs_twins(state, batch) -> None:
    """One loss and gradient of the bf16 model with B7 LayerNorms, once
    through B1/B6/B7 and once with their plain twins patched in, from the
    same weights and tokens.  The two differ only where a kernel and its
    twin round an fp32 value to bf16 in another place or sum in another
    order, which 24 bf16 layers carry on.  Bounds (PERF.md): loss within
    rel 1e-2; each gradient tensor within 0.1 of its norm
    (||g - g_twin|| <= 0.1 ||g_twin||)."""
    from mas_tpu_torch.ops import attention
    from mas_tpu_torch.ops import layer_norm as ln
    from mas_tpu_torch.train.steps import transformer_loss_and_grads

    args = (batch["text"], batch["seg"], batch["image"])
    loss, grads = transformer_loss_and_grads(state.model, *args)
    with ExitStack() as stack:
        for mod, name, plain in (
                (attention, "flash_attention",
                 attention.prefix_causal_attention_plain),
                (attention, "flash_attention_bwd",
                 lambda *a: torch.stack(
                     [g.transpose(1, 2) for g in
                      attention.prefix_causal_attention_bwd_plain(*a)],
                     dim=2)),
                (ln, "layer_norm_fwd", ln.layer_norm_fwd_plain),
                (ln, "layer_norm_bwd", ln.layer_norm_bwd_plain)):
            stack.enter_context(mock.patch.object(mod, name, plain))
        ploss, pgrads = transformer_loss_and_grads(state.model, *args)
    torch.cuda.synchronize()
    rel = abs(float(loss) - float(ploss)) / abs(float(ploss))
    worst, bad = 0.0, []
    names = [n for n, _ in state.model.named_parameters()]
    for name, g, pg in zip(names, grads, pgrads):
        r = float((g - pg).norm()) / max(float(pg.norm()), 1e-30)
        worst = max(worst, r)
        if r > 0.1:
            bad.append(f"{name}: {r:.3e}")
    print(f"kernels vs twins, one step (bf16, B7 LayerNorms): loss "
          f"{float(loss)!r} vs {float(ploss)!r} (rel {rel:.2e}), worst "
          f"gradient ||d|| / ||g|| {worst:.3e}")
    require(rel <= 1e-2, "kernels-vs-twins loss")
    require(not bad, "kernels-vs-twins gradients: " + "; ".join(bad))


# --- phase 8: 512^2 serving over the float cache ----------------------------

def sample_512_raw(transformer_checkpoint=None) -> dict:
    """The 512^2 serving config, as README shows it: the sampling keys of
    configs/sample_256.json (guidance 3.0, top-k 64, its four captions),
    the ``transformer`` section of configs/transformer_512.json as it is
    (its ``kv_cache_dtype`` is the default "compute": a float cache) and
    the ``model`` section of configs/img_512.json."""
    with open(CONFIG) as f:
        raw = json.load(f)
    with open(TRANSFORMER_CONFIG) as f:
        raw["transformer"] = json.load(f)["transformer"]
    with open(IMG_CONFIG) as f:
        raw["model"] = json.load(f)["model"]
    raw["transformer_checkpoint"] = transformer_checkpoint
    raw["output"] = "samples_512.jpg"
    return raw


def phase_serve_512(gen, smi: str, checkpoint: str) -> dict:
    """512^2 sampling over the float cache with the transformer that phase
    7 trained; returns the launch counts of one batch-4 run."""
    from mas_tpu_torch.ops.decode_attention import FloatCache

    raw = sample_512_raw(checkpoint)
    transformer, vq, text, seg = load_pipeline(raw, gen)
    cfg = transformer.cfg
    require(cfg.kv_cache_dtype == "compute" and cfg.total_length == 1408,
            f"512^2 config: cache {cfg.kv_cache_dtype}, T {cfg.total_length}")
    with torch.inference_mode():          # the VQ decoder's Triton JIT
        vq.decode_code(torch.zeros(1, cfg.image_tokens_per_dim,
                                   cfg.image_tokens_per_dim, dtype=torch.long,
                                   device="cuda"))
    reset_counts()
    imgs, secs4 = run_slice(raw, transformer, vq, text, seg, seed=21)
    counts = read_counts()
    print(f"serve 512^2 (float cache, trained checkpoint): images "
          f"{tuple(imgs.shape)}; launches {counts}")
    require(tuple(imgs.shape) == (4, 512, 512, 3), f"image shape "
            f"{tuple(imgs.shape)}")
    require(bool(torch.isfinite(imgs).all()), "images are finite")
    steps = cfg.image_length - 1
    want = {"B1": cfg.num_layers, "B9": cfg.num_layers * steps, "B2": 0,
            "B3": 0, "B10": 0}
    for kid, n in want.items():
        require(counts[kid] == n, f"{kid} launched {counts[kid]} times on "
                f"the 512^2 float-cache path, expected {n}")
    require(counts["B4"] >= count_gns(vq.decoder),
            f"B4 launched {counts['B4']} times in the VQ decoder")

    with torch.inference_mode():
        _, kvs = transformer.prefill(text[:1], seg[:1])
        cache = transformer.allocate_caches(kvs, 1)[0][0]
    require(isinstance(cache, FloatCache)
            and cache.data.dtype == torch.bfloat16
            and tuple(cache.data.shape) == (1, 16, 1408, 64),
            "the float cache is bf16 [B, 16, 1408, 64]")
    teacher_forced_check(transformer, text, seg, gen, margin_ulps=4)

    print(f"e2e 512^2 batch 4: {secs4:.3f} s, {4 / secs4:.4f} img/s "
          f"(first run at this shape) [{smi}]")
    rep = 16
    _, secs64 = run_slice(raw, transformer, vq, text.repeat(rep, 1),
                          seg.repeat(rep, 1), seed=22)
    print(f"e2e 512^2 batch 64: {secs64:.3f} s, {64 / secs64:.4f} img/s "
          f"[{smi}]")
    return counts


# --- phase 9: 256^2 serving over the packed cache ---------------------------

def phase_packed(gen, smi: str) -> dict:
    """configs/sample_256.json with ``kv_cache_layout: "packed"`` (int4) at
    batch 4: exact launch counts, then greedy (top_k 1) tokens of the packed
    and the lane cache on the same weights must be equal — the same
    quantization (B10 and B3 store the same bits) read by the same B2
    arithmetic.  Returns the launch counts of the sampling run."""
    from mas_tpu_torch.models.sampler import sample_tokens
    from mas_tpu_torch.models.transformer import MakeAScene
    from mas_tpu_torch.utils.config import TransformerConfig

    with open(CONFIG) as f:
        raw = json.load(f)
    raw["transformer"] = dict(raw["transformer"], kv_cache_layout="packed")
    packed, vq, text, seg = load_pipeline(raw, gen)
    cfg = packed.cfg
    reset_counts()
    imgs, secs = run_slice(raw, packed, vq, text, seg, seed=31)
    counts = read_counts()
    print(f"serve 256^2 packed int4: images {tuple(imgs.shape)} in "
          f"{secs:.2f} s; launches {counts}")
    require(tuple(imgs.shape) == (4, 256, 256, 3)
            and bool(torch.isfinite(imgs).all()), "packed: images")
    steps = cfg.image_length - 1
    want = {"B1": cfg.num_layers, "B10": cfg.num_layers * steps,
            "B2": cfg.num_layers * steps, "B3": 0, "B9": 0}
    for kid, n in want.items():
        require(counts[kid] == n, f"{kid} launched {counts[kid]} times on "
                f"the packed path, expected {n}")

    lane_cfg = TransformerConfig.from_dict(
        dict(raw["transformer"], kv_cache_layout="lane"))
    with torch.device("cuda"):
        lane = MakeAScene(lane_cfg).eval()
    lane.load_state_dict(packed.state_dict())
    toks, secs = [], []
    for model in (packed, lane, packed, lane):
        g = torch.Generator(device="cuda").manual_seed(32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks.append(sample_tokens(model, text, seg, g, guidance_scale=3.0,
                                  top_k=1))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    agree = float((toks[0] == toks[1]).float().mean())
    print(f"packed vs lane, greedy, batch 4: token agreement {agree:.6f}; "
          f"sample_tokens {secs[2]:.3f} s packed, {secs[3]:.3f} s lane "
          f"({1e3 * secs[2] / steps:.2f} / {1e3 * secs[3] / steps:.2f} ms per "
          f"decode step, host clock, prefill included) [{smi}]")
    require(torch.equal(toks[0], toks[1]) and torch.equal(toks[0], toks[2]),
            "packed and lane caches give equal greedy tokens")
    return counts


# --- phase 10: the producer-fused LayerNorm harness -------------------------

LN_CHAIN = 20


def phase_ln_producer(gen, smi: str) -> dict:
    """``benchmarks/ln_producer.py`` at its shape: y = x + LN(a + b) @ W,
    the plain path (``add_ln_plain``) against the producer path (B11 for
    x and the stats, then ``normalize_with``), forward alone and forward +
    backward (gradient w.r.t. a, the producer's backward recomputing the
    plain add_ln), each chained ``LN_CHAIN`` times with the output fed
    back as a.  Parity first, as the harness: x bitwise, LN within 3e-2.
    Returns the launch counts of the timed chains."""
    from mas_tpu_torch.ops import ln_producer as lp

    a, b = (torch.randn(LN_ROWS, LN_D, device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    g = 1.0 + 0.1 * torch.randn(LN_D, device="cuda", generator=gen)
    beta = 0.1 * torch.randn(LN_D, device="cuda", generator=gen)
    w = (torch.randn(LN_D, LN_D, device="cuda", generator=gen) * 0.02
         ).to(torch.bfloat16)
    with torch.no_grad():
        xp, yp = lp.AddLNProducerFunction.apply(a, b, g, beta)
        xj, yj = lp.add_ln_plain(a, b, g, beta)
    ex, ey = max_err(xp, xj), max_err(yp, yj)
    print(f"ln_producer parity: x {ex:.2e}  ln {ey:.2e}")
    require(ex == 0.0 and ey < 3e-2, "ln_producer parity")

    def plain(a_, b_, g_, beta_, w_):
        x_, t = lp.add_ln_plain(a_, b_, g_, beta_)
        return x_ + (t @ w_).to(x_.dtype)

    def producer(a_, b_, g_, beta_, w_):
        x_, t = lp.AddLNProducerFunction.apply(a_, b_, g_, beta_)
        return x_ + (t @ w_).to(x_.dtype)

    def chain(fn, grad):
        carry = a
        for _ in range(LN_CHAIN):
            if grad:
                leaf = carry.detach().requires_grad_()
                out = fn(leaf, b, g, beta, w)
                carry = torch.autograd.grad(out.float().sum(), leaf)[0]
            else:
                with torch.no_grad():
                    carry = fn(carry, b, g, beta, w)
        return carry

    reset_counts()
    ms = {}
    for grad in (False, True):
        for name, fn in (("plain", plain), ("producer", producer)):
            ms[(grad, name)] = timed_ms(lambda: chain(fn, grad), reps=5,
                                        warmup=1) / LN_CHAIN
    torch.cuda.synchronize()
    counts = read_counts()
    fj, fp, gj, gp = (ms[(False, "plain")], ms[(False, "producer")],
                      ms[(True, "plain")], ms[(True, "producer")])
    print(f"ln_producer [{LN_ROWS}x{LN_D}] bf16, x{LN_CHAIN} chained, ms per "
          f"step (CUDA events, median of 5): fwd plain {fj:.4f}, fwd "
          f"producer {fp:.4f}, fwd+bwd plain {gj:.4f}, fwd+bwd producer "
          f"{gp:.4f}; fwd delta {100 * (fj - fp) / fj:+.1f}%, fwd+bwd delta "
          f"{100 * (gj - gp) / gj:+.1f}% (positive = producer wins) [{smi}]")
    n = 2 * (1 + 5) * LN_CHAIN
    require(counts["B11"] == n, f"B11 launched {counts['B11']} times in the "
            f"harness, expected {n}")
    return counts


def main() -> int:
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [phase_slice(gen), phase_train(smi), phase_tokenize(gen, smi)]
        counts, checkpoint = phase_train_transformer(smi, tmp)
        paths += [counts, phase_serve_512(gen, smi, checkpoint)]
    paths += [phase_packed(gen, smi), phase_ln_producer(gen, smi)]
    for row in rows:
        row["launches"] = sum(counts[row["id"]] for counts in paths)
        require(row["launches"] > 0, f"{row['id']} launched on no path")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
