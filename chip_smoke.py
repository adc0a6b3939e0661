"""Smoke run of the PyTorch port (``mas_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. print the card (nvidia-smi name and power limit) and the versions;
     no CUDA device is an error — there is no CPU path;
  2. build the CUDA kernels from ``mas_tpu_torch/csrc`` (nvcc, sm_90a);
  3. hold each hand-written kernel against its plain PyTorch twin on the
     card at the main path's shapes, and time both (CUDA events, median);
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
     model (bf16, K = 8192) through ``encode_tokens``.
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

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "sample_256.json")
SEG_CONFIG = os.path.join(ROOT, "configs", "seg_256.json")
IMG_CONFIG = os.path.join(ROOT, "configs", "img_512.json")
TRAIN_STEPS = 16
DEVICE = "cuda"


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
    accumulate in fp32 and round to bf16 once: atol 1e-2, rtol 1e-2."""
    from mas_tpu_torch.ops import quant

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
    out["max_abs_err"] = err
    return out


def check_b5(gen) -> dict:
    """VQ argmin at (N=512, K=1024, D=256) fp32, the seg training shape,
    and (N=8192, K=8192, D=256) bf16 z and codebook, the img_512
    tokenization shape, against the plain twin.  Tolerance: the agreement
    rule of ``mas_tpu_torch/ops/vq.py`` (>= 99.9% equal indices; where
    they differ, the twin's distance of the kernel's choice within
    1e-5 * (||z||^2 + max ||e||^2) of the minimum), since the kernel sums
    each dot product in another order.  Exactly duplicated codebook rows
    must resolve to the first index.  max_abs_err is the largest such
    distance gap."""
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
                f"B5 ({n}, {k}, {dtype}): indices disagree beyond near-ties")
        dist = vq.vq_distances(z, cb)
        gap = max(gap, float((dist.gather(1, got.long()[:, None])[:, 0]
                              - dist.min(dim=1).values).max()))
        print(f"B5 ({n}, {k}, 256) {dtype}: agreement "
              f"{float((got == want).float().mean()):.6f}")
    # z and cb are the tokenization shape now: time both there
    out["ms"] = timed_ms(lambda: vq.vq_argmin(z, cb))
    out["plain_ms"] = timed_ms(lambda: vq.vq_argmin_plain(z, cb))
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
    out["max_abs_err"] = err
    return out


KERNELS = (
    # name, route, source, replaces, check
    ("B1 flash_attention (prefill)", "cuda", "mas_tpu_torch/csrc/flash_fwd.cu",
     "mas_tpu/ops/attention.py:117", check_b1),
    ("B2 decode_attention_quant", "cuda", "mas_tpu_torch/csrc/decode_quant.cu",
     "mas_tpu/ops/quant.py:187", check_b2),
    ("B3 write_quant_kv", "triton", "mas_tpu_torch/ops/decode_cache.py",
     "mas_tpu/ops/decode_cache.py:270", check_b3),
    ("B4 gn_swish", "triton", "mas_tpu_torch/ops/gn_swish.py",
     "mas_tpu/ops/pallas/gn_swish.py:50", check_b4),
    ("B5 vq_argmin", "cuda", "mas_tpu_torch/csrc/vq_argmin.cu",
     "mas_tpu/ops/vq.py:33", check_b5),
    ("B8 gn_swish_bwd", "triton", "mas_tpu_torch/ops/gn_swish.py",
     "mas_tpu/ops/pallas/gn_swish.py:117", check_b8),
)


def wrappers():
    """The launch-counting wrapper of each kernel, in KERNELS order."""
    from mas_tpu_torch.ops import attention, decode_cache, gn_swish, quant, vq

    return (attention.flash_attention, quant.decode_attention_quant,
            decode_cache.write_quant_kv, gn_swish.gn_swish, vq.vq_argmin,
            gn_swish.gn_swish_bwd)


def phase_kernels(gen) -> list:
    rows = []
    for name, route, source, replaces, check in KERNELS:
        res = check(gen)
        print(f"{name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f}"
              f" ms")
        rows.append(dict(name=name, route=route, source=source,
                         replaces=replaces, **res))
    return rows


# --- phase 4: the main path at full width -----------------------------------

def load_slice(gen):
    from mas_tpu_torch.cli import load_transformer, load_vq, prompt_tokens
    from mas_tpu_torch.utils.config import TransformerConfig, VQModelConfig

    with open(CONFIG) as f:
        raw = json.load(f)
    tcfg = TransformerConfig.from_dict(raw["transformer"])
    vcfg = VQModelConfig.from_dict(raw["model"])
    transformer = load_transformer(tcfg, None, "cuda", gen)
    vq = load_vq(vcfg, None, "cuda", gen)
    text, seg = prompt_tokens(raw, tcfg, raw["train"]["batch_size"])
    return raw, transformer, vq, torch.from_numpy(text).cuda(), \
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


def phase_slice(gen, rows: list) -> list:
    """The serving path; returns its launch count per kernel."""
    raw, transformer, vq, text, seg = load_slice(gen)
    cfg = transformer.cfg
    n_gns = count_gns(vq.decoder)
    fns = wrappers()
    for fn in fns:
        fn.launches = 0
    imgs, secs = run_slice(raw, transformer, vq, text, seg, seed=1)
    counts = [fn.launches for fn in fns]
    print(f"slice: images {tuple(imgs.shape)} in {secs:.2f} s (first run, "
          f"includes kernel JIT); launches {counts}")
    require(tuple(imgs.shape) == (4, 256, 256, 3), f"image shape "
            f"{tuple(imgs.shape)}")
    require(bool(torch.isfinite(imgs).all()), "images are finite")
    steps = cfg.image_length - 1
    floors = (cfg.num_layers, cfg.num_layers * steps,
              cfg.num_layers * steps, n_gns)
    for row, n, floor in zip(rows, counts, floors):
        require(n >= floor, f"{row['name']} launched {n} times on the main "
                f"path, expected >= {floor}")

    teacher_forced_check(transformer, text, seg, gen)

    _, secs4 = run_slice(raw, transformer, vq, text, seg, seed=2)
    print(f"e2e batch 4: {secs4:.3f} s, {4 / secs4:.3f} img/s")
    rep = 16
    _, secs64 = run_slice(raw, transformer, vq, text.repeat(rep, 1),
                          seg.repeat(rep, 1), seed=3)
    print(f"e2e batch 64: {secs64:.3f} s, {64 / secs64:.3f} img/s")
    return counts


def teacher_forced_check(transformer, text, seg, gen, steps: int = 16):
    """Prefill + ``steps`` decode steps over the same forced tokens, once
    through the kernels and once through the plain twins on the card (bf16
    model).  Tolerance: the two differ only inside attention and the cache
    write, by bf16 rounding of the attention output (2^-8 relative), which
    24 bf16 layers carry on: max |d logit| <= 0.1 * max |logit| and top-1
    agreement >= 90%."""
    from mas_tpu_torch.ops import attention, decode_cache, quant

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
                 decode_cache.write_quant_kv_plain)):
            stack.enter_context(mock.patch.object(mod, name, plain))
        ref = run()
    diff = (kern - ref).abs()
    scale = float(ref.abs().max())
    top1 = float((kern.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"teacher-forced ({steps} steps, {text2.shape[0]} rows): max |d| "
          f"{float(diff.max()):.4e}, mean |d| {float(diff.mean()):.4e}, "
          f"max |logit| {scale:.4e}, top-1 agreement {top1:.4f}")
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


def phase_train(smi: str) -> list:
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

        fns = wrappers()
        for fn in fns:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run_pretrain_segmentation(
            train_cfg, model_cfg, batches, loss_cfg, DEVICE,
            logger=Logger(os.path.join(tmp, "logs")), on_step=on_step)
        torch.cuda.synchronize()
        counts = [fn.launches for fn in fns]
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
        floors = dict(zip(("B4", "B5", "B8"), (n_gns * TRAIN_STEPS,
                                               quantizing,
                                               n_gns * TRAIN_STEPS)))
        for name, n in zip(("B4", "B5", "B8"), counts[3:]):
            require(n >= floors[name], f"{name} launched {n} times in "
                    f"training, expected >= {floors[name]}")

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
    require(vq.argmin_agrees(z, emb, idx, vq.vq_argmin_plain(z, emb)),
            "kernel indices vs the twin on the kernel's latents")
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

def phase_tokenize(gen, smi: str) -> list:
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
    fns = wrappers()
    for fn in fns:
        fn.launches = 0
    with torch.inference_mode():
        tokens = model.encode_tokens(x)
        torch.cuda.synchronize()
        counts = [fn.launches for fn in fns]
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
    require(counts[4] >= 1, f"B5 launched {counts[4]} times in tokenization")
    require(counts[3] >= count_gns(model.encoder),
            f"B4 launched {counts[3]} times in tokenization")
    print(f"tokenize: 8 x {cfg.resolution}^2 -> {tuple(tokens.shape)}, "
          f"{len(torch.unique(tokens))} distinct codes, agreement with the "
          f"twin {agree:.5f}; {ms:.2f} ms per batch (device, CUDA events); "
          f"launches {counts} [{smi}]")
    return counts


def main() -> int:
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)
    paths = (phase_slice(gen, rows), phase_train(smi),
             phase_tokenize(gen, smi))
    for i, row in enumerate(rows):
        row["launches"] = sum(counts[i] for counts in paths)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
