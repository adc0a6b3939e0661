"""Smoke run of the PyTorch port (``mas_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. print the card (nvidia-smi name and power limit) and the versions;
     no CUDA device is an error — there is no CPU path;
  2. build the CUDA kernels from ``mas_tpu_torch/csrc`` (nvcc, sm_90a);
  3. hold each hand-written kernel against its plain PyTorch twin on the
     card at the main path's shapes, and time both (CUDA events, median);
  4. run the main path at full width — ``configs/sample_256.json``
     (24 layers, hidden 1024, int4 cache, guidance 3.0, top-k 64), seeded
     random weights, its 4 captions — through ``sample_images``, check the
     images and that every kernel was launched on that path; then check
     teacher-forced logits through the kernels against the plain twins on
     the card, and print end-to-end img/s at batch 4 and 64.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "sample_256.json")


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
)


def wrappers():
    """The launch-counting wrapper of each kernel, in KERNELS order."""
    from mas_tpu_torch.ops import attention, decode_cache, gn_swish, quant

    return (attention.flash_attention, quant.decode_attention_quant,
            decode_cache.write_quant_kv, gn_swish.gn_swish)


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


def phase_slice(gen, rows: list) -> None:
    from mas_tpu_torch.models.layers import GroupNormSwish

    raw, transformer, vq, text, seg = load_slice(gen)
    cfg = transformer.cfg
    n_gns = sum(isinstance(m, GroupNormSwish) for m in vq.modules())
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
        row["launches"] = n

    teacher_forced_check(transformer, text, seg, gen)

    _, secs4 = run_slice(raw, transformer, vq, text, seg, seed=2)
    print(f"e2e batch 4: {secs4:.3f} s, {4 / secs4:.3f} img/s")
    rep = 16
    _, secs64 = run_slice(raw, transformer, vq, text.repeat(rep, 1),
                          seg.repeat(rep, 1), seed=3)
    print(f"e2e batch 64: {secs64:.3f} s, {64 / secs64:.3f} img/s")


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


def main() -> int:
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)
    phase_slice(gen, rows)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
