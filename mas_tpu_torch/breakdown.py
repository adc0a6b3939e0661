"""Where the serving slice spends its time on the GPU.

    python -m mas_tpu_torch.breakdown [--config configs/sample_256.json]
                                      [--batch 4 64]

For each batch size (prompts; guidance doubles the decode rows): prefill
plus cache seeding, the decode step on the host clock, the device-busy
time of decode steps from ``torch.profiler`` (sum of kernel times) and the
idle share it leaves, the kernels that take the most device time, and the
VQ decode of all images.  Seeded random weights; one warm-up run of the
whole path first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .cli import load_transformer, load_vq, prompt_tokens
from .models.sampler import sample_images
from .utils.config import TransformerConfig, VQModelConfig


def _decode_profile(transformer, caches, tok, first_step: int, steps: int):
    """(host ms per step without the profiler, device-busy ms per step from
    a profiled run of as many steps, top kernels by device time)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(first_step, first_step + steps):
        transformer.decode_step(tok, step, caches)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / steps
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for step in range(first_step + steps, first_step + 2 * steps):
            transformer.decode_step(tok, step, caches)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return host, busy, [(e.key[:60], e.self_device_time_total / 1e3 / steps,
                         e.count // steps) for e in top]


def breakdown(transformer, vq, text, seg, batch: int) -> dict:
    reps = -(-batch // text.shape[0])
    t = text.repeat(reps, 1)[:batch]
    s = seg.repeat(reps, 1)[:batch]
    cfg = transformer.cfg
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, kvs = transformer.prefill(torch.cat([t, torch.zeros_like(t)]),
                                          torch.cat([s, s]))
        caches = transformer.allocate_caches(kvs, 2 * batch)
        del kvs
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok = logits.argmax(-1, keepdim=True)
        for step in range(8):                   # warm the step
            transformer.decode_step(tok, step, caches)
        host, busy, top = _decode_profile(transformer, caches, tok, 8, 16)
        grid = torch.randint(0, vq.cfg.codebook.codebook_size,
                             (batch, cfg.image_tokens_per_dim,
                              cfg.image_tokens_per_dim), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, batch, 32):
            vq.decode_code(grid[i:i + 32])
        torch.cuda.synchronize()
        vq_ms = (time.perf_counter() - t0) * 1e3
    return {"batch": batch, "prefill_and_cache_seed_ms": prefill_ms,
            "decode_step_host_ms": host, "decode_step_device_busy_ms": busy,
            "decode_device_idle_share": max(0.0, 1.0 - busy / host),
            "decode_top_kernels_ms_per_step": top, "vq_decode_ms": vq_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="configs/sample_256.json")
    ap.add_argument("--batch", type=int, nargs="+", default=[4, 64])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("breakdown needs a CUDA device")
    with open(args.config) as f:
        raw = json.load(f)
    tcfg = TransformerConfig.from_dict(raw["transformer"])
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    transformer = load_transformer(tcfg, raw.get("transformer_checkpoint"),
                                   "cuda", gen)
    vq = load_vq(VQModelConfig.from_dict(raw["model"]),
                 raw.get("vq_checkpoint"), "cuda", gen)
    text, seg = (torch.from_numpy(a).cuda()
                 for a in prompt_tokens(raw, tcfg, 4))
    sample_images(transformer, vq, text, seg, gen,             # warm-up
                  guidance_scale=raw.get("guidance_scale", 3.0),
                  top_k=raw.get("top_k", 0))
    for batch in args.batch:
        print(json.dumps(breakdown(transformer, vq, text, seg, batch)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
