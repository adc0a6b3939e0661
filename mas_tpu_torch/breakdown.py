"""Where the port's paths spend their time on the GPU.

    python -m mas_tpu_torch.breakdown [--config configs/sample_256.json]
                                      [--batch 4 64]
    python -m mas_tpu_torch.breakdown --path train
                                      [--config configs/seg_256.json]
    python -m mas_tpu_torch.breakdown --path tokenize
                                      [--config configs/img_512.json]

``serve`` (default), for each batch size (prompts; guidance doubles the
decode rows): prefill plus cache seeding, the decode step on the host
clock, the device-busy time of decode steps from ``torch.profiler`` (sum
of kernel times) and the idle share it leaves, the kernels that take the
most device time, and the VQ decode of all images.

``train``: the VQ-SEG micro-step in the quantize phase (counter past
q_re_end, so no k-means), with cuDNN TF32 off (as ``chip_smoke.py`` runs
it) and on (PyTorch's default for convolutions), then the k-means re-init
over a full reservoir, alone and as part of its micro-step.

``tokenize``: ``encode_tokens`` of a batch of random images.

Seeded random weights; warm-up runs first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .cli import load_transformer, load_vq, prompt_tokens
from .models.sampler import sample_images
from .utils.config import TransformerConfig, VQModelConfig


def _profile(fn, steps: int):
    """(host ms per call without the profiler, device-busy ms per call
    from a profiled run of as many calls, top kernels by device time as
    (name, ms per call, launches per call))."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / steps
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"host_ms": host, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / host),
            "top_kernels_ms_per_call": [
                (e.key[:70], e.self_device_time_total / 1e3 / steps,
                 e.count // steps) for e in top]}


def train_breakdown(raw, gen, steps: int = 4) -> list:
    from .data.dataset import SyntheticSegBatches
    from .ops.kmeans import kmeans
    from .train.state import create_vq_train_state
    from .train.steps import make_seg_train_step
    from .utils.config import TrainConfig

    train_cfg = TrainConfig.from_dict(raw["train"])
    model_cfg = VQModelConfig.from_dict(raw["model"])
    cb = model_cfg.codebook
    state = create_vq_train_state(model_cfg, train_cfg.optimizer, gen,
                                  "cuda", rescale_lr=False)
    step = make_seg_train_step(state.model, state.opt)
    seg = torch.from_numpy(next(iter(SyntheticSegBatches(
        train_cfg.batch_size, model_cfg.resolution)))["mask"]).cuda()
    state.vq_state.counter = cb.q_re_end
    rows = []
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        for _ in range(2):
            step(state, seg, gen)
        rows.append({"what": f"seg micro-step, quantize phase, cudnn tf32 "
                     f"{'on' if tf32 else 'off'}",
                     **_profile(lambda: step(state, seg, gen), steps)})
    torch.backends.cudnn.allow_tf32 = False
    res = state.vq_state.reservoir
    res.normal_(generator=gen)
    state.vq_state.filled = cb.reservoir_size
    rows.append({"what": f"k-means alone: {cb.kmeans_iters} Lloyd iterations"
                 f" over {cb.reservoir_size} rows, K={cb.codebook_size}",
                 **_profile(lambda: kmeans(res, gen, cb.codebook_size,
                                           cb.kmeans_iters,
                                           n_valid=cb.reservoir_size), 2)})

    def kmeans_step():
        state.vq_state.counter = cb.q_init - 1
        step(state, seg, gen)

    rows.append({"what": "seg micro-step with the k-means re-init, full "
                 "reservoir, cudnn tf32 off", **_profile(kmeans_step, 2)})
    return rows


def tokenize_breakdown(raw, gen, batch: int = 8, steps: int = 4) -> dict:
    cfg = VQModelConfig.from_dict(raw["model"])
    vq = load_vq(cfg, None, "cuda", gen)
    x = torch.rand(batch, cfg.resolution, cfg.resolution, cfg.in_channels,
                   device="cuda", generator=gen)
    with torch.inference_mode():
        for _ in range(2):
            vq.encode_tokens(x)
        return {"what": f"encode_tokens, {batch} x {cfg.resolution}^2, "
                f"{cfg.compute_dtype}",
                **_profile(lambda: vq.encode_tokens(x), steps)}


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
    ap.add_argument("--path", choices=("serve", "train", "tokenize"),
                    default="serve")
    ap.add_argument("--config", default=None,
                    help="default: configs/sample_256.json, seg_256.json or "
                    "img_512.json by --path")
    ap.add_argument("--batch", type=int, nargs="+", default=[4, 64])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("breakdown needs a CUDA device")
    config = args.config or {"serve": "configs/sample_256.json",
                             "train": "configs/seg_256.json",
                             "tokenize": "configs/img_512.json"}[args.path]
    with open(config) as f:
        raw = json.load(f)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.path == "train":
        for row in train_breakdown(raw, gen):
            print(json.dumps(row))
        return 0
    if args.path == "tokenize":
        print(json.dumps(tokenize_breakdown(raw, gen)))
        return 0
    tcfg = TransformerConfig.from_dict(raw["transformer"])
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
