"""Where the port's paths spend their time on the GPU.

    python -m mas_tpu_torch.breakdown [--config configs/sample_256.json]
                                      [--batch 4 64]
    python -m mas_tpu_torch.breakdown --path train
                                      [--config configs/seg_256.json]
    python -m mas_tpu_torch.breakdown --path tokenize
                                      [--config configs/img_512.json]
    python -m mas_tpu_torch.breakdown --path train_transformer
                                      [--config configs/transformer_512.json]

``serve`` (default), for each batch size (prompts; guidance doubles the
decode rows): prefill plus cache seeding, the decode step on the host
clock, the device-busy time of decode steps from ``torch.profiler`` (sum
of kernel times) and the idle share it leaves, the kernels that take the
most device time, and the VQ decode of all images.  Decode steps are
profiled in two windows: from step 8, where the cache holds little more
than the prefix, and from the middle of the image, where a read covers
the prefix and half the image (at 512^2, ~900 of 1408 positions: the
average over a sample).  Any sampling config serves: the float cache of
a 512^2 config, e.g. README's, or ``kv_cache_layout: "packed"``.

``train``: the VQ-SEG micro-step in the quantize phase (counter past
q_re_end, so no k-means), with cuDNN TF32 off (as ``chip_smoke.py`` runs
it) and on (PyTorch's default for convolutions), then the k-means re-init
over a full reservoir, alone and as part of its micro-step.

``tokenize``: ``encode_tokens`` of a batch of random images.

``train_transformer``: the transformer train step (CFG dropout, loss,
backward, Adam) on one synthetic batch of the config's size, with the
config's ``layernorm_impl`` ("jnp": PyTorch's fused layer norm) and with
``"pallas"`` (kernel B7).

Every profile also sums the device time of the port's own kernels by id
(B1 ... B11), whether or not they are among the top kernels.

Seeded random weights; warm-up runs first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from .cli import load_transformer, load_vq, prompt_tokens
from .models.sampler import sample_images
from .utils.config import TransformerConfig, VQModelConfig


# substring of a device kernel's name -> the port's kernel id
_KERNEL_IDS = (("flash_fwd_kernel", "B1"), ("decode_quant_kernel", "B2"),
               ("kv_write_packed_kernel", "B10"),
               ("kv_write_lane_kernel", "B3"),
               ("gn_swish_bwd_kernel", "B8"), ("gn_swish_fwd_kernel", "B4"),
               ("vq_", "B5"), ("flash_bwd_", "B6"),
               ("layer_norm_fwd_kernel", "B7"),
               ("layer_norm_bwd_kernel", "B7"),
               ("decode_float_kernel", "B9"), ("_add_stats_kernel", "B11"))


def _kernel_id(name: str):
    return next((kid for sub, kid in _KERNEL_IDS if sub in name), None)


def _profile(fn, steps: int):
    """(host ms per call without the profiler, device-busy ms per call
    from a profiled run of as many calls, top kernels by device time as
    (name, ms per call, launches per call), and the port's kernels by id
    as [ms per call, launches per call])."""
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
    ported = {}
    for e in kernels:
        kid = _kernel_id(e.key)
        if kid is not None:
            ms, n = ported.get(kid, (0.0, 0))
            ported[kid] = [ms + e.self_device_time_total / 1e3 / steps,
                           n + e.count // steps]
    return {"host_ms": host, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / host),
            "top_kernels_ms_per_call": [
                (e.key[:70], e.self_device_time_total / 1e3 / steps,
                 e.count // steps) for e in top],
            "ported_kernels_ms_per_call": dict(sorted(ported.items()))}


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


def train_transformer_breakdown(raw, gen, steps: int = 3) -> list:
    from .data.dataset import SyntheticTokenBatches
    from .train.state import create_transformer_train_state
    from .train.steps import make_transformer_train_step
    from .utils.config import TrainConfig

    train_cfg = TrainConfig.from_dict(raw["train"])
    base = TransformerConfig.from_dict(raw["transformer"])
    batch = next(iter(SyntheticTokenBatches(train_cfg.batch_size, base)))
    args = [torch.from_numpy(batch[k]).cuda()
            for k in ("text", "seg", "image")]
    tokens = train_cfg.batch_size * base.total_length
    rows = []
    for impl in dict.fromkeys((base.layernorm_impl, "pallas")):
        cfg = dataclasses.replace(base, layernorm_impl=impl)
        state = create_transformer_train_state(cfg, train_cfg.optimizer, gen,
                                               "cuda")
        step = make_transformer_train_step(state.model, state.opt,
                                           train_cfg.uncond_p,
                                           train_cfg.start_uncond)
        for _ in range(2):                      # warm-up
            step(state, *args, gen)
        row = _profile(lambda: step(state, *args, gen), steps)
        rows.append({"what": f"transformer train step, batch "
                     f"{train_cfg.batch_size} x T {base.total_length}, "
                     f"{cfg.compute_dtype}, remat "
                     f"{cfg.remat_policy if cfg.remat else 'off'}, "
                     f"layernorm_impl {impl}",
                     "tokens_per_s": tokens / row["host_ms"] * 1e3, **row})
        del state, step
    return rows


def _decode_steps(transformer, caches, tok, first_step: int):
    """A call that runs the next decode step from ``first_step`` on."""
    steps = iter(range(first_step, transformer.cfg.image_length - 1))
    return lambda: transformer.decode_step(tok, next(steps), caches)


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
        mid = cfg.image_length // 2
        windows = {f"decode_steps_from_{first}": _profile(
            _decode_steps(transformer, caches, tok, first), 16)
            for first in (8, mid)}
        grid = torch.randint(0, vq.cfg.codebook.codebook_size,
                             (batch, cfg.image_tokens_per_dim,
                              cfg.image_tokens_per_dim), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, batch, 32):
            vq.decode_code(grid[i:i + 32])
        torch.cuda.synchronize()
        vq_ms = (time.perf_counter() - t0) * 1e3
    return {"batch": batch, "cache": f"{cfg.kv_cache_dtype} "
            f"{cfg.kv_cache_layout}", "prefill_and_cache_seed_ms": prefill_ms,
            **windows, "vq_decode_ms": vq_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=("serve", "train", "tokenize",
                                       "train_transformer"),
                    default="serve")
    ap.add_argument("--config", default=None,
                    help="default: configs/sample_256.json, seg_256.json, "
                    "img_512.json or transformer_512.json by --path")
    ap.add_argument("--batch", type=int, nargs="+", default=[4, 64])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("breakdown needs a CUDA device")
    config = args.config or {"serve": "configs/sample_256.json",
                             "train": "configs/seg_256.json",
                             "tokenize": "configs/img_512.json",
                             "train_transformer":
                                 "configs/transformer_512.json"}[args.path]
    with open(config) as f:
        raw = json.load(f)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.path == "train":
        for row in train_breakdown(raw, gen):
            print(json.dumps(row))
        return 0
    if args.path == "train_transformer":
        for row in train_transformer_breakdown(raw, gen):
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
