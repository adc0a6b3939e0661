"""Serving traffic over LFM2-8B-A1B's hybrid block: ``serve.py``'s closed
loop of ``sample_images`` calls, prompts, judged rows and checks, with
the program built from the configuration's ``block`` section
(``MakeAScene(..., block=...)``) and its plain reference
``reference/lfm2_moe.py``.

Weights are drawn tensor by tensor from one generator on the device
(``make``), in the spec's order, so the 8.3B parameters never sit in one
fp32 draw; the program holds the "dense" tensors in bf16 and the rest in
fp32, and the reference, after ``harness.release``, the same bf16 values
in fp32 (the served model is its bf16 checkpoint).

``correct`` (limits in ``workloads/<cell>.json``): ``token_err`` and
``image_rel_err`` as ``serve.py`` has them.  Routing in bf16 may choose
another expert than the fp32 reference where two biased scores lie
within rounding of each other, and one such choice moves a position's
logits as a fault would.  So after the window the program teacher-forces
the judged batch again, eagerly (the decode body outside its graph: the
same kernels on the same values, bitwise equal to the replay), and the
experts its router chose at each position of the judged rows are logged.
The reference runs with those experts (``reference/lfm2_moe.py``):
``logit_err`` is the largest, over the judged positions, L2 distance of
the served guided logits from the reference's, over the reference's
spread about its mean; ``route_gap`` the largest, over MoE layers, of the
layer's mean over the judged rows' expert choices (cond and uncond half,
position) of a choice's deficit: by how much the least biased score of
the experts chosen falls short of the reference's own k-th largest (0
where the choice is the reference's).  A mean within a layer and not
the largest deficit: a sound bf16 router differs from the fp32 one in a
tenth of its choices, by rounding that reaches a few hundredths at the
tail, while a router that drops the bias or takes the runner-up set
falls short in most choices.  The largest layer and not the mean over
layers: a fault in one layer's router is not diluted by the others.
``logit_err`` cannot see a routing fault by design, since the reference
takes the program's own choices; ``route_gap`` is what sees it.
"""

from __future__ import annotations

import dataclasses
import time
from unittest import mock

import numpy as np
import torch

from mas_tpu_torch.models import hybrid, sampler
from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.models.vqvae import VQModel
from mas_tpu_torch.utils.config import (HybridBlockConfig, TransformerConfig,
                                        VQModelConfig)
from mas_tpu_torch.ops import moe

from .. import counts, harness, trace, weights
from ..marks import wrap
from ..reference import lfm2_moe as ref_h
from ..reference import precision
from ..reference import vqvae as ref_v
from . import serve

B12_KERNELS = "moe_swiglu_"


def geometry(cfg: dict) -> ref_h.Geometry:
    return ref_h.Geometry.of(cfg["transformer"], cfg["block"])


def make(spec, seed: int, device, into=None, dense=torch.bfloat16):
    """The spec's tensors drawn one after another from one generator on
    ``device``: copied into ``into`` (a state dict) where given, else
    returned in fp32, the "dense" ones rounded to ``dense`` first."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    with torch.no_grad():
        for name, shape, mean, std, role in spec:
            t = torch.randn(shape, generator=gen, device=device) * std + mean
            if into is not None:
                into[name].copy_(t)
            else:
                out[name] = t.to(dense).float() if role == "dense" else t
    return out


def build(run: harness.Run):
    cfg = run.cell.config
    tcfg = TransformerConfig.from_dict(cfg["transformer"])
    block = HybridBlockConfig.from_dict(cfg["block"])
    vcfg = VQModelConfig.from_dict(cfg["model"])
    with torch.device(run.device):
        transformer = MakeAScene(tcfg, block=block).eval()
        vq = VQModel(vcfg).eval()
    make(ref_h.param_spec(geometry(cfg)),
         run.sub_seed(harness.TRANSFORMER_WEIGHTS), run.device,
         into=transformer.state_dict())
    vw = weights.make(ref_v.param_spec(cfg["model"]),
                      run.sub_seed(harness.VQ_WEIGHTS), run.device,
                      {"conv": serve.DTYPES[vcfg.compute_dtype],
                       "fp32": torch.float32})
    got = vq.load_state_dict(vw, strict=False)
    unused = [k for k in got.missing_keys
              if not k.startswith(("encoder.", "quant_conv."))]
    if got.unexpected_keys or unused:
        raise RuntimeError(f"VQ weights do not fit the program: missing "
                           f"{unused}, unexpected {got.unexpected_keys}")
    return transformer, vq


# --- operations and bounds ---------------------------------------------------

def _token_flops(g: ref_h.Geometry, experts: bool = True) -> float:
    """Linear operations of one token through every layer, the active
    experts only (``experts``: the MoE layers' experts counted)."""
    d, hd = g.hidden, g.head_dim
    total = 0.0
    for i, kind in enumerate(g.layer_types):
        if kind == "conv":
            total += 2.0 * d * 4 * d
        else:
            total += 2.0 * d * (2 * g.heads + 2 * g.kv_heads) * hd
        if i < g.dense_layers:
            total += 2.0 * 3 * d * g.dense_width
        else:
            total += 2.0 * d * g.experts + (
                2.0 * 3 * d * g.expert_width * g.top_k if experts else 0.0)
    return total


def batch_flops(g: ref_h.Geometry, m: dict, prompts: int) -> float:
    """One guided ``sample_images`` batch: prefill, decode loop, VQ
    decode; attention over the pairs each row attends, in the attention
    layers."""
    rows, steps = 2 * prompts, g.image_length - 1
    attn = sum(1 for k in g.layer_types if k != "conv")
    per_pair = 4.0 * g.heads * g.head_dim * attn
    prefill = rows * (g.prefix * _token_flops(g) + per_pair * g.prefix ** 2
                      + 2.0 * g.hidden * g.image_vocab)
    positions = steps * (g.prefix + 1) + steps * (steps - 1) // 2
    decode = rows * (steps * (_token_flops(g) + 2.0 * g.hidden
                              * g.image_vocab) + per_pair * positions)
    return prefill + decode + counts.vq_decode_flops(m, prompts)


def b2_grouped_bound_s(rows: int, heads: int, kv_heads: int, d: int,
                       index: int, bits: int) -> float:
    """B2 over a grouped cache: each kv head's int4 values and fp32
    scales at positions <= index read once for its query heads; q and out
    bf16."""
    positions = index + 1
    nbytes = (rows * kv_heads * positions * 2 * (d * bits // 8 + 4)
              + rows * heads * 2 * d * 2)
    return counts.bound_s(4.0 * rows * heads * d * positions, nbytes)


def b12_bound_s(g: ref_h.Geometry, routed: torch.Tensor) -> float:
    """B12's bound summed over the calls the counters [layers, 2, E + 3]
    hold, phase by phase: operations 6 D F a pair; bytes the W1, W3, W2 of
    every expert with a pair in a call, and each pair's row in (bf16) and
    out (fp32).  Within a phase every call is bound by the same term (the
    prefill's chunks by operations, the decode steps by bytes), so a
    phase's sum is the larger of its summed operations and bytes."""
    e, d, f = g.experts, g.hidden, g.expert_width
    total = 0.0
    for phase in range(2):
        pairs = float(routed[:, phase, :e].sum())
        active = float(routed[:, phase, e].sum())
        nbytes = active * 3 * d * f * 2 + pairs * d * (2 + 4)
        total += counts.bound_s(6.0 * d * f * pairs, nbytes)
    return total


def expert_load(g: ref_h.Geometry, routed: torch.Tensor):
    """The decode steps' busiest expert over the mean pairs an expert,
    averaged over MoE layers: Σ_steps max / Σ_steps mean, the mean (pairs
    / E) the same at every step."""
    e = g.experts
    pairs = routed[:, 1, :e].sum(1).double()
    if float(pairs.min()) <= 0:
        return None
    return float((routed[:, 1, e + 2].double() * e / pairs).mean())


def _record(fn, device):
    """``trace.record`` that also keeps B12's device seconds, by kernel
    name (the frozen kernel table predates B12)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = trace._events(prof)
    b12 = sum(e - s for name, on_dev, s, e in events
              if on_dev and B12_KERNELS in name) / 1e6
    return trace.summarize(events, window), b12


# --- the run -----------------------------------------------------------------

def run(run: harness.Run) -> dict:
    cfg, tr = run.cell.config, run.cell.traffic
    g = geometry(cfg)
    harness.log("imported")
    transformer, vq = build(run)
    text, seg = serve.prompts(run)
    harness.sync(run.device)
    if run.device.type == "cuda":
        # the fp32 parameters before their cast are set-up, not serving
        torch.cuda.reset_peak_memory_stats(run.device)
    harness.log("built")
    gen = torch.Generator(device=run.device).manual_seed(
        run.sub_seed(harness.SAMPLER))
    guidance, top_k = cfg["guidance_scale"], cfg["top_k"]
    kw = dict(guidance_scale=guidance, temperature=cfg["temperature"])

    def greedy(k):
        return k % tr["greedy_every"] == 0

    sampler.sample_images(transformer, vq, text[0], seg[0], gen, top_k=top_k,
                          **kw)
    sampler._sample_logits(torch.zeros(tr["batch"], g.image_vocab,
                                       device=run.device), gen, 1.0, 1)
    harness.sync(run.device)
    harness.log("warmed up")

    grids = []
    wrap(vq, "decode_code", before=lambda idx: grids.append(idx))
    judged = serve.judged_rows(run)
    both = torch.tensor(judged + [tr["batch"] + r for r in judged],
                        device=run.device)
    kept = []

    def keep(out):
        if kept:
            kept[-1].append((out[0] if isinstance(out, tuple) else out)[both])

    wrap(transformer, "prefill", after=keep)
    wrap(transformer, "decode_step", after=keep)
    stamps = []
    if run.trace:
        marks = serve._layer_marks(run, transformer, vq, stamps)
    n_batches = text.shape[0]
    served = []

    def batch(k):
        grids.clear()
        if greedy(k):
            kept.append([])
        imgs = sampler.sample_images(
            transformer, vq, text[k % n_batches], seg[k % n_batches], gen,
            top_k=1 if greedy(k) else top_k, **kw)
        host = imgs.cpu()
        if greedy(k):
            toks = torch.cat(grids).reshape(host.shape[0], -1)
            served.append((k % n_batches, toks, host[judged],
                           torch.stack(kept.pop(), dim=1)))

    t0 = time.perf_counter()
    ends = []
    k = 0
    while True:
        batch(k)
        k += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= run.seconds:
            break
    timed = ends[-1]
    harness.log("batch ends, s: " + " ".join(f"{e:.3f}" for e in ends))
    images = k * tr["batch"]
    obs = {"timed_s": timed, "unit_s": timed / k,
           "flops": k * batch_flops(g, cfg["model"], tr["batch"])}
    if run.trace:
        obs["layers"] = serve._layer_ms(marks, stamps, g.image_length - 1)
        rows = 2 * tr["batch"]
        before = transformer.routed_pairs().cpu()
        if run.device.type == "cuda":
            obs["slice"], b12_s = _record(lambda: batch(k), run.device)
        else:
            _, obs["slice"] = trace.record(lambda: batch(k), run.device)
            b12_s = 0.0
        routed = transformer.routed_pairs().cpu() - before
        obs["slice_units"] = 1
        bits = {"int4": 4, "int8": 8}[cfg["transformer"]["kv_cache_dtype"]]
        attn = sum(1 for kind in g.layer_types if kind != "conv")
        obs["bounds"] = {"B2": [
            b2_grouped_bound_s(rows, g.heads, g.kv_heads, g.head_dim,
                               g.prefix + s, bits)
            for s in range(g.image_length - 1) for _ in range(attn)]}
        obs["b12"] = {"bound_s": b12_bound_s(g, routed), "device_s": b12_s}
        obs["expert_load"] = expert_load(g, routed)
    peak = harness.memory_peak(run.device)
    rng = np.random.default_rng(run.sub_seed(harness.CHECK) + 1)
    b, full, imgs, lg = served[int(rng.integers(len(served)))]
    routes = teacher_forced(transformer, text[b], seg[b], full, judged)[1]
    del transformer, vq, grids
    harness.release(run.device)
    n = len(judged)
    toks = full[judged]
    picked = (text[b, judged].cpu(), seg[b, judged].cpu(), toks)
    program = serve.guided(lg[:n], lg[n:], guidance)
    checks = dict(check(run, picked, program, routes, imgs.to(run.device)),
                  token_err=max(serve.token_err(x[:n], x[n:], t[judged],
                                                guidance)
                                for _, t, _, x in served))
    return {"t0": t0, "attempted": images, "failed": 0,
            "e2e": {"images_per_s": images / timed},
            "checks": checks, "memory_peak_bytes": peak, "obs": obs,
            "control": lambda: control(run, picked),
            "faults": dict({"token_altered": lambda: dict(
                token_err=serve.token_err(
                    lg[:n], lg[n:], serve.runner_up(lg[:n], lg[n:], guidance),
                    guidance))}, **{
                name: (lambda plant=plant: faulted(run, picked, plant))
                for name, plant in FAULTS.items()})}


# --- the check ---------------------------------------------------------------

def teacher_forced(transformer, text, seg, tokens, rows):
    """The guided batch of prompts (text, seg) and served ``tokens`` [B,
    n] teacher-forced through the program again, eagerly: (the logits
    [2 len(rows), n, vocab] of the cond then the uncond ``rows``, the
    experts the router chose for them [2, len(rows), prefix + n - 1, MoE
    layers, k])."""
    b = text.shape[0]
    both = list(rows) + [b + r for r in rows]
    calls = []
    inner = moe.route

    def route(*args):
        idx, w = inner(*args)
        calls.append(idx)
        return idx, w

    pos = torch.zeros(1, dtype=torch.int32, device=text.device)
    with mock.patch.object(moe, "route", route), torch.inference_mode():
        first, seeds = transformer.prefill(torch.cat([text, 0 * text]),
                                           torch.cat([seg, seg]))
        in_prefill = len(calls)
        caches = transformer.allocate_caches(seeds, 2 * b)
        del seeds
        out = [first[both]]
        for step in range(tokens.shape[1] - 1):
            pos.fill_(step)
            out.append(transformer.decode_body(
                tokens[:, step:step + 1].repeat(2, 1), pos, caches)[both])
    layers = len(transformer.transformer.moe_layers())
    k = calls[0].shape[-1]
    prefix = torch.cat(calls[:in_prefill]).view(layers, 2 * b, -1, k)
    steps = torch.stack(calls[in_prefill:]).view(-1, layers, 2 * b, k)
    routes = torch.cat([prefix[:, both].permute(1, 2, 0, 3),
                        steps[:, :, both].permute(2, 0, 1, 3)], dim=1)
    return (torch.stack(out, dim=1).float(),
            routes.view(2, len(rows), *routes.shape[1:]))


def references(run, picked, rounding, routes=None):
    """The reference's guided logits [n, image_length, vocab], the experts
    it took [2, n, T, MoE layers, k] (``routes``, or its own), their
    deficits [2, n, T, MoE layers] and the images of the judged requests,
    in ``rounding``."""
    cfg = run.cell.config
    g = geometry(cfg)
    dev = run.device
    precision.fp32_only()
    tw = make(ref_h.param_spec(g), run.sub_seed(harness.TRANSFORMER_WEIGHTS),
              dev)
    vw = weights.make(ref_v.param_spec(cfg["model"]),
                      run.sub_seed(harness.VQ_WEIGHTS), dev,
                      {"conv": torch.float32, "fp32": torch.float32})
    r = precision.by_name(rounding)
    txt, sg, toks = (x.to(dev) for x in picked)
    logits, chosen, deficits = [], [], []
    with torch.no_grad():
        for i in range(toks.shape[0]):
            lg, idx, deficit = ref_h.serve_logits(
                tw, g, txt[i:i + 1], sg[i:i + 1], toks[i:i + 1],
                cfg["guidance_scale"], r,
                None if routes is None else routes[:, i:i + 1])
            logits.append(lg)
            chosen.append(idx)
            deficits.append(deficit)
        side = g.image_side
        images = ref_v.decode_code(vw, cfg["model"],
                                   toks.reshape(-1, side, side), r)
    return (torch.cat(logits), torch.cat(chosen, dim=1),
            torch.cat(deficits, dim=1), images)


def route_gap(what: str, deficits) -> float:
    """The largest, over MoE layers, of a layer's mean deficit (deficits
    [2, n, T, MoE layers]); how often a choice is not the reference's own,
    the mean over all layers and the largest deficit, on standard
    error."""
    d = deficits > 0
    layers = deficits.flatten(0, -2).mean(0)
    harness.log(f"{what}: {int(d.sum())} of {d.numel()} expert choices "
                f"(half, prompt, position, MoE layer) differ from the "
                f"reference's own; positions with one {int(d.any(-1).sum())}"
                f" of {d[..., 0].numel()}; deficit mean "
                f"{float(deficits.mean())!r}, largest "
                f"{float(deficits.max())!r}; layer means "
                f"{[round(float(v), 6) for v in layers]}")
    return float(layers.max())


def check(run: harness.Run, picked, program, routes, images) -> dict:
    ref, _, deficits, ref_images = references(run, picked, "exact", routes)
    return {"logit_err": serve._logit_err(program, ref),
            "route_gap": route_gap("program", deficits),
            "image_rel_err": serve._rel(images, ref_images)}


def control(run: harness.Run, picked) -> dict:
    """The reference in fp8 in the program's place, on the same prompts
    and served tokens, its own experts taken as the program's are."""
    low, routes, _, low_images = references(run, picked, "fp8")
    ref, _, deficits, ref_images = references(run, picked, "exact", routes)
    return {"logit_err": serve._logit_err(low, ref),
            "route_gap": route_gap("fp8 control", deficits),
            "image_rel_err": serve._rel(low_images, ref_images)}


# --- planted faults -------------------------------------------------------

def _bias_dropped():
    """The router chooses by the sigmoid scores alone."""
    inner = moe.route
    return mock.patch.object(moe, "route", lambda lg, bias, *a: inner(
        lg, None, *a))


def _unnormalized():
    """The chosen experts' weights are the raw scores."""
    inner = moe.route
    return mock.patch.object(moe, "route", lambda lg, bias, k, norm, scale:
                             inner(lg, bias, k, False, scale))


def _runner_up_set():
    """The k-th chosen expert replaced by the (k+1)-th, weighted as the
    router weights its set: the nearest wrong choice."""
    def route(logits, bias, k, normalize, scale):
        s = logits.float().sigmoid()
        top = (s + bias.float()).topk(k + 1, dim=-1).indices
        idx = torch.cat([top[:, :k - 1], top[:, k:]], dim=1)
        w = s.gather(1, idx)
        if normalize:
            w = w / (w.sum(-1, keepdim=True) + moe.EPS)
        return idx, w * scale
    return mock.patch.object(moe, "route", route)


def _conv_state_frozen():
    """A conv layer's decode step writes its v into a copy of the state:
    the state is never advanced."""
    inner = hybrid.ShortConv.decode

    def frozen(self, h, state, index):
        return inner(self, h, hybrid.ConvState(state.data.clone()), index)

    return mock.patch.object(hybrid.ShortConv, "decode", frozen)


def _bias_dropped_in_one_layer():
    """The second MoE layer's router (in call order) alone chooses by the
    sigmoid scores: a fault that a mean over all layers would dilute."""
    inner, seen = hybrid.MoE._routed, {}

    def routed(self, g, phase):
        if seen.setdefault(id(self), len(seen)) != 1:
            return inner(self, g, phase)
        with mock.patch.object(self, "block", dataclasses.replace(
                self.block, use_expert_bias=False)):
            return inner(self, g, phase)

    return mock.patch.object(hybrid.MoE, "_routed", routed)


FAULTS = {"bias_dropped": _bias_dropped, "unnormalized": _unnormalized,
          "bias_dropped_in_one_layer": _bias_dropped_in_one_layer,
          "runner_up_set": _runner_up_set,
          "conv_state_frozen": _conv_state_frozen}


def faulted(run: harness.Run, picked, plant) -> dict:
    """``logit_err`` and ``route_gap`` of the program with the fault
    ``plant()`` planted, teacher-forced on the judged prompts and their
    served tokens."""
    cfg = run.cell.config
    transformer, vq = build(run)
    del vq
    txt, sg, toks = (x.to(run.device) for x in picked)
    n = txt.shape[0]
    with plant():
        lg, routes = teacher_forced(transformer, txt, sg, toks, range(n))
    program = serve.guided(lg[:n], lg[n:], cfg["guidance_scale"])
    del transformer
    harness.release(run.device)
    ref, _, deficits, _ = references(run, picked, "exact", routes)
    return {"logit_err": serve._logit_err(program, ref),
            "route_gap": route_gap("fault", deficits)}
