"""Serving traffic over Granite 4.0-H's hybrid block: ``serve.py``'s
closed loop of ``sample_images`` calls, prompts, judged rows and checks,
with the program built from the configuration's ``block`` section
(``MakeAScene(..., block=GraniteBlockConfig...)``) and its plain
reference ``reference/granite_hybrid.py``.

Weights are drawn tensor by tensor from one generator on the device
(``make``, ``granite_hybrid.draw``), in the spec's order, so the 7.95B
parameters never sit in one fp32 draw; the program holds the "dense"
tensors in bf16 and the rest in fp32, and the reference, after
``harness.release``, the same bf16 values in fp32.

``correct`` (limits in ``workloads/<cell>.json``) as ``serve_lfm2.py``
has it: ``token_err`` and ``image_rel_err`` as ``serve.py``; after the
window the judged batch is teacher-forced again eagerly and the experts
its router chose are logged; the reference takes them, so ``logit_err``
reads the rest of the arithmetic (the Mamba2 scan and state among it),
and ``route_gap`` reads the routing: the largest, over layers, of the
layer's mean over the judged rows' choices of how far the least chosen
logit falls short of the reference's own k-th largest.

Planted faults (``FAULTS``, each rebuilt and teacher-forced on the judged
prompts): the SSM state never advanced in decode, D dropped, the gate z
dropped, the conv bias dropped, the shared expert dropped, the residual
multiplier dropped, the runner-up expert set.
"""

from __future__ import annotations

import contextlib
import time
from unittest import mock

import numpy as np
import torch

from mas_tpu_torch.models import hybrid, sampler
from mas_tpu_torch.models.decode_state import MambaState
from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.models.vqvae import VQModel
from mas_tpu_torch.ops import moe
from mas_tpu_torch.utils.config import (GraniteBlockConfig,
                                        TransformerConfig, VQModelConfig)

from .. import counts, harness, trace, weights
from ..marks import wrap
from ..reference import granite_hybrid as ref_g
from ..reference import precision
from ..reference import vqvae as ref_v
from . import serve
from .serve_lfm2 import (b2_grouped_bound_s, b12_bound_s, expert_load,
                         route_gap, teacher_forced)

KERNELS = {"b12": "moe_swiglu_", "b14": "ssm_update_kernel"}


def geometry(cfg: dict) -> ref_g.Geometry:
    return ref_g.Geometry.of(cfg["transformer"], cfg["block"])


def make(spec, seed: int, device, into=None, dense=torch.bfloat16):
    """The spec's tensors drawn one after another from one generator on
    ``device``: copied into ``into`` (a state dict) where given, else
    returned in fp32, the "dense" ones rounded to ``dense`` first."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    with torch.no_grad():
        for name, shape, mean, std, role in spec:
            t = ref_g.draw(shape, mean, std, role, gen, device)
            if into is not None:
                into[name].copy_(t)
            else:
                out[name] = t.to(dense).float() if role == "dense" else t
    return out


def build(run: harness.Run):
    cfg = run.cell.config
    tcfg = TransformerConfig.from_dict(cfg["transformer"])
    block = GraniteBlockConfig.from_dict(cfg["block"])
    vcfg = VQModelConfig.from_dict(cfg["model"])
    with torch.device(run.device):
        transformer = MakeAScene(tcfg, block=block).eval()
        vq = VQModel(vcfg).eval()
    make(ref_g.param_spec(geometry(cfg)),
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

def _token_flops(g: ref_g.Geometry) -> float:
    """Model operations of one token through every layer: the
    projections, the Mamba2 conv and scan (the state's update, 2 H P N,
    and its read through C, 2 H P N), the router, the 10 active experts
    and the shared expert."""
    d, hd = g.hidden, g.head_dim
    total = 0.0
    for kind in g.layer_types:
        if kind == "mamba":
            total += (2.0 * d * (g.inner + g.conv_channels + g.ssm_heads)
                      + 2.0 * g.conv_taps * g.conv_channels
                      + 4.0 * g.inner * g.state + 2.0 * g.inner * d)
        else:
            total += 2.0 * d * (2 * g.heads + 2 * g.kv_heads) * hd
        total += (2.0 * d * g.experts + 6.0 * d * g.expert_width * g.top_k
                  + 6.0 * d * g.shared_width)
    return total


def batch_flops(g: ref_g.Geometry, m: dict, prompts: int) -> float:
    """One guided ``sample_images`` batch: prefill, decode loop, VQ
    decode; attention over the pairs each row attends, in the attention
    layers."""
    rows, steps = 2 * prompts, g.image_length - 1
    attn = sum(1 for k in g.layer_types if k == "attention")
    per_pair = 4.0 * g.heads * g.head_dim * attn
    prefill = rows * (g.prefix * _token_flops(g) + per_pair * g.prefix ** 2
                      + 2.0 * g.hidden * g.image_vocab)
    positions = steps * (g.prefix + 1) + steps * (steps - 1) // 2
    decode = rows * (steps * (_token_flops(g) + 2.0 * g.hidden
                              * g.image_vocab) + per_pair * positions)
    return prefill + decode + counts.vq_decode_flops(m, prompts)


def b14_bound_s(g: ref_g.Geometry, rows: int) -> float:
    """One B14 call over ``rows`` rows: the state read and written once
    (fp32), x, B, C and Δ read, y written; 5 operations a state element
    (two products and a sum to advance it, a product and a sum to read it)
    at the fp32 peak."""
    elems = rows * g.inner * g.state
    nbytes = 4.0 * (2 * elems + rows * (g.conv_channels + g.ssm_heads
                                        + g.inner))
    return counts.bound_s(5.0 * elems, nbytes, counts.FP32_FLOPS)


def _record(fn, device):
    """``trace.record`` that also keeps the device seconds of B12's and
    B14's kernels, by name (the frozen kernel table predates them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = trace._events(prof)
    seconds = {key: sum(e - s for name, on_dev, s, e in events
                        if on_dev and part in name) / 1e6
               for key, part in KERNELS.items()}
    return trace.summarize(events, window), seconds


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
            obs["slice"], secs = _record(lambda: batch(k), run.device)
        else:
            _, obs["slice"] = trace.record(lambda: batch(k), run.device)
            secs = {key: 0.0 for key in KERNELS}
        routed = transformer.routed_pairs().cpu() - before
        obs["slice_units"] = 1
        mambas = sum(1 for kind in g.layer_types if kind == "mamba")
        bits = {"int4": 4, "int8": 8}[cfg["transformer"]["kv_cache_dtype"]]
        obs["bounds"] = {"B2": [
            b2_grouped_bound_s(rows, g.heads, g.kv_heads, g.head_dim,
                               g.prefix + s, bits)
            for s in range(g.image_length - 1)
            for _ in range(len(g.layer_types) - mambas)]}
        obs["b12"] = {"bound_s": b12_bound_s(g, routed),
                      "device_s": secs["b12"]}
        obs["b14"] = {"bound_s": (g.image_length - 1) * mambas
                      * b14_bound_s(g, rows), "device_s": secs["b14"]}
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

def references(run, picked, rounding, routes=None):
    """The reference's guided logits [n, image_length, vocab], the experts
    it took [2, n, T, layers, k] (``routes``, or its own), their deficits
    [2, n, T, layers] and the images of the judged requests, in
    ``rounding``."""
    cfg = run.cell.config
    g = geometry(cfg)
    dev = run.device
    precision.fp32_only()
    tw = make(ref_g.param_spec(g), run.sub_seed(harness.TRANSFORMER_WEIGHTS),
              dev)
    vw = weights.make(ref_v.param_spec(cfg["model"]),
                      run.sub_seed(harness.VQ_WEIGHTS), dev,
                      {"conv": torch.float32, "fp32": torch.float32})
    r = precision.by_name(rounding)
    txt, sg, toks = (x.to(dev) for x in picked)
    logits, chosen, deficits = [], [], []
    with torch.no_grad():
        for i in range(toks.shape[0]):
            lg, idx, deficit = ref_g.serve_logits(
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


# --- planted faults: each a context manager over a built program ------------

def _layers(model):
    return list(model.transformer.layers)


def _mambas(model):
    return [layer.mixer for layer in _layers(model)
            if isinstance(layer.mixer, hybrid.Mamba2)]


def _state_frozen(model):
    """A Mamba2 layer's decode step advances a copy of its state: the
    state stays the prefill's."""
    inner = hybrid.Mamba2.decode
    return mock.patch.object(
        hybrid.Mamba2, "decode", lambda self, h, state, index: inner(
            self, h, MambaState(state.ssm.clone(), state.conv), index))


@contextlib.contextmanager
def _zeroed(tensors):
    with torch.no_grad():
        for t in tensors:
            t.zero_()
    yield


def _d_dropped(model):
    """y without its D x skip."""
    return _zeroed(m.D for m in _mambas(model))


def _gate_dropped(model):
    """y normed without its silu(z) gate."""
    return mock.patch.object(hybrid.Mamba2, "gate_out",
                             lambda self, y, z: self.out_proj(self.norm(y)))


def _conv_bias_dropped(model):
    return _zeroed(m.conv1d.bias for m in _mambas(model))


def _shared_expert_dropped(model):
    return _zeroed(layer.feed_forward.shared.w2.weight
                   for layer in _layers(model))


@contextlib.contextmanager
def _residual_multiplier_dropped(model):
    """Both branches added to the residual unscaled."""
    for layer in _layers(model):
        layer.residual = 1.0
    yield


def _runner_up_set(model):
    """The k-th chosen expert replaced by the (k+1)-th, weighted as the
    router weights its set: the nearest wrong choice."""
    def route(logits, bias, k, normalize, scale, score="sigmoid"):
        top = logits.float().topk(k + 1, dim=-1).indices
        idx = torch.cat([top[:, :k - 1], top[:, k:]], dim=1)
        return idx, torch.softmax(logits.float().gather(1, idx),
                                  dim=-1) * scale
    return mock.patch.object(moe, "route", route)


FAULTS = {"ssm_state_frozen": _state_frozen, "d_dropped": _d_dropped,
          "gate_dropped": _gate_dropped,
          "conv_bias_dropped": _conv_bias_dropped,
          "shared_expert_dropped": _shared_expert_dropped,
          "residual_multiplier_dropped": _residual_multiplier_dropped,
          "runner_up_set": _runner_up_set}


def faulted(run: harness.Run, picked, plant) -> dict:
    """``logit_err`` and ``route_gap`` of the program with the fault
    ``plant(program)`` planted, teacher-forced on the judged prompts and
    their served tokens."""
    cfg = run.cell.config
    transformer, vq = build(run)
    del vq
    txt, sg, toks = (x.to(run.device) for x in picked)
    n = txt.shape[0]
    with plant(transformer):
        lg, routes = teacher_forced(transformer, txt, sg, toks, range(n))
    program = serve.guided(lg[:n], lg[n:], cfg["guidance_scale"])
    del transformer
    harness.release(run.device)
    ref, _, deficits, _ = references(run, picked, "exact", routes)
    return {"logit_err": serve._logit_err(program, ref),
            "route_gap": route_gap("fault", deficits)}
