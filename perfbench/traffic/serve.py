"""Serving traffic: a closed loop of ``sample_images`` calls.

One client sends a batch of ``batch`` prompts, waits until its images are
on the host, and sends the next.  A prompt is a caption of
``caption_tokens`` (lo, hi) text ids, padded to the text length, and a
seg layout of uniform seg tokens; ``prompt_batches`` batches are drawn
from the seed and sent in turn.  Every ``greedy_every``-th batch, the
first included, decodes greedily (top-k 1) so that its tokens can be
judged; the others sample as the configuration says.  A mix that fills
the card names ``cuda_alloc_conf`` (``run.py`` sets it before torch is
imported): expandable segments keep the prefill's large blocks from
failing on fragments.

``correct``: ``requests`` rows, drawn from the seed before the window,
are judged in greedy batches: the window keeps their cond and uncond
logits as prefill and each decode step return them.  ``token_err``: in
every greedy batch of the window, the widest gap by which a served
token's guided logit lies below the best one, both mixed in fp32 from the
program's own logits, over the bound of the guidance mix's bf16 rounding
at the two tokens: a sound sampling head reads at most 1, a token picked
wrong (mixed wrong, from another row, altered) far more.  Once the window
has closed, one greedy batch is drawn from the seed; the reference runs
each judged prompt with its served tokens (teacher-forced, with guidance
and the int4 cache that the configuration states).  ``logit_err``: the
largest, over the judged positions, L2 distance of the served guided
logits from the reference's, over the reference's spread about its mean.
``image_rel_err``: the largest relative L2 distance of a served image
from the reference's decode of the same tokens.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mas_tpu_torch.models import sampler
from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.models.vqvae import VQModel
from mas_tpu_torch.utils.config import TransformerConfig, VQModelConfig

from .. import counts, harness, trace, weights
from ..marks import Marks, wrap
from ..reference import precision
from ..reference import transformer as ref_t
from ..reference import vqvae as ref_v

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _weights(run: harness.Run, dense: torch.dtype, conv: torch.dtype):
    cfg = run.cell.config
    g = ref_t.Geometry.of(cfg["transformer"])
    tw = weights.make(ref_t.param_spec(g),
                      run.sub_seed(harness.TRANSFORMER_WEIGHTS), run.device,
                      {"dense": dense, "norm": torch.float32})
    vw = weights.make(ref_v.param_spec(cfg["model"]),
                      run.sub_seed(harness.VQ_WEIGHTS), run.device,
                      {"conv": conv, "fp32": torch.float32})
    return tw, vw


def build(run: harness.Run):
    """The program's transformer and VQ model, with the seeded weights."""
    cfg = run.cell.config
    tcfg = TransformerConfig.from_dict(cfg["transformer"])
    vcfg = VQModelConfig.from_dict(cfg["model"])
    tw, vw = _weights(run, DTYPES[tcfg.compute_dtype],
                      DTYPES[vcfg.compute_dtype])
    with torch.device(run.device):
        transformer = MakeAScene(tcfg).eval()
        vq = VQModel(vcfg).eval()
    transformer.load_state_dict(tw)
    got = vq.load_state_dict(vw, strict=False)
    unused = [k for k in got.missing_keys
              if not k.startswith(("encoder.", "quant_conv."))]
    if got.unexpected_keys or unused:
        raise RuntimeError(f"VQ weights do not fit the program: missing "
                           f"{unused}, unexpected {got.unexpected_keys}")
    return transformer, vq


def prompts(run: harness.Run):
    """(text [N, B, L], seg [N, B, S]) on the device."""
    t, tr = run.cell.config["transformer"], run.cell.traffic
    rng = np.random.default_rng(run.sub_seed(harness.TRAFFIC))
    shape = (tr["prompt_batches"], tr["batch"])
    text = harness.captions(rng, shape, t, tr["caption_tokens"])
    seg = harness.tokens(rng, shape, t["seg_vocab_size"],
                         t["seg_tokens_per_dim"] ** 2)
    return harness.on(run.device, text, seg)


def _layer_marks(run, transformer, vq, batches: list) -> Marks:
    """Stamp each batch's prefill, decode loop and VQ decode into a dict
    appended to ``batches``."""
    marks = Marks(run.device)

    def begin(*_):
        batches.append({"prefill": marks.stamp()})

    def stamp(key, first_only=False):
        def put(*_, **__):
            if not (first_only and key in batches[-1]):
                batches[-1][key] = marks.stamp()
        return put

    def decode_begin(img_token, step, caches):
        if step == 0:
            batches[-1]["decode"] = marks.stamp()

    wrap(transformer, "prefill", before=begin)
    wrap(transformer, "allocate_caches", after=stamp("caches"))
    wrap(transformer, "decode_step", before=decode_begin)
    wrap(vq, "decode_code", before=stamp("vq", first_only=True),
         after=stamp("vq_end"))
    return marks


def _layer_ms(marks: Marks, stamps: list, steps: int) -> dict:
    out = {"prefill_ms": [], "decode_step_ms": [], "vq_decode_ms": []}
    for s in stamps:
        out["prefill_ms"].append(marks.ms(s["prefill"], s["caches"]))
        out["decode_step_ms"].append(marks.ms(s["decode"], s["vq"]) / steps)
        out["vq_decode_ms"].append(marks.ms(s["vq"], s["vq_end"]))
    return out


def judged_rows(run: harness.Run) -> list:
    """The rows of a batch whose requests are judged, drawn from the
    seed before the window."""
    rng = np.random.default_rng(run.sub_seed(harness.CHECK))
    b = run.cell.traffic["batch"]
    return sorted(rng.choice(b, min(run.cell.check["requests"], b),
                             replace=False).tolist())


def run(run: harness.Run) -> dict:
    cfg, tr = run.cell.config, run.cell.traffic
    g = ref_t.Geometry.of(cfg["transformer"])
    harness.log("imported")
    transformer, vq = build(run)
    text, seg = prompts(run)
    harness.sync(run.device)
    harness.log("built")
    gen = torch.Generator(device=run.device).manual_seed(
        run.sub_seed(harness.SAMPLER))
    guidance, top_k = cfg["guidance_scale"], cfg["top_k"]
    kw = dict(guidance_scale=guidance, temperature=cfg["temperature"])

    def greedy(k):
        return k % tr["greedy_every"] == 0

    # warm-up: one whole batch at the configuration's top-k, and the
    # greedy sampling head
    sampler.sample_images(transformer, vq, text[0], seg[0], gen, top_k=top_k,
                          **kw)
    sampler._sample_logits(torch.zeros(tr["batch"], g.image_vocab,
                                       device=run.device), gen, 1.0, 1)
    harness.sync(run.device)
    harness.log("warmed up")

    grids = []
    wrap(vq, "decode_code", before=lambda idx: grids.append(idx))
    judged = judged_rows(run)
    # cond rows, then their uncond halves
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
        marks = _layer_marks(run, transformer, vq, stamps)
    n_batches = text.shape[0]
    served = []      # (prompt batch, rows' tokens, images, logits)

    def batch(k):
        grids.clear()
        if greedy(k):
            kept.append([])
        imgs = sampler.sample_images(
            transformer, vq, text[k % n_batches], seg[k % n_batches], gen,
            top_k=1 if greedy(k) else top_k, **kw)
        host = imgs.cpu()
        if greedy(k):
            toks = torch.cat(grids).reshape(host.shape[0], -1)[judged]
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
    flops = k * counts.serve_batch_flops(g, cfg["model"], tr["batch"],
                                         guidance != 1.0)
    obs = {"timed_s": timed, "flops": flops, "unit_s": timed / k}
    if run.trace:
        obs["layers"] = _layer_ms(marks, stamps, g.image_length - 1)
        rows = tr["batch"] * (2 if guidance != 1.0 else 1)
        _, obs["slice"] = trace.record(lambda: batch(k), run.device)
        obs["slice_units"] = 1
        # B2 reads a quantized cache: each call's bound at its index
        bits = {"int4": 4, "int8": 8}.get(
            cfg["transformer"].get("kv_cache_dtype"))
        obs["bounds"] = {"B2": [
            counts.b2_bound_s(rows, g.heads, g.head_dim, g.prefix + s, bits)
            for s in range(g.image_length - 1)
            for _ in range(g.layers)]} if bits else {}
    peak = harness.memory_peak(run.device)
    del transformer, vq, grids
    harness.release(run.device)
    rng = np.random.default_rng(run.sub_seed(harness.CHECK) + 1)
    b, toks, imgs, lg = served[int(rng.integers(len(served)))]
    n = len(judged)
    picked = (text[b, judged].cpu(), seg[b, judged].cpu(), toks)
    program = guided(lg[:n], lg[n:], guidance)
    checks = dict(check(run, picked, program, imgs.to(run.device)),
                  token_err=max(token_err(x[:n], x[n:], t, guidance)
                                for _, t, _, x in served))
    return {"t0": t0, "attempted": images, "failed": 0,
            "e2e": {"images_per_s": images / timed},
            "checks": checks, "memory_peak_bytes": peak, "obs": obs,
            "control": lambda: control(run, picked),
            "faults": {"token_altered": lambda: dict(
                token_err=token_err(lg[:n], lg[n:],
                                    runner_up(lg[:n], lg[n:], guidance),
                                    guidance))}}


def guided(cond, uncond, scale: float):
    """Classifier-free guidance, as the sampler mixes it."""
    return uncond + scale * (cond - uncond)


def _mixed(cond, uncond, scale: float):
    """The guided logits in fp32, and the bound of the difference that
    mixing the same logits in bf16, as the sampler may, makes at each
    token: three roundings, of ``cond - uncond``, of its scaled value and
    of the sum, each within 2**-8 of what it rounds."""
    c, u = cond.float(), uncond.float()
    mixed = guided(c, u, scale)
    return mixed, 2.0 ** -8 * (2 * abs(scale) * (c - u).abs() + mixed.abs())


def token_err(cond, uncond, tokens, scale: float) -> float:
    """The widest gap by which a served greedy token's guided logit lies
    below the best, over the rounding bound at the two tokens; cond and
    uncond [n, positions, vocab] as the program made them, tokens [n,
    positions]."""
    mixed, bound = _mixed(cond, uncond, scale)
    best = mixed.argmax(dim=-1, keepdim=True)
    t = tokens[..., None].to(best.device)
    gap = mixed.gather(-1, best) - mixed.gather(-1, t)
    tol = bound.gather(-1, best) + bound.gather(-1, t)
    return float((gap / tol.clamp_min(torch.finfo(tol.dtype).tiny)).max())


def runner_up(cond, uncond, scale: float):
    """A planted fault: each served token altered to the second best of
    the guided logits, the nearest wrong answer."""
    mixed, _ = _mixed(cond, uncond, scale)
    return mixed.topk(2, dim=-1).indices[..., 1]


def _references(run, picked, rounding):
    """The reference's guided logits [n, image_length, vocab] and images of
    the judged requests (text, seg, served tokens), in ``rounding``."""
    cfg = run.cell.config
    g = ref_t.Geometry.of(cfg["transformer"])
    dev = run.device
    precision.fp32_only()
    tw, vw = _weights(run, torch.float32, torch.float32)
    r = precision.by_name(rounding)
    txt, sg, toks = (x.to(dev) for x in picked)
    with torch.no_grad():
        ref = torch.cat([ref_t.serve_logits(
            tw, g, txt[i:i + 1], sg[i:i + 1], toks[i:i + 1],
            cfg["guidance_scale"], r) for i in range(toks.shape[0])])
        side = g.image_side
        images = ref_v.decode_code(vw, cfg["model"],
                                   toks.reshape(-1, side, side), r)
    return ref, images


def _logit_err(logits, ref) -> float:
    spread = (ref - ref.mean(dim=-1, keepdim=True)).norm(dim=-1)
    return float(((logits - ref).norm(dim=-1) / spread).max())


def _rel(images, ref) -> float:
    d = (images - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
    return float(d.max())


def check(run: harness.Run, picked, program, images) -> dict:
    ref, ref_images = _references(run, picked, "exact")
    return {"logit_err": _logit_err(program, ref),
            "image_rel_err": _rel(images, ref_images)}


def control(run: harness.Run, picked) -> dict:
    """The reference in fp8 in the program's place, on the same prompts
    and served tokens."""
    ref, ref_images = _references(run, picked, "exact")
    low, low_images = _references(run, picked, "fp8")
    return {"logit_err": _logit_err(low, ref),
            "image_rel_err": _rel(low_images, ref_images)}
