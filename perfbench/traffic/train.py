"""Training traffic: a closed loop of the transformer's train step.

A pool of ``pool_batches`` token batches (captions of ``caption_tokens``
text ids padded to the text length, uniform seg and image tokens) is
drawn from the seed onto the device and fed in turn to
``make_transformer_train_step``'s step, as fast as it takes them.  The
window counts the steps it launched between two synchronizes.

``correct``: set-up builds the train state once, from the seed's weights,
and takes its first ``checked_steps`` steps through the window's own call
on the pool's first batches, reading Adam's first moment after step 1
(the gradient as the optimizer got it) and the parameters' change after
the last; the same state then runs the window.  Once the window has
closed, the reference takes the same steps from the same weights (CFG
dropout from a generator seeded as the program's).  Compared, by the
reference's leaves (the fused qkv projection as its q, k and v):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the largest gap of a leaf's first-gradient norm, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change_gap``: the same of the parameters' change, leaving out leaves
  whose reference gradient is under a thousandth of the median leaf's
  (a key's bias under softmax: Adam moves it by round-off alone).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.train.state import TransformerTrainState, make_adam
from mas_tpu_torch.train.steps import make_transformer_train_step
from mas_tpu_torch.utils.config import OptimizerConfig, TransformerConfig

from .. import counts, harness, trace, weights
from ..marks import Marks, wrap
from ..reference import precision
from ..reference import transformer as ref_t

SLICE_STEPS = 4
TINY = 1e-3       # of the median leaf's gradient norm: nought to rounding


def _weights(run: harness.Run):
    g = ref_t.Geometry.of(run.cell.config["transformer"])
    return weights.make(ref_t.param_spec(g),
                        run.sub_seed(harness.TRANSFORMER_WEIGHTS), run.device,
                        {"dense": torch.float32, "norm": torch.float32})


def pool(run: harness.Run):
    """(text, seg, img) [N, B, L] on the device."""
    t, tr = run.cell.config["transformer"], run.cell.traffic
    rng = np.random.default_rng(run.sub_seed(harness.TRAFFIC))
    shape = (tr["pool_batches"], run.cell.config["train"]["batch_size"])
    text = harness.captions(rng, shape, t, tr["caption_tokens"])
    seg = harness.tokens(rng, shape, t["seg_vocab_size"],
                         t["seg_tokens_per_dim"] ** 2)
    img = harness.tokens(rng, shape, t["image_vocab_size"],
                         t["image_tokens_per_dim"] ** 2)
    return harness.on(run.device, text, seg, img)


def leaf_norms(tensors) -> dict:
    """{leaf: norm} over the reference's leaves of {name: tensor}."""
    names, parts = [], []
    for name, t in tensors.items():
        for leaf, part in ref_t.leaves(name, t):
            names.append(leaf)
            parts.append(part.float().norm())
    return dict(zip(names, torch.stack(parts).tolist()))


def _changes(run, params) -> dict:
    start = _weights(run)
    return leaf_norms({k: p.detach() - start[k] for k, p in params})


def run(run: harness.Run) -> dict:
    cfg, tr = run.cell.config, run.cell.traffic
    train = cfg["train"]
    g = ref_t.Geometry.of(cfg["transformer"])
    batch = train["batch_size"]
    harness.log("imported")
    w = _weights(run)
    with torch.device(run.device):
        model = MakeAScene(TransformerConfig.from_dict(cfg["transformer"]),
                           fp32_params=True)
    model.load_state_dict(w)
    del w
    opt_cfg = OptimizerConfig.from_dict(train["optimizer"])
    opt = make_adam(opt_cfg, model.named_parameters(), rescale_lr=False)
    state = TransformerTrainState(0, model, opt)
    step = make_transformer_train_step(model, opt, train["uncond_p"],
                                       train["start_uncond"])
    text, seg, img = pool(run)
    n_pool = text.shape[0]
    gen = torch.Generator(device=run.device).manual_seed(
        run.sub_seed(harness.SAMPLER))

    def feed(k):
        return text[k % n_pool], seg[k % n_pool], img[k % n_pool]

    harness.sync(run.device)
    harness.log("built")
    # set-up: the checked first steps, which also warm every shape
    prog = {"loss": []}
    for k in range(tr["checked_steps"]):
        m = step(state, *feed(k), gen)
        prog["loss"].append(m["loss"].item())
        if k == 0:
            prog["grad"] = leaf_norms(
                {n: mu / (1 - opt_cfg.beta1) for n, mu in opt.mu.items()})
    prog["change"] = _changes(run, model.named_parameters())
    harness.sync(run.device)
    harness.log("checked steps taken")

    adam = []
    if run.trace:
        marks = Marks(run.device)
        wrap(opt, "step", before=lambda *_: adam.append(marks.stamp()),
             after=lambda _: adam.append(marks.stamp()))
    t0 = time.perf_counter()
    k = tr["checked_steps"]
    while True:
        step(state, *feed(k), gen)
        k += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    harness.sync(run.device)
    timed = time.perf_counter() - t0
    steps = k - tr["checked_steps"]
    tokens = steps * batch * (g.prefix + g.image_length)
    obs = {"timed_s": timed, "unit_s": timed / steps,
           "flops": steps * counts.train_step_flops(g, batch)}
    if run.trace:
        obs["layers"] = {"adam_ms": [marks.ms(a, b) for a, b
                                     in zip(adam[0::2], adam[1::2])]}

        def sliced():
            for j in range(SLICE_STEPS):
                step(state, *feed(k + j), gen)

        _, obs["slice"] = trace.record(sliced, run.device)
        obs["slice_units"] = SLICE_STEPS
        t = g.prefix + g.image_length
        per = {"B1": counts.b1_bound_s(batch, g.heads, t, g.head_dim,
                                       g.prefix),
               "B6": counts.b6_bound_s(batch, g.heads, t, g.head_dim,
                                       g.prefix)}
        obs["bounds"] = {kid: [b] * (SLICE_STEPS * g.layers)
                         for kid, b in per.items()}
    peak = harness.memory_peak(run.device)
    del model, opt, state, step, m
    harness.release(run.device)
    fed = (text.cpu(), seg.cpu(), img.cpu())
    return {"t0": t0, "attempted": steps, "failed": 0,
            "e2e": {"train_tokens_per_s": tokens / timed},
            "checks": check(run, prog, fed), "memory_peak_bytes": peak,
            "obs": obs, "control": lambda: control(run, fed),
            "faults": {"half_batch": lambda: half_batch(run, fed)}}


def reference(run: harness.Run, feed, rounding="exact", rows=slice(None)):
    """The reference's readings of the checked steps: losses, first-gradient
    and change norms by leaf."""
    cfg, tr = run.cell.config, run.cell.traffic
    train, dev = cfg["train"], run.device
    g = ref_t.Geometry.of(cfg["transformer"])
    precision.fp32_only()
    gen = torch.Generator(device=dev).manual_seed(
        run.sub_seed(harness.SAMPLER))
    drops = [bool(torch.rand((), generator=gen, device=dev)
                  < train["uncond_p"]) and k >= train["start_uncond"]
             for k in range(tr["checked_steps"])]
    batches = [tuple(x[k].to(dev) for x in feed)
               for k in range(tr["checked_steps"])]
    o = train["optimizer"]
    adam = ref_t.Adam(o["lr"], o["beta1"], o["beta2"], o.get("eps", 1e-8))
    start = _weights(run)
    losses, first, end = ref_t.train_steps(
        start, g, batches, drops, adam, precision.by_name(rounding), rows)
    return {"loss": losses, "grad": leaf_norms(first),
            "change": leaf_norms({k: end[k] - start[k] for k in start})}


def readings(prog: dict, ref: dict) -> dict:
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    g_med = float(np.median(list(ref["grad"].values())))
    grad = max(abs(prog["grad"][k] - v) / max(v, g_med)
               for k, v in ref["grad"].items())
    moved = [k for k, v in ref["grad"].items() if v >= TINY * g_med]
    c_med = float(np.median([ref["change"][k] for k in moved]))
    change = max(abs(prog["change"][k] - ref["change"][k])
                 / max(ref["change"][k], c_med) for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def check(run: harness.Run, prog: dict, feed) -> dict:
    return readings(prog, reference(run, feed))


def control(run: harness.Run, feed) -> dict:
    """The reference in fp8 in the program's place."""
    return readings(reference(run, feed, "fp8"), reference(run, feed))


def half_batch(run: harness.Run, feed) -> dict:
    """A planted fault: the reference's steps over half of each batch (the
    mean taken over the rest) in the program's place."""
    b = run.cell.config["train"]["batch_size"]
    return readings(reference(run, feed, rows=slice(0, b // 2)),
                    reference(run, feed))
