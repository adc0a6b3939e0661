"""Adam's update (``ops/adam.py``, kernel B13) on the CPU.

B13 runs only on the card, where ``chip_smoke.py`` holds it against its
plain twin.  Here:

* the launch plan, the pure function that cuts a list of tensors into
  launches and each tensor into tiles: walked tile by tile as the kernel
  walks it, it covers every element of every tensor exactly once, at
  transformer_512's 398 parameter shapes (built on the ``meta`` device)
  and at edge sizes; every launch's table fits the kernel-parameter
  limit; transformer_512 takes 5 launches an update;
* the wrapper's checks, on ``meta`` tensors: it refuses tensors that are
  not fp32, not contiguous or not of their parameter's shape, lists of
  unequal length, and a device other than cpu or cuda;
* the plain path: ``Adam`` on CPU tensors launches nothing and gives, bit
  for bit, the parameters and moments of the per-tensor loop it replaced,
  over 3 updates, with and without accumulation, with contiguous and
  channels_last gradients.

Torch runs one thread in this file, as the suite's other small files do.
"""

import json
import os

import numpy as np
import pytest
import torch

from mas_tpu_torch.models.transformer import MakeAScene
from mas_tpu_torch.ops import adam
from mas_tpu_torch.parallel.collectives import mean_
from mas_tpu_torch.train.state import Adam
from mas_tpu_torch.utils.config import TransformerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, B1, B2, EPS = 1e-3, 0.9, 0.95, 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def transformer_512_numels():
    with open(os.path.join(ROOT, "configs", "transformer_512.json")) as f:
        cfg = TransformerConfig.from_dict(json.load(f)["transformer"])
    with torch.device("meta"):
        model = MakeAScene(cfg, fp32_params=True)
    return [p.numel() for p in model.parameters()]


EDGES = [1, 3, 5, 4 * 1000 + 1, 16_908_288]
NUMELS = {
    "transformer_512": transformer_512_numels,
    "edges": lambda: EDGES,
    "edges_with_empty": lambda: [0, *EDGES, 0, adam.TILE, adam.TILE + 1],
    "many_small": lambda: [1 + k % 7 for k in range(2 * 90 + 1)],
}


def walk(plan, numels):
    """The elements each tile of each launch updates, as csrc/adam.cu's
    blocks find them: {tensor: [(lo, hi), ...]}."""
    spans = {}
    for lc in plan:
        i = 0
        for tile in range(lc.tiles):
            while tile >= lc.tile_starts[i + 1]:
                i += 1
            k = lc.first + i
            lo = (tile - lc.tile_starts[i]) * adam.TILE
            spans.setdefault(k, []).append(
                (lo, min(lo + adam.TILE, numels[k])))
    return spans


@pytest.mark.parametrize("which", sorted(NUMELS))
def test_plan_covers_every_element_once(which):
    numels = NUMELS[which]()
    plan = adam.launch_plan(numels)
    # the launches take the tensors in order, each once
    assert [k for lc in plan for k in range(lc.first, lc.first + lc.count)
            ] == list(range(len(numels)))
    spans = walk(plan, numels)
    for k, n in enumerate(numels):
        got = sorted(spans.get(k, []))
        if n == 0:
            assert not got, k
            continue
        assert all(lo < hi for lo, hi in got), (k, got[:3])
        # tiles abut, start at 0 and end at numel: each element once
        assert [lo for lo, _ in got] == [0] + [hi for _, hi in got[:-1]]
        assert got[-1][1] == n, (k, n)


@pytest.mark.parametrize("which", sorted(NUMELS))
def test_plan_tables_fit_the_parameter_limit(which):
    numels = NUMELS[which]()
    plan = adam.launch_plan(numels)
    assert adam.PARAM_BYTES <= adam.PARAM_LIMIT
    assert all(1 <= lc.count <= adam.TENSORS_PER_LAUNCH for lc in plan)
    assert all(lc.tiles < 2 ** 31 for lc in plan)
    assert len(plan) == -(-len(numels) // adam.TENSORS_PER_LAUNCH)
    counts = [lc.count for lc in plan]
    assert max(counts) - min(counts) <= 1


def test_plan_takes_five_launches_at_transformer_512():
    """The launches an update takes in the benchmark's training cell, as
    PERF.md reports them."""
    numels = transformer_512_numels()
    plan = adam.launch_plan(numels)
    assert len(numels) == 398 and sum(numels) == 337_383_424
    assert [lc.count for lc in plan] == [80, 80, 80, 79, 79]
    assert sum(lc.tiles for lc in plan) == sum(-(-n // adam.TILE)
                                               for n in numels)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _lists():
    shapes = [(4, 3), (5,), (2, 3, 3, 3)]
    return [[_meta(*s) for s in shapes] for _ in range(4)]


def test_checks_take_contiguous_fp32_of_one_shape():
    assert adam.check_tensors(*_lists()) == -1      # meta: no device index


@pytest.mark.parametrize("fault, error", [
    ("bf16 grad", TypeError), ("fp16 nu", TypeError),
    ("fp64 param", TypeError), ("transposed grad", ValueError),
    ("channels_last mu", ValueError), ("strided param", ValueError),
    ("nu of another shape", ValueError), ("grad of another size",
                                          ValueError),
    ("one grad short", ValueError)])
def test_checks_refuse(fault, error):
    p, g, mu, nu = _lists()
    if fault == "bf16 grad":
        g[1] = _meta(5, dtype=torch.bfloat16)
    elif fault == "fp16 nu":
        nu[0] = _meta(4, 3, dtype=torch.float16)
    elif fault == "fp64 param":
        p[2] = _meta(2, 3, 3, 3, dtype=torch.float64)
    elif fault == "transposed grad":
        g[0] = _meta(3, 4).t()
    elif fault == "channels_last mu":
        mu[2] = _meta(2, 3, 3, 3).contiguous(
            memory_format=torch.channels_last)
    elif fault == "strided param":
        p[1] = _meta(10)[::2]
    elif fault == "nu of another shape":
        nu[0] = _meta(3, 4)
    elif fault == "grad of another size":
        g[1] = _meta(6)
    elif fault == "one grad short":
        g.pop()
    with pytest.raises(error):
        adam.check_tensors(p, g, mu, nu)


def test_update_refuses_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        adam.adam_update(*_lists(), LR, B1, B2, EPS, 0.1, 0.05)


class LoopAdam:
    """``train/state.py::Adam`` as it was before B13: the update as a loop
    of eager operations over the tensors."""

    def __init__(self, params, every_k):
        self.params = params
        self.every_k = every_k
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.acc = ({k: torch.zeros_like(p) for k, p in params.items()}
                    if every_k > 1 else {})
        self.count = self.mini_step = 0
        self.lr, self.b1, self.b2, self.eps = LR, B1, B2, EPS

    @torch.no_grad()
    def step(self, grads):
        grads = dict(zip(self.params, grads))
        if self.every_k > 1:
            n = self.mini_step
            for k, g in grads.items():
                acc = self.acc[k]
                acc.add_((g - acc) / (n + 1))
            if n + 1 < self.every_k:
                self.mini_step += 1
                return False
            grads = self.acc
        mean_(list(grads.values()))
        self.count += 1
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        for k, p in self.params.items():
            g, mu, nu = grads[k], self.mu[k], self.nu[k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g.square() + self.b2 * nu)
            p.add_((mu / bc1) / ((nu / bc2).sqrt() + self.eps),
                   alpha=-self.lr)
        if self.every_k > 1:
            for acc in self.acc.values():
                acc.zero_()
            self.mini_step = 0
        return True


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("every_k", [1, 2])
def test_adam_on_cpu_is_the_loop_it_replaced(every_k, layout):
    r = np.random.default_rng(every_k)
    shapes = {"w": (16, 8), "b": (3,), "conv": (8, 4, 3, 3), "one": (1,),
              "odd": (4 * 25 + 1,)}
    start = {k: r.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    mine = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    theirs = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    opt = Adam(mine.items(), LR, B1, B2, EPS, every_k)
    ref = LoopAdam(theirs, every_k)
    adam.adam_update.launches = 0
    for step in range(3 * every_k):
        grads = [torch.from_numpy(
            r.standard_normal(s).astype(np.float32) * 10.0 ** (step % 3 - 1))
            for s in shapes.values()]
        if layout == "channels_last":
            grads[2] = grads[2].contiguous(memory_format=torch.channels_last)
        assert opt.step(grads) == ref.step(grads)
        for name in ("mu", "nu", "acc"):
            for k in shapes:
                assert torch.equal(getattr(opt, name).get(k, torch.empty(0)),
                                   getattr(ref, name).get(k, torch.empty(0))
                                   ), (name, k, step)
        for k in shapes:
            assert torch.equal(mine[k], theirs[k]), (k, step)
    assert opt.count == ref.count == 3
    assert not any(torch.equal(mine[k], torch.from_numpy(start[k]))
                   for k in shapes)
    assert adam.adam_update.launches == 0
