"""Tensor parallelism of the port (``mas_tpu_torch/parallel/sharding.py``
and the model group of ``parallel/``) on CPU: gloo ranks on a (data,
model) grid against ``mas_tpu`` under a ``('data', 'model')`` mesh of the
conftest's fake CPU devices with ``transformer_param_shardings``, as
``__graft_entry__.py::dryrun_multichip`` runs it, and against one process
of the port.

The ranks are processes of this file, started once for the whole file
with a launcher's environment (``WORLD_SIZE``, ``RANK``, ...), so
``parallel.distributed.initialize`` and its grid are the code under test;
they never import jax.  A 1 x 2 world (2 ranks) runs every case; a 2 x 2
world (4 ranks) the train step alone.  Sizes: 2 layers, hidden 64, 8
heads, image vocabulary 64, fp32.  Cases of a rank:

  * ``forward`` — the gathered logits of MHA, GQA (kv 2), MQA (kv 1) and
    GQA with 3 kv heads over 12 query heads (in the last two every rank
    holds all k/v rows) and rudalle_relax + prescale + fold, with the
    loss and gathered gradients of each;
  * ``step`` — one train step with Adam on the rank's data share;
  * ``decode`` — teacher-forced decode logits over int8 and int4 lane
    caches and the float cache (B3/B2, B9 through their twins) and greedy
    tokens;
  * ``cli`` — ``--mode train_transformer`` at 1 x 2, then resumed, and
    ``--mode pretrain_segmentation`` at 1 x 2.

Tolerances (fp32): logits atol 2e-4 against JAX (``tests/
test_parallel.py``'s), 1e-5 against one process; losses rtol 1e-5;
gradients atol 1e-5; parameters after Adam atol 1e-6.
"""

import contextlib
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_CFG = dict(num_layers=2, hidden_dim=64, num_attn_heads=8,
             image_vocab_size=64, seg_vocab_size=32, text_vocab_size=40,
             image_tokens_per_dim=4, seg_tokens_per_dim=2, text_length=8)
# gqa3: 12 query heads over 3 kv heads split over 2 ranks, so a rank's
# query heads read kv heads 0, 0, 0, 0, 1, 1 / 1, 1, 2, 2, 2, 2
VARIANTS = {"mha": {}, "gqa2": {"num_kv_heads": 2},
            "mqa": {"num_kv_heads": 1},
            "gqa3": dict(num_attn_heads=12, hidden_dim=96, num_kv_heads=3),
            "relax": dict(rudalle_relax=True,
                          cogview_layernorm_prescale=True,
                          ln_matmul_fold=True)}
T_OPT = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-3)
CACHES = ("int8", "int4", "compute")
SEG_CFG = dict(in_channels=8, out_channels=8, channels=(32, 32),
               num_res_blocks=1, attn_resolutions=(), resolution=16,
               z_channels=32, embed_dim=32)
SEG_CB = dict(codebook_size=16, codebook_dim=32, init_steps=1,
              reservoir_size=64, kmeans_iters=1, samples_per_image=8)


def _shard_rows(a, index, count):
    rows = a.shape[0] // count
    return torch.as_tensor(np.ascontiguousarray(
        a[index * rows:(index + 1) * rows])).long()


def _model(variant, weights, shard, **kw):
    from mas_tpu_torch.models.transformer import MakeAScene
    from mas_tpu_torch.utils.config import TransformerConfig

    cfg = TransformerConfig(**dict(T_CFG, **VARIANTS[variant], **kw))
    return MakeAScene.sharded(cfg, weights, shard, fp32_params=True)


def _whole(model, tensors):
    """The full dict of this rank's shards (``model_parts`` +
    ``gather_state``)."""
    from mas_tpu_torch.parallel.collectives import model_parts
    from mas_tpu_torch.parallel.sharding import gather_state, split_dim

    keys = [k for k in tensors if split_dim(k) is not None]
    return gather_state(model_parts(tensors, keys), model.cfg)


def forward_case(spec, shard, data):
    """Gathered logits, loss and gathered gradients of every variant on
    the whole batch (no data split)."""
    from mas_tpu_torch.parallel.collectives import gather_vocab
    from mas_tpu_torch.train.steps import transformer_loss_and_grads

    out = {}
    for name in VARIANTS:
        model = _model(name, spec["weights"][name], shard)
        text, seg, img = (torch.as_tensor(spec[k]).long()
                          for k in ("text", "seg", "img"))
        with torch.no_grad():
            logits = gather_vocab(model(text, seg, img))
        loss, grads = transformer_loss_and_grads(model, text, seg, img)
        names = [n for n, _ in model.named_parameters()]
        out[name] = dict(logits=logits, loss=float(loss),
                         grads=_whole(model, dict(zip(names, grads))))
    return out


def step_case(spec, shard, data):
    """One train step of MHA and MQA (Adam, no CFG dropout) on this data
    index's rows; the gathered parameters after it and the replicated
    ones as this rank holds them."""
    from mas_tpu_torch.parallel.sharding import split_dim
    from mas_tpu_torch.train.state import TransformerTrainState, make_adam
    from mas_tpu_torch.train.steps import make_transformer_train_step
    from mas_tpu_torch.utils.config import OptimizerConfig

    out = {}
    for name in ("mha", "mqa"):
        model = _model(name, spec["weights"][name], shard)
        opt = make_adam(OptimizerConfig(**T_OPT), model.named_parameters(),
                        rescale_lr=False)
        state = TransformerTrainState(0, model, opt)
        step = make_transformer_train_step(model, opt, uncond_p=0.0)
        rows = [_shard_rows(spec[k], *data) for k in ("text", "seg", "img")]
        m = step(state, *rows, torch.Generator().manual_seed(3))
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out[name] = dict(loss=float(m["loss"]), params=_whole(model, sd),
                         replicated={k: v for k, v in sd.items()
                                     if split_dim(k) is None})
    return out


def decode_case(spec, shard, data):
    """Teacher-forced decode logits (gathered) over each cache kind, and
    greedy tokens from ``sample_tokens``."""
    from mas_tpu_torch.models.sampler import sample_tokens
    from mas_tpu_torch.parallel.collectives import gather_vocab

    text, seg, img = (torch.as_tensor(spec[k]).long()
                      for k in ("text", "seg", "img"))
    out = {}
    for name, cache in [("mha", c) for c in CACHES] + [("mqa", "int4")]:
        model = _model(name, spec["weights"][name], shard,
                       kv_cache_dtype=cache).eval()
        with torch.inference_mode():
            logits, kvs = model.prefill(text, seg)
            caches = model.allocate_caches(kvs, text.shape[0])
            steps = [gather_vocab(logits)]
            for i in range(img.shape[1] - 1):
                steps.append(gather_vocab(
                    model.decode_step(img[:, i:i + 1], i, caches)))
        tokens = sample_tokens(model, text, seg,
                               torch.Generator().manual_seed(4),
                               guidance_scale=3.0, top_k=1)
        out[f"{name}_{cache}"] = dict(logits=torch.stack(steps, 1),
                                      tokens=tokens)
    return out


def _cli_run(config, cwd, stdout):
    from mas_tpu_torch import cli
    from mas_tpu_torch.train import loop

    states, writes = [], []
    real_save, real_run = loop.save_checkpoint, loop._loop

    def save(directory, state):
        writes.append(state.step)
        return real_save(directory, state)

    def run(*a, **kw):
        states.append(real_run(*a, **kw))
        return states[-1]

    loop.save_checkpoint, loop._loop = save, run
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(stdout):
            cli.main(["--config", config, "--device", "cpu"])
    finally:
        loop.save_checkpoint, loop._loop = real_save, real_run
    return states[-1], writes


def cli_case(spec, shard, data):
    """``--mode train_transformer`` at 1 x 2 for 2 steps, then resumed to
    3; ``--mode pretrain_segmentation`` at 1 x 2.  The JSONL sink (no
    TensorBoard)."""
    sys.modules["torch.utils.tensorboard"] = None
    out, stdout = {}, io.StringIO()
    state, writes = _cli_run(spec["transformer"], spec["cwd"], stdout)
    out["shards"] = {k: v.detach().clone()
                     for k, v in state.model.state_dict().items()}
    out["mu"] = {k: v.clone() for k, v in state.opt.mu.items()}
    out["writes"] = writes
    state, writes = _cli_run(spec["resumed"], spec["cwd"], stdout)
    out["resumed_writes"] = writes
    out["resumed"] = {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()}
    state, _ = _cli_run(spec["seg"], spec["cwd"], stdout)
    out["seg"] = {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()}
    out["reservoir"] = state.vq_state.reservoir.clone()
    out["stdout"] = stdout.getvalue()
    return out


CASES = {"forward": forward_case, "step": step_case, "decode": decode_case,
         "cli": cli_case}


def rank_main(inputs: str, out_dir: str, model: str, cases: str) -> None:
    """One rank: join the (data, model) grid from the environment, run
    ``cases`` (comma-separated), repeat ``initialize`` with the same mesh
    and with another, save the results."""
    torch.set_num_threads(1)
    from mas_tpu_torch.parallel import distributed
    from mas_tpu_torch.utils.config import ConfigError, MeshConfig

    topo = distributed.initialize("cpu", MeshConfig(model=int(model)))
    g = distributed.grid()
    specs = torch.load(inputs, weights_only=False)
    shard, data = (g.model_index, g.model), (g.data_index, g.data)
    res = {name: CASES[name](specs[name], shard, data)
           for name in cases.split(",")}
    distributed.initialize("cpu", MeshConfig(model=int(model)))
    res["repeat_same"] = distributed.grid() is g
    try:
        distributed.initialize("cpu", MeshConfig(model=1))
        res["repeat_other"] = None
    except ConfigError as e:
        res["repeat_other"] = str(e)
    g = distributed.grid()
    res["grid"] = (g.data, g.model, g.data_index, g.model_index)
    res["backend"] = topo["backend"]
    torch.save(res, os.path.join(out_dir, f"rank{topo['process_index']}.pt"))


if __name__ == "__main__":
    rank_main(*sys.argv[1:])
    sys.exit(0)


# --- the test process (jax and the port) --------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from mas_tpu.models.transformer import MakeAScene as JMakeAScene  # noqa
from mas_tpu.models.transformer import stack_layer_params  # noqa: E402
from mas_tpu.parallel.mesh import make_mesh  # noqa: E402
from mas_tpu.parallel.sharding import (_spec_for_path,  # noqa: E402
                                       transformer_param_shardings)
from mas_tpu.train.state import TransformerTrainState as JTState  # noqa
from mas_tpu.train.state import make_adam as jmake_adam  # noqa: E402
from mas_tpu.train.steps import make_transformer_train_step  # noqa: E402
from mas_tpu.utils import config as jconfig  # noqa: E402

from mas_tpu_torch.models.transformer import MakeAScene  # noqa: E402
from mas_tpu_torch.parallel import sharding  # noqa: E402
from mas_tpu_torch.utils.config import (ConfigError,  # noqa: E402
                                        TrainConfig, TransformerConfig)
from mas_tpu_torch.utils.weights import transformer_from_flax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_parallel import _init, _np  # noqa: E402


def _jcfg(name, **kw):
    return jconfig.TransformerConfig(**dict(T_CFG, **VARIANTS[name], **kw))


def _params(name, seed=5):
    jmodel = JMakeAScene(_jcfg(name))
    z = lambda n: jnp.zeros((1, n), jnp.int32)
    cfg = TransformerConfig(**T_CFG)
    return jmodel, _init(jmodel, seed, z(cfg.text_length),
                         z(cfg.seg_length), z(cfg.image_length))["params"]


def _batch(rows=4, seed=4):
    cfg = TransformerConfig(**T_CFG)
    r = np.random.default_rng(seed)
    return dict(
        text=r.integers(1, cfg.text_vocab_size - cfg.text_length,
                        (rows, cfg.text_length)).astype(np.int32),
        seg=r.integers(0, cfg.seg_vocab_size,
                       (rows, cfg.seg_length)).astype(np.int32),
        img=r.integers(0, cfg.image_vocab_size,
                       (rows, cfg.image_length)).astype(np.int32))


def _tp_mesh(data):
    return make_mesh(jconfig.MeshConfig(data=data, model=2),
                     jax.devices()[:2 * data])


def _tp_params(mesh, params):
    return jax.tree.map(jax.device_put, params,
                        transformer_param_shardings(mesh, params))


def _on_data(mesh, batch):
    sh = NamedSharding(mesh, P("data"))
    return {k: jax.device_put(jnp.asarray(v), sh) for k, v in batch.items()}


def _jax_forward(name, params, batch):
    """JAX logits unsharded and under the 1 x 2 TP mesh."""
    jmodel = JMakeAScene(_jcfg(name))
    fwd = jax.jit(lambda p, t, s, i: jmodel.apply({"params": p}, t, s, i))
    ref = np.asarray(fwd(params, batch["text"], batch["seg"], batch["img"]))
    mesh = _tp_mesh(1)
    b = _on_data(mesh, batch)
    with jax.set_mesh(mesh):
        tp = np.asarray(fwd(_tp_params(mesh, params), b["text"], b["seg"],
                            b["img"]))
    return ref, tp


def _jax_step(name, params, batch, data):
    """One ``make_transformer_train_step`` under the data x 2 TP mesh."""
    jmodel = JMakeAScene(_jcfg(name))
    tx = jmake_adam(jconfig.OptimizerConfig(**T_OPT), rescale_lr=False)
    mesh = _tp_mesh(data)
    p = _tp_params(mesh, params)
    with jax.set_mesh(mesh):
        s = JTState(step=jnp.zeros((), jnp.int32), params=p,
                    opt_state=jax.jit(tx.init)(p))
        b = _on_data(mesh, batch)
        s, m = make_transformer_train_step(jmodel, tx, uncond_p=0.0,
                                           donate=False)(
            s, b["text"], b["seg"], b["img"], jax.random.PRNGKey(2))
    cfg = TransformerConfig(**dict(T_CFG, **VARIANTS[name]))
    return float(m["loss"]), transformer_from_flax(_np({"params": s.params}),
                                                   cfg)


def _one_process(name, weights, batch, **kw):
    """The port in one process: logits, loss and gradients, or with
    ``kv_cache_dtype`` the teacher-forced decode logits and greedy
    tokens."""
    from mas_tpu_torch.models.sampler import sample_tokens
    from mas_tpu_torch.train.steps import transformer_loss_and_grads

    model = _model(name, weights, (0, 1), **kw)
    text, seg, img = (torch.as_tensor(batch[k]).long()
                      for k in ("text", "seg", "img"))
    if not kw:
        with torch.no_grad():
            logits = model(text, seg, img)
        loss, grads = transformer_loss_and_grads(model, text, seg, img)
        return dict(logits=logits, loss=float(loss), grads=dict(zip(
            [n for n, _ in model.named_parameters()], grads)))
    model.eval()
    with torch.inference_mode():
        logits, kvs = model.prefill(text, seg)
        caches = model.allocate_caches(kvs, text.shape[0])
        steps = [logits]
        for i in range(img.shape[1] - 1):
            steps.append(model.decode_step(img[:, i:i + 1], i, caches))
    tokens = sample_tokens(model, text, seg, torch.Generator().manual_seed(4),
                           guidance_scale=3.0, top_k=1)
    return dict(logits=torch.stack(steps, 1), tokens=tokens)


def _cli_configs(tmp):
    def write(name, raw):
        path = tmp / name
        path.write_text(json.dumps(raw))
        return str(path)

    def transformer(total, resume, mesh):
        return {"train": {"mode": "train_transformer", "total_steps": total,
                          "batch_size": 2, "log_period": 1, "uncond_p": 0.0,
                          "checkpoint_dir": str(tmp / f"ck_{mesh}"),
                          "resume": resume, "mesh": {"model": mesh},
                          "optimizer": T_OPT},
                "transformer": dict(T_CFG, remat=True, remat_policy="mlp"),
                "data": {"kind": "synthetic"}}

    seg = {"train": {"mode": "pretrain_segmentation", "total_steps": 3,
                     "batch_size": 2, "log_period": 1,
                     "checkpoint_dir": str(tmp / "seg_ck"),
                     "mesh": {"model": 2},
                     # Adam's eps 1e-3: see tests/test_torch_port_train.py
                     "optimizer": {"lr": 1e-3, "eps": 1e-3,
                                   "accumulate_grad": 2}},
           "model": dict(SEG_CFG, in_channels=159, out_channels=159,
                         codebook=SEG_CB),
           "data": {"kind": "synthetic", "resolution": 16}}
    one = dict(seg, train=dict(seg["train"], mesh={},
                               checkpoint_dir=str(tmp / "seg_one")))
    return dict(cwd=str(tmp), transformer=write("t2.json",
                                                transformer(2, False, 2)),
                resumed=write("t3.json", transformer(3, True, 2)),
                one=write("t2_one.json", transformer(2, False, 1)),
                one_resumed=write("t3_one.json", transformer(3, True, 1)),
                seg=write("seg.json", seg), seg_one=write("seg_one.json", one))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(tmp, world, model, cases):
    port = _free_port()
    out = tmp / f"w{world}"
    out.mkdir()
    procs = []
    for r in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             str(tmp / "inputs.pt"), str(out), str(model), cases],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs, out


def _collect(procs, out):
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{o}\n{e}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the 1 x 2 and 2 x 2 worlds, run JAX and one process of the
    port meanwhile, then collect the ranks."""
    tmp = tmp_path_factory.mktemp("tp")
    batch = _batch()
    params = {name: _params(name)[1] for name in VARIANTS}
    weights = {name: transformer_from_flax(
        {"params": params[name]},
        TransformerConfig(**dict(T_CFG, **VARIANTS[name])))
        for name in VARIANTS}
    spec = dict(batch, weights=weights)
    specs = dict(forward=spec, step=spec, decode=spec, cli=_cli_configs(tmp))
    torch.save(specs, tmp / "inputs.pt")
    two = _launch(tmp, 2, 2, "forward,step,decode,cli")
    four = _launch(tmp, 4, 2, "step")
    try:
        ref = dict(
            forward={n: _jax_forward(n, params[n], batch) for n in VARIANTS},
            step={(n, d): _jax_step(n, params[n], batch, d)
                  for n, d in (("mha", 1), ("mqa", 1), ("mha", 2))})
        one = dict(
            forward={n: _one_process(n, weights[n], batch)
                     for n in VARIANTS},
            decode={f"{n}_{c}": _one_process(n, weights[n], batch,
                                             kv_cache_dtype=c)
                    for n, c in [("mha", c) for c in CACHES]
                    + [("mqa", "int4")]})
    finally:
        ranks2 = _collect(*two)
        ranks4 = _collect(*four)
    return dict(jax=ref, one=one, ranks2=ranks2, ranks4=ranks4, tmp=tmp,
                specs=specs, weights=weights)


def _close(got, want, atol, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                   atol=atol, err_msg=f"{what}: {k}")


def _bitwise(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


def test_ranks_form_the_grid(runs):
    """``initialize`` lays rank r out at (r // model, r % model) over
    gloo."""
    for world, ranks in ((2, runs["ranks2"]), (4, runs["ranks4"])):
        for r, res in enumerate(ranks):
            assert res["backend"] == "gloo"
            assert res["grid"] == (world // 2, 2, r // 2, r % 2)


def test_repeat_initialize_keeps_the_grid(runs):
    """A repeat ``initialize`` with the same mesh keeps the grid and its
    groups; one with another shape raises ``ConfigError`` and makes no
    group."""
    for world, ranks in ((2, runs["ranks2"]), (4, runs["ranks4"])):
        for res in ranks:
            assert res["repeat_same"]
            assert res["repeat_other"] == (
                f"the ranks are laid out as a {world // 2} x 2 (data, model) "
                f"grid; a {world} x 1 mesh cannot be laid out again in this "
                "process")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax_under_tp(runs, variant):
    """Gathered logits of both ranks against JAX unsharded and under the
    1 x 2 TP mesh (atol 2e-4), and against one process of the port."""
    ref, tp = runs["jax"]["forward"][variant]
    one = runs["one"]["forward"][variant]
    np.testing.assert_allclose(tp, ref, atol=2e-4)
    for res in runs["ranks2"]:
        got = res["forward"][variant]["logits"].numpy()
        np.testing.assert_allclose(got, ref, atol=2e-4)
        np.testing.assert_allclose(got, tp, atol=2e-4)
        np.testing.assert_allclose(got, one["logits"].numpy(), atol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_gradients_match_one_process(runs, variant):
    """The vocab-parallel loss and every gathered gradient against one
    process: the k/v rows every rank holds (MQA) summed over the model
    group, rudalle_relax's sigma and maxima over it."""
    one = runs["one"]["forward"][variant]
    for res in runs["ranks2"]:
        got = res["forward"][variant]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        _close(got["grads"], one["grads"], 1e-5, f"{variant} gradient")
    assert runs["ranks2"][0]["forward"][variant]["loss"] == \
        runs["ranks2"][1]["forward"][variant]["loss"]


@pytest.mark.parametrize("variant,data", [("mha", 1), ("mqa", 1),
                                          ("mha", 2)])
def test_train_step_matches_jax_under_tp(runs, variant, data):
    """One step at data x 2 against JAX's ``make_transformer_train_step``
    under the TP mesh on the same global batch: the loss (rtol 1e-5), the
    gathered parameters after Adam (atol 1e-6); the replicated parameters
    bitwise equal on every rank."""
    loss, params = runs["jax"]["step"][(variant, data)]
    ranks = runs["ranks2"] if data == 1 else runs["ranks4"]
    for res in ranks:
        got = res["step"][variant]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        _close(got["params"], params, 1e-6, f"{variant} parameters")
    for res in ranks[1:]:
        _bitwise(res["step"][variant]["replicated"],
                 ranks[0]["step"][variant]["replicated"],
                 "replicated parameters")
        _bitwise(res["step"][variant]["params"],
                 ranks[0]["step"][variant]["params"], "gathered parameters")


@pytest.mark.parametrize("case", [f"mha_{c}" for c in CACHES] + ["mqa_int4"])
def test_decode_matches_one_process(runs, case):
    """Teacher-forced decode logits over the int8 / int4 lane caches (B3,
    B2) and the float cache (B9) against one process (atol 1e-5), the same
    bits on both ranks; greedy tokens equal one process's on both ranks."""
    one = runs["one"]["decode"][case]
    r0, r1 = (res["decode"][case] for res in runs["ranks2"])
    assert torch.equal(r0["logits"], r1["logits"])
    np.testing.assert_allclose(r0["logits"].numpy(), one["logits"].numpy(),
                               atol=1e-5)
    assert torch.equal(r0["tokens"], one["tokens"])
    assert torch.equal(r1["tokens"], one["tokens"])


def test_cli_checkpoint_is_the_full_tree(runs):
    """``--mode train_transformer`` at 1 x 2: rank 0 alone writes; its
    checkpoint is the full tree in JAX's layout, bitwise the
    ``gather_state`` of the ranks' shards (parameters and Adam's first
    moment), and loads strictly into one process's model."""
    from mas_tpu_torch.utils.checkpoint import checkpoint_path

    r0, r1 = (res["cli"] for res in runs["ranks2"])
    assert r0["writes"] == [2] and r1["writes"] == []
    cfg = TransformerConfig(**T_CFG, remat=True, remat_policy="mlp")
    payload = torch.load(checkpoint_path(str(runs["tmp"] / "ck_2"), 2),
                         weights_only=True)
    _bitwise(payload["model"], sharding.gather_state(
        [r0["shards"], r1["shards"]], cfg), "checkpoint")
    _bitwise(payload["optimizer"]["mu"], sharding.gather_state(
        [r0["mu"], r1["mu"]], cfg), "Adam mu")
    one = MakeAScene(cfg, fp32_params=True)
    one.load_state_dict(payload["model"], strict=True)
    for r, res in enumerate((r0, r1)):
        _bitwise(sharding.shard_state(payload["model"], cfg, r, 2),
                 res["shards"], f"rank {r}'s shard")


def test_cli_resume_under_tp_continues(runs):
    """The resumed run (step 3) on both ranks equals one process trained
    and resumed alike through the CLI on the same rows (atol 1e-6)."""
    from mas_tpu_torch import cli
    from mas_tpu_torch.utils.checkpoint import checkpoint_path

    r0, r1 = (res["cli"] for res in runs["ranks2"])
    assert r0["resumed_writes"] == [3] and r1["resumed_writes"] == []
    for out in (r0["stdout"], r1["stdout"]):
        assert "resumed from step 2" in out and "trained to step 3" in out
    os.chdir(runs["tmp"])
    sys.modules["torch.utils.tensorboard"] = None
    with contextlib.redirect_stdout(io.StringIO()):
        for name in ("one", "one_resumed"):
            cli.main(["--config", runs["specs"]["cli"][name],
                      "--device", "cpu"])
    one = torch.load(checkpoint_path(str(runs["tmp"] / "ck_1"), 3),
                     weights_only=True)["model"]
    tp = torch.load(checkpoint_path(str(runs["tmp"] / "ck_2"), 3),
                    weights_only=True)["model"]
    _close(tp, one, 1e-6, "resumed under TP vs one process")
    cfg = TransformerConfig(**T_CFG, remat=True, remat_policy="mlp")
    _bitwise(sharding.gather_state([r0["resumed"], r1["resumed"]], cfg), tp,
             "ranks' final shards")


def test_cli_seg_on_the_grid_matches_one_process(runs):
    """``--mode pretrain_segmentation`` at 1 x 2: the VQ model replicated
    over the model axis, both ranks on the same rows, bitwise equal to each
    other and equal to one process on that data share up to the CPU
    kernels' thread count (atol 1e-5, as ``test_torch_port_parallel.py``
    holds seg states)."""
    from mas_tpu_torch import cli
    from mas_tpu_torch.train import loop

    r0, r1 = (res["cli"] for res in runs["ranks2"])
    _bitwise(r0["seg"], r1["seg"], "ranks' seg state")
    assert torch.equal(r0["reservoir"], r1["reservoir"])
    states = []
    real = loop._loop

    def run(*a, **kw):
        states.append(real(*a, **kw))
        return states[-1]

    os.chdir(runs["tmp"])
    loop._loop = run
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["--config", runs["specs"]["cli"]["seg_one"],
                      "--device", "cpu"])
    finally:
        loop._loop = real
    _close(r0["seg"], {k: v.detach() for k, v in
                       states[0].model.state_dict().items()}, 1e-5,
           "seg: ranks vs one process")
    np.testing.assert_allclose(r0["reservoir"].numpy(),
                               states[0].vq_state.reservoir.numpy(),
                               atol=1e-5)


# --- in this process ----------------------------------------------------------

def _flax_key(path, stacked_layer=None):
    """A flax param path -> the port's ``state_dict`` key."""
    names = [str(getattr(p, "key", p)) for p in path]
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "embedding": "weight"}[names[-1]]
    if names[0].startswith("layer_") or stacked_layer is not None:
        i = stacked_layer if stacked_layer is not None else \
            int(names[0][len("layer_"):])
        rest = names[2:-1] if stacked_layer is not None else names[1:-1]
        return f"transformer.layers.{i}." + ".".join(rest + [leaf])
    top = {"final_ln": "transformer.final_ln", "logits_ln": "to_logits.0",
           "logits_dense": "to_logits.1"}.get(names[0], names[0])
    return f"{top}.{leaf}"


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("variant", ["mha", "gqa2"])
def test_sharding_rule_matches_jax_spec(variant, scan):
    """``split_dim`` of every key equals ``_spec_for_path`` of its flax
    leaf, on an unrolled and on a ``scan_layers`` (stacked) tree: the
    torch dim of the axis JAX gives to 'model' ([in, out] kernels are
    [out, in] weights; the stack axis never split)."""
    _, params = _params(variant)
    cfg = TransformerConfig(**dict(T_CFG, **VARIANTS[variant]))
    if scan:
        params = jax.tree.map(np.asarray,
                              stack_layer_params(params, cfg.num_layers))
    seen = set()

    def check(path, leaf):
        spec = _spec_for_path(path, leaf)
        names = [str(getattr(p, "key", p)) for p in path]
        stacked = names[:2] == ["layers", "layer"]
        axes = list(spec) + [None] * (leaf.ndim - len(spec))
        if stacked:
            assert axes[0] is None
            axes = axes[1:]
        want = axes.index("model") if "model" in axes else None
        if want is not None and len(axes) == 2:
            want = 1 - want           # [in, out] kernel -> [out, in] weight
        for i in (range(cfg.num_layers) if stacked else [None]):
            key = _flax_key(path, i)
            assert sharding.split_dim(key) == want, (key, spec)
            seen.add(key)

    jax.tree_util.tree_map_with_path(check, params)
    full = transformer_from_flax({"params": params},
                                 dataclasses.replace(cfg, scan_layers=scan))
    assert seen == set(full)
    assert {k for k in full if sharding.split_dim(k) is not None}


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("variant", ["mha", "gqa2", "mqa", "gqa3"])
def test_shard_gather_round_trip(variant, size):
    """``gather_state(shard_state(x))`` is x bitwise; each rank's qkv holds
    its query heads' rows and its kv heads' (all of them when the kv heads
    do not split), and loads into a model of that rank's shapes."""
    cfg = TransformerConfig(**dict(T_CFG, **VARIANTS[variant]))
    full = transformer_from_flax({"params": _params(variant)[1]}, cfg)
    parts = [sharding.shard_state(full, cfg, r, size) for r in range(size)]
    _bitwise(sharding.gather_state(parts, cfg), full, "round trip")
    hd, h, kv = cfg.head_dim, cfg.num_attn_heads, cfg.kv_heads
    q = full["transformer.layers.0.attn.qkv.weight"]
    for r, part in enumerate(parts):
        w = part["transformer.layers.0.attn.qkv.weight"]
        heads = h // size
        assert torch.equal(w[:heads * hd],
                           q[r * heads * hd:(r + 1) * heads * hd])
        kv_rows = w.shape[0] - heads * hd
        assert kv_rows == 2 * (kv // size if kv % size == 0 else kv) * hd
        MakeAScene(cfg, shard=(r, size)).load_state_dict(part)


def test_kv_heads_of_each_rank():
    """Which kv heads a rank's query heads read."""
    def of(kv, size, h=8):
        cfg = TransformerConfig(**dict(T_CFG, num_attn_heads=h,
                                       hidden_dim=8 * h), num_kv_heads=kv)
        return [sharding.kv_heads_of(cfg, r, size) for r in range(size)]

    assert of(8, 2) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert of(2, 2) == [[0], [1]]
    assert of(1, 2) == [[0], [0]]
    assert of(2, 4) == [[0], [0], [1], [1]]
    assert of(3, 2, h=12) == [[0, 0, 0, 0, 1, 1], [1, 1, 2, 2, 2, 2]]


def test_mesh_model_loads_and_head_count_refusal():
    """``mesh.model: 2`` loads in both packages; a model whose heads (or
    MLP width, or vocabulary) ``mesh.model`` does not divide is a
    ``ConfigError`` naming it."""
    for pkg in (TrainConfig, jconfig.TrainConfig):
        assert pkg(mesh={"model": 2}).mesh.model == 2
    cfg = TransformerConfig(**dict(T_CFG, num_attn_heads=4, hidden_dim=64))
    sharding.check_shardable(cfg, 2)
    with pytest.raises(ConfigError, match="num_attn_heads 4"):
        sharding.check_shardable(cfg, 3)
    with pytest.raises(ConfigError, match="num_attn_heads"):
        MakeAScene(cfg, shard=(0, 8))
