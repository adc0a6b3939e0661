"""Data-parallel training of the port (``mas_tpu_torch/parallel``) on CPU:
two gloo ranks against ``mas_tpu`` over a ``MeshConfig(data=2)`` mesh of
the conftest's fake CPU devices, on the same global batch.

The ranks are two processes of this file, started once for the whole
file with a launcher's environment (``WORLD_SIZE``, ``RANK``, ...), so
``parallel.distributed.initialize`` is the code under test; they never
import jax.  Each runs four cases and saves what it saw:

  * VQ-SEG, 4 micro-steps at accumulate_grad 2 from counter 0 (codebook
    init_steps 1): pass-through, reservoir collection, then k-means and
    quantization at counters 3 and 4;
  * one VQ-IMG GAN micro-step (disc_start 0, face loss on) with faces in
    rank 0's rows only;
  * the transformer's loss and gradient mean, then one step with CFG
    dropout forced (uncond_p 1);
  * ``--mode pretrain_segmentation`` through the CLI, then resumed.

The test process runs the JAX steps at data = 2 and the port's cases in
one process on the global batch while the ranks work.  Tolerances (fp32;
the mean of two rank means sums in another order than the global mean):
losses rtol 1e-5 (seg, transformer), GAN metrics rtol 1e-4 (the adaptive
weight is a ratio of gradient norms through VGG16's ReLUs, as in
``test_torch_port_gan_train.py``); parameters and BN statistics after an
Adam update atol 1e-5 (seg, GAN), 1e-6 (transformer); gradients atol
1e-5; reservoir and codebook against one process atol 1e-5.  The two
ranks end bitwise equal.  jax.random and torch draw different reservoir
positions, so reservoirs are compared with one process of the port and
only their fill with JAX.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

WORLD = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEG_CFG = dict(in_channels=8, out_channels=8, channels=(32, 32),
               num_res_blocks=1, attn_resolutions=(), resolution=16,
               z_channels=32, embed_dim=32)
SEG_CB = dict(codebook_size=16, codebook_dim=32, init_steps=1,
              reservoir_size=64, kmeans_iters=1, samples_per_image=8)
SEG_LOSS = dict(image_channels=8, face_channel_start=4, face_channel_end=6)
# Adam's eps 1e-3: see tests/test_torch_port_train.py
SEG_OPT = dict(lr=1e-3, eps=1e-3, accumulate_grad=2)
SEG_STEPS = 4


def _share(batch, share):
    if isinstance(batch, dict):
        return {k: torch.from_numpy(np.ascontiguousarray(v[share]))
                for k, v in batch.items()}
    return torch.from_numpy(np.ascontiguousarray(batch[share]))


def _snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def seg_case(spec, share):
    """``SEG_STEPS`` micro-steps of the port's seg step on rows ``share``
    of each global batch."""
    from mas_tpu_torch.models.codebook import codebook_init_state
    from mas_tpu_torch.models.vqvae import VQModel
    from mas_tpu_torch.train.state import VQTrainState, make_adam
    from mas_tpu_torch.train.steps import make_seg_train_step
    from mas_tpu_torch.utils.config import (OptimizerConfig, SegLossConfig,
                                            VQModelConfig)

    cfg = VQModelConfig(**SEG_CFG, codebook=SEG_CB)
    model = VQModel(cfg)
    model.load_state_dict(spec["weights"], strict=True)
    opt = make_adam(OptimizerConfig(**SEG_OPT), model.named_parameters(),
                    rescale_lr=False)
    state = VQTrainState(0, model, codebook_init_state(cfg.codebook), opt)
    step = make_seg_train_step(model, opt, SegLossConfig(**SEG_LOSS))
    gen = torch.Generator().manual_seed(7)
    out = dict(metrics=[], reservoir=[], filled=[])
    for i, seg in enumerate(spec["batches"]):
        m = step(state, _share(seg, share), gen)
        out["metrics"].append(dict(loss=float(m["loss"]),
                                   q_loss=float(m["q_loss"]),
                                   kmeans=m["kmeans_triggered"]))
        out["reservoir"].append(state.vq_state.reservoir.clone())
        out["filled"].append(state.vq_state.filled)
        if i == 1:
            out["after_update"] = _snapshot(model)
    out["final"] = _snapshot(model)
    return out


def gan_case(spec, share):
    """One GAN micro-step of the port on rows ``share``."""
    from mas_tpu_torch.losses.discriminator import PatchDiscriminator
    from mas_tpu_torch.losses.face_loss import FaceNet
    from mas_tpu_torch.losses.lpips import LPIPS
    from mas_tpu_torch.models.codebook import CodebookState
    from mas_tpu_torch.models.vqvae import VQModel
    from mas_tpu_torch.train.state import VQTrainState, make_adam
    from mas_tpu_torch.train.steps import make_img_train_step
    from mas_tpu_torch.utils.config import (OptimizerConfig, VQGANLossConfig,
                                            VQModelConfig)

    cfg = VQModelConfig(**spec["cfg"], codebook=spec["cb"])
    model = VQModel(cfg, fp32_params=True)
    model.load_state_dict(spec["model"], strict=True)
    disc = PatchDiscriminator(base_filters=8)
    disc.load_state_dict(spec["disc"], strict=True)
    lp, fn = LPIPS(), FaceNet(layers=(1, 1, 1, 1))
    lp.load_state_dict(spec["lpips"], strict=True)
    fn.load_state_dict(spec["face"], strict=True)
    lp.eval().requires_grad_(False)
    fn.eval().requires_grad_(False)
    opt_cfg = OptimizerConfig(**spec["opt"])
    state = VQTrainState(
        0, model, CodebookState(spec["counter"], torch.zeros(
            spec["cb"]["reservoir_size"], spec["cb"]["codebook_dim"]), 0),
        make_adam(opt_cfg, model.named_parameters()), disc,
        make_adam(opt_cfg, disc.named_parameters()))
    step = make_img_train_step(model, disc, state.opt, state.disc_opt,
                               VQGANLossConfig(**spec["loss"]), lp, fn)
    b = _share(spec["batch"], share)
    m = step(state, b["image"], b["bbox_obj"], b["bbox_face"],
             torch.Generator().manual_seed(0))
    return dict(metrics={k: float(v) for k, v in m.items()},
                filled=state.vq_state.filled, model=_snapshot(model),
                disc=_snapshot(disc))


def transformer_case(spec, share):
    """The loss and gradient mean of the port's transformer on rows
    ``share`` with the text dropped, then one step with uncond_p 1."""
    from mas_tpu_torch.models.transformer import MakeAScene
    from mas_tpu_torch.parallel.collectives import mean_, reduce_metrics
    from mas_tpu_torch.train.state import TransformerTrainState, make_adam
    from mas_tpu_torch.train.steps import (make_transformer_train_step,
                                           transformer_loss_and_grads)
    from mas_tpu_torch.utils.config import OptimizerConfig, TransformerConfig

    model = MakeAScene(TransformerConfig(**spec["cfg"]), fp32_params=True)
    model.load_state_dict(spec["weights"], strict=True)
    text, seg, img = (_share(spec[k], share).long()
                      for k in ("text", "seg", "img"))
    loss, grads = transformer_loss_and_grads(model, torch.zeros_like(text),
                                             seg, img)
    mean_(grads)
    names = [n for n, _ in model.named_parameters()]
    opt = make_adam(OptimizerConfig(**spec["opt"]),
                    model.named_parameters(), rescale_lr=False)
    state = TransformerTrainState(0, model, opt)
    step = make_transformer_train_step(model, opt, uncond_p=1.0)
    m = step(state, text, seg, img, torch.Generator().manual_seed(5))
    return dict(loss=float(reduce_metrics({"loss": loss})["loss"]),
                grads=dict(zip(names, grads)), step_loss=float(m["loss"]),
                uncond=bool(m["uncond"]), params=_snapshot(model))


def cli_case(spec, rank, out_dir):
    """The seg CLI on ``spec["config"]``, then resumed on
    ``spec["resumed"]``, in ``spec["cwd"]``, with TensorBoard hidden (the
    JSONL sink): the checkpoint writes of this rank, its stdout, its
    accumulation buffers and whether a resume restores its state
    bitwise."""
    sys.modules["torch.utils.tensorboard"] = None     # JSONL sink
    from mas_tpu_torch import cli
    from mas_tpu_torch.train import loop
    from mas_tpu_torch.utils.config import TrainConfig, VQModelConfig

    writes = []
    real_save = loop.save_checkpoint

    def save(directory, state):
        writes.append(state.step)
        return real_save(directory, state)

    loop.save_checkpoint = save
    states = []
    real_run = loop.run_pretrain_segmentation

    def run(*a, **kw):
        states.append(real_run(*a, **kw))
        return states[-1]

    loop.run_pretrain_segmentation = run
    os.chdir(spec["cwd"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--config", spec["config"], "--device", "cpu"])
        acc = {k: v.clone() for k, v in states[0].opt.acc.items()}
        raw = json.load(open(spec["config"]))
        restored = loop.build_seg_state(
            TrainConfig.from_dict(dict(raw["train"], resume=True)),
            VQModelConfig.from_dict(raw["model"]), "cpu")
        cli.main(["--config", spec["resumed"], "--device", "cpu"])
    first = states[0]
    same = all(torch.equal(restored.model.state_dict()[k], v)
               for k, v in first.model.state_dict().items())
    same &= torch.equal(restored.vq_state.reservoir,
                        first.vq_state.reservoir)
    same &= all(torch.equal(restored.opt.acc[k], v)
                for k, v in first.opt.acc.items())
    return dict(writes=writes, stdout=out.getvalue(), acc=acc,
                mini_step=first.opt.mini_step, restored_bitwise=bool(same),
                final=_snapshot(states[1].model))


CASES = {"seg": seg_case, "gan": gan_case, "transformer": transformer_case}


def rank_main(inputs: str, out_dir: str) -> None:
    """One rank: join the group from the environment, run every case on
    this rank's rows, save the results."""
    torch.set_num_threads(2)
    from mas_tpu_torch.parallel import distributed

    topo = distributed.initialize("cpu")
    r, n = topo["process_index"], topo["process_count"]
    specs = torch.load(inputs, weights_only=False)
    res = {name: case(specs[name], slice(r * specs[name]["rows"] // n,
                                         (r + 1) * specs[name]["rows"] // n))
           for name, case in CASES.items()}
    res["cli"] = cli_case(specs["cli"], r, out_dir)
    res["topology"] = {k: v for k, v in topo.items() if k != "device"}
    torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))


if __name__ == "__main__":
    rank_main(*sys.argv[1:])
    sys.exit(0)


# --- the test process (jax and the port) --------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from mas_tpu.losses.discriminator import PatchDiscriminator as JDisc  # noqa
from mas_tpu.losses.face_loss import FaceNet as JFaceNet  # noqa: E402
from mas_tpu.losses.lpips import LPIPS as JLPIPS  # noqa: E402
from mas_tpu.models.codebook import codebook_init_state  # noqa: E402
from mas_tpu.models.transformer import MakeAScene as JMakeAScene  # noqa
from mas_tpu.models.vqvae import VQModel as JVQModel  # noqa: E402
from mas_tpu.parallel.mesh import make_mesh  # noqa: E402
from mas_tpu.train.state import TransformerTrainState as JTState  # noqa
from mas_tpu.train.state import VQTrainState as JVQState  # noqa: E402
from mas_tpu.train.state import make_adam as jmake_adam  # noqa: E402
from mas_tpu.train.steps import make_img_train_step as jimg_step  # noqa
from mas_tpu.train.steps import make_seg_train_step as jseg_step  # noqa
from mas_tpu.train.steps import make_transformer_train_step  # noqa: E402
from mas_tpu.utils import config as jconfig  # noqa: E402

from mas_tpu_torch.parallel import distributed, mesh  # noqa: E402
from mas_tpu_torch.utils.config import (ConfigError, MeshConfig,  # noqa
                                        TrainConfig, VQModelConfig)
from mas_tpu_torch.utils.weights import (disc_from_flax,  # noqa: E402
                                         face_from_flax, lpips_from_flax,
                                         transformer_from_flax, vq_from_flax)

IMG_CFG = dict(in_channels=3, out_channels=3, resolution=32,
               channels=(32, 32, 64), attn_resolutions=(8,), z_channels=32,
               embed_dim=32)
IMG_CB = dict(codebook_size=16, codebook_dim=32, init_steps=2,
              reservoir_size=64, samples_per_image=4)
GAN_OPT = dict(lr=1e-3, eps=1e-3)
T_CFG = dict(num_layers=2, hidden_dim=64, num_attn_heads=2,
             image_vocab_size=96, seg_vocab_size=32, text_vocab_size=72,
             image_tokens_per_dim=4, seg_tokens_per_dim=4, text_length=8)
T_OPT = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(module, seed, *args, kernel_std=None, **kw):
    """Seeded numpy variables of the shapes ``module.init`` gives, without
    compiling it, from flax's initializer families: lecun-normal kernels
    (or N(0, ``kernel_std``), the discriminator's), zero biases, unit
    scales, BN statistics (0, 1), N(0, 0.02) embeddings, codebooks
    U(-1/K, 1/K), LPIPS's non-negative ``lin`` weights."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                **kw))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            v = rng.normal(0.0, kernel_std or np.prod(x.shape[:-1]) ** -0.5,
                           x.shape)
        elif name in ("scale", "var"):
            v = np.ones(x.shape)
        elif name == "codebook_embedding":
            v = rng.uniform(-1.0 / x.shape[0], 1.0 / x.shape[0], x.shape)
        elif name == "embedding":
            v = rng.normal(0.0, 0.02, x.shape)
        elif name.startswith("lin"):
            v = np.abs(rng.normal(0.0, 0.1, x.shape))
        else:
            v = np.zeros(x.shape)
        return v.astype(x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, _np_shapes(shapes))


def _np_shapes(tree):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)


def _mesh():
    return make_mesh(jconfig.MeshConfig(data=WORLD, model=1),
                     jax.devices()[:WORLD])


def _sharded(tree):
    sh = NamedSharding(_mesh(), P("data"))
    return jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), sh), tree)


def _vq_state(jmodel, jcfg, tx, variables, counter=0, disc=None):
    vq = codebook_init_state(jcfg.codebook)
    st = JVQState(step=jnp.zeros((), jnp.int32),
                  params=variables["params"],
                  batch_stats=variables["batch_stats"],
                  vq_state=vq.replace(counter=jnp.int32(counter)),
                  opt_state=tx.init(variables["params"]))
    if disc is not None:
        st = st.replace(disc_params=disc,
                        disc_opt_state=tx.init(disc["params"]))
    return st


def _seg():
    """(port spec, the JAX run at data = 2 of its first two micro-steps)."""
    jcfg = jconfig.VQModelConfig(**SEG_CFG,
                                 codebook=jconfig.CodebookConfig(**SEG_CB))
    jmodel = JVQModel(jcfg)
    tx = jmake_adam(jconfig.OptimizerConfig(**SEG_OPT), rescale_lr=False)
    variables = _init(jmodel, 0, jnp.zeros((1, 16, 16, 8)))
    cfg = VQModelConfig(**SEG_CFG, codebook=SEG_CB)
    rng = np.random.default_rng(1)
    batches = [np.eye(8, dtype=np.float32)[rng.integers(0, 8, (4, 16, 16))]
               for _ in range(SEG_STEPS)]
    spec = dict(rows=4, batches=batches,
                weights=vq_from_flax(variables, cfg))

    def run():
        step = jseg_step(jmodel, tx, jconfig.SegLossConfig(**SEG_LOSS),
                         donate=False)
        s, metrics = _vq_state(jmodel, jcfg, tx, variables), []
        for i in range(2):
            s, m = step(s, _sharded(batches[i]), jax.random.PRNGKey(10 + i))
            metrics.append({k: float(m[k]) for k in ("loss", "q_loss")})
        return dict(metrics=metrics, filled=int(s.vq_state.filled),
                    state=vq_from_flax(_np({"params": s.params,
                                            "batch_stats": s.batch_stats}),
                                       cfg))

    return spec, run


def _gan():
    """One GAN micro-step in the quantized phase (no k-means), disc_start
    0, the face loss on, faces only in image 0 (rank 0's row): port spec
    and the JAX run at data = 2."""
    loss = dict(disc_start=0, face_loss=True)
    jcfg = jconfig.VQModelConfig(**IMG_CFG,
                                 codebook=jconfig.CodebookConfig(**IMG_CB))
    jmodel, jd = JVQModel(jcfg), JDisc(base_filters=8)
    jlp, jfn = JLPIPS(), JFaceNet(layers=(1, 1, 1, 1))
    x = jnp.zeros((1, 32, 32, 3))
    variables = _init(jmodel, 0, x)
    # a codebook at the latents' scale, as a trained one (tests/
    # test_torch_port_gan_train.py)
    variables["params"]["codebook_embedding"] = np.random.default_rng(
        0).standard_normal((16, 32)).astype(np.float32)
    d_vars = _init(jd, 1, x, train=False, kernel_std=0.02)
    lp_vars = _init(jlp, 2, x, x)
    fn_vars = _init(jfn, 3, jnp.zeros((1, 64, 64, 3)))
    tx = jmake_adam(jconfig.OptimizerConfig(**GAN_OPT))
    cfg = VQModelConfig(**IMG_CFG, codebook=IMG_CB)
    b = dict(image=np.random.default_rng(4).uniform(
                 0, 1, (2, 32, 32, 3)).astype(np.float32),
             bbox_obj=np.array([[[2, 3, 20, 28], [0, 0, 0, 0]],
                                [[8, 1, 30, 17], [4, 4, 12, 30]]],
                               np.float32),
             bbox_face=np.array([[[6, 5, 22, 23], [0, 0, 0, 0]],
                                 [[0, 0, 0, 0], [0, 0, 0, 0]]], np.float32))
    spec = dict(rows=2, cfg=IMG_CFG, cb=IMG_CB, opt=GAN_OPT, loss=loss,
                counter=jcfg.codebook.q_re_end, batch=b,
                model=vq_from_flax(variables, cfg),
                disc=disc_from_flax(d_vars), lpips=lpips_from_flax(lp_vars),
                face=face_from_flax(fn_vars))

    def run():
        step = jimg_step(jmodel, jd, tx, tx, jconfig.VQGANLossConfig(**loss),
                         jlp, face_model=jfn, vq_impl="jnp", donate=False)
        st = _vq_state(jmodel, jcfg, tx, variables, jcfg.codebook.q_re_end,
                       disc=d_vars)
        s, m = step(st, _sharded(b), {"lpips": lp_vars, "face": fn_vars},
                    jax.random.PRNGKey(1))
        return dict(metrics={k: float(v) for k, v in m.items()},
                    filled=int(s.vq_state.filled),
                    model=vq_from_flax(_np({"params": s.params,
                                            "batch_stats": s.batch_stats}),
                                       cfg),
                    disc=disc_from_flax(_np(s.disc_params)))

    return spec, run


def _transformer():
    """The transformer's loss, gradients and one step, CFG dropout forced:
    port spec and the JAX run at data = 2."""
    from mas_tpu_torch.utils.config import TransformerConfig

    jmodel = JMakeAScene(jconfig.TransformerConfig(**T_CFG))
    cfg = TransformerConfig(**T_CFG)
    params = _init(jmodel, 5, jnp.zeros((1, cfg.text_length), jnp.int32),
                   jnp.zeros((1, cfg.seg_length), jnp.int32),
                   jnp.zeros((1, cfg.image_length), jnp.int32))["params"]
    r = np.random.default_rng(4)
    text = r.integers(1, cfg.text_vocab_size - cfg.text_length,
                      (4, cfg.text_length)).astype(np.int32)
    seg = r.integers(0, cfg.seg_vocab_size, (4, cfg.seg_length)).astype(
        np.int32)
    img = r.integers(0, cfg.image_vocab_size, (4, cfg.image_length)).astype(
        np.int32)
    spec = dict(rows=4, cfg=T_CFG, opt=T_OPT, text=text, seg=seg, img=img,
                weights=transformer_from_flax({"params": params}, cfg))

    def loss_fn(p, t, s, i):
        logits = jmodel.apply({"params": p}, t, s, i).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, i[..., None], -1))

    def run():
        sh = _sharded(dict(text=np.zeros_like(text), seg=seg, img=img))
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            params, sh["text"], sh["seg"], sh["img"])
        tx = jmake_adam(jconfig.OptimizerConfig(**T_OPT), rescale_lr=False)
        s = JTState(step=jnp.zeros((), jnp.int32), params=params,
                    opt_state=tx.init(params))
        t = _sharded(dict(text=text, seg=seg, img=img))
        s, m = make_transformer_train_step(jmodel, tx, uncond_p=1.0,
                                           donate=False)(
            s, t["text"], t["seg"], t["img"], jax.random.PRNGKey(5))
        return dict(loss=float(loss), step_loss=float(m["loss"]),
                    uncond=bool(m["uncond"]),
                    grads=transformer_from_flax(_np({"params": grads}), cfg),
                    params=transformer_from_flax(_np({"params": s.params}),
                                                 cfg))

    return spec, run


def _cli(tmp):
    """Tiny seg configs for the CLI case: 3 micro-steps at accumulate_grad
    2 (saves at 2 and, half way through an accumulation, at 3), then
    resumed to 4."""
    def write(total, resume):
        raw = {"train": {"mode": "pretrain_segmentation",
                         "total_steps": total, "batch_size": 2,
                         "log_period": 1, "save_period": 2,
                         "checkpoint_dir": str(tmp / "ck"), "resume": resume,
                         "mesh": {"data": WORLD},
                         "optimizer": {"lr": 1e-3, "accumulate_grad": 2}},
               "model": dict(SEG_CFG, in_channels=159, out_channels=159,
                             codebook=SEG_CB),
               "data": {"kind": "synthetic", "resolution": 16}}
        path = tmp / f"cli_{total}.json"
        path.write_text(json.dumps(raw))
        return str(path)

    return dict(cwd=str(tmp), config=write(3, False), resumed=write(4, True))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the two ranks, run JAX at data = 2 and the port's single
    process on the global batches meanwhile, then collect the ranks."""
    tmp = tmp_path_factory.mktemp("parallel")
    specs, jax_runs = {}, {}
    for name, make in (("seg", _seg), ("gan", _gan),
                       ("transformer", _transformer)):
        specs[name], jax_runs[name] = make()
    specs["cli"] = _cli(tmp)
    torch.save(specs, tmp / "inputs.pt")
    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, WORLD_SIZE=str(WORLD), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(tmp / "inputs.pt"),
             str(tmp)], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        ref = {name: run() for name, run in jax_runs.items()}
        one = {name: case(specs[name], slice(None))
               for name, case in CASES.items()}
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return dict(specs=specs, jax=ref, one=one, ranks=ranks, tmp=tmp)


def _close(got, want, atol, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                   atol=atol, err_msg=f"{what}: {k}")


def _bitwise(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


def test_ranks_join_one_gloo_group(runs):
    """``initialize`` under the launcher's environment: rank r of 2, one
    device each, gloo on the CPU."""
    for r, res in enumerate(runs["ranks"]):
        assert res["topology"] == dict(process_index=r, process_count=WORLD,
                                       local_devices=1, global_devices=WORLD,
                                       backend="gloo")


def test_seg_steps_match_jax_at_data_2(runs):
    """The first two micro-steps (pass-through, then collection and the
    Adam update) of each rank against JAX on the global batch: losses,
    parameters and SyncBatchNorm statistics, the reservoir's fill."""
    want = runs["jax"]["seg"]
    for res in (r["seg"] for r in runs["ranks"]):
        for got, m in zip(res["metrics"], want["metrics"]):
            np.testing.assert_allclose(got["loss"], m["loss"], rtol=1e-5)
            assert got["q_loss"] == m["q_loss"] == 0.0
        assert res["filled"][1] == want["filled"] == 4 * SEG_CB[
            "samples_per_image"]
        _close(res["after_update"], want["state"], 1e-5, "seg state")
    assert not torch.equal(runs["ranks"][0]["seg"]["after_update"][
        "quant_conv.1.running_mean"], runs["specs"]["seg"]["weights"][
        "quant_conv.1.running_mean"])


def test_seg_two_ranks_match_one_process(runs):
    """All four micro-steps (k-means and quantization at counters 3 and 4)
    against one process of the port on the global batch; both ranks end
    with the same parameters, reservoir and codebook, bit for bit."""
    one = runs["one"]["seg"]
    r0, r1 = (r["seg"] for r in runs["ranks"])
    assert [m["kmeans"] for m in r0["metrics"]] == [False, False, True, True]
    for res in (r0, r1):
        for got, m in zip(res["metrics"], one["metrics"]):
            np.testing.assert_allclose(got["loss"], m["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["q_loss"], m["q_loss"],
                                       rtol=1e-5)
        assert res["filled"] == one["filled"] == [0, 32, 64, 64]
        for got, want in zip(res["reservoir"], one["reservoir"]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
        _close(res["final"], one["final"], 1e-5, "seg final")
    _bitwise(r0["final"], r1["final"], "ranks' seg state")
    for a, b in zip(r0["reservoir"], r1["reservoir"]):
        assert torch.equal(a, b)
    assert r0["metrics"] == r1["metrics"]


def test_gan_step_matches_jax_at_data_2(runs):
    """One GAN micro-step, faces in rank 0's rows only: every metric —
    the adaptive weight and the face term (a sum over the global batch's
    faces) among them — the VQ model's and the discriminator's parameters
    after their Adam updates and both models' BN statistics.  JAX's
    discriminator BatchNorm takes its statistics over the global batch
    (a batch of 1 per replica would not give these running statistics)."""
    want = runs["jax"]["gan"]
    for res in (r["gan"] for r in runs["ranks"]):
        assert set(res["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        assert res["metrics"]["face_loss"] > 0
        assert res["filled"] == want["filled"] == 2 * IMG_CB[
            "samples_per_image"]
        _close(res["model"], want["model"], 1e-5, "VQ model")
        _close(res["disc"], want["disc"], 1e-5, "discriminator")


def test_gan_two_ranks_match_one_process(runs):
    one = runs["one"]["gan"]
    r0, r1 = (r["gan"] for r in runs["ranks"])
    for res in (r0, r1):
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        _close(res["model"], one["model"], 1e-5, "VQ model")
        _close(res["disc"], one["disc"], 1e-5, "discriminator")
    _bitwise(r0["model"], r1["model"], "ranks' VQ model")
    _bitwise(r0["disc"], r1["disc"], "ranks' discriminator")
    assert r0["metrics"] == r1["metrics"]


def test_transformer_step_matches_jax_at_data_2(runs):
    """CFG dropout forced: the loss and every gradient mean against
    ``jax.value_and_grad`` on the global batch, then one step's loss and
    parameters against ``make_transformer_train_step``."""
    want = runs["jax"]["transformer"]
    for res in (r["transformer"] for r in runs["ranks"]):
        np.testing.assert_allclose(res["loss"], want["loss"], atol=1e-5)
        _close(res["grads"], want["grads"], 1e-5, "gradient")
        np.testing.assert_allclose(res["step_loss"], want["step_loss"],
                                   atol=1e-5)
        assert res["uncond"] and want["uncond"]
        _close(res["params"], want["params"], 1e-6, "parameters")


def test_transformer_two_ranks_match_one_process(runs):
    one = runs["one"]["transformer"]
    r0, r1 = (r["transformer"] for r in runs["ranks"])
    for res in (r0, r1):
        np.testing.assert_allclose(res["step_loss"], one["step_loss"],
                                   rtol=1e-6)
        _close(res["grads"], one["grads"], 1e-6, "gradient")
        _close(res["params"], one["params"], 1e-6, "parameters")
    _bitwise(r0["params"], r1["params"], "ranks' parameters")
    _bitwise(r0["grads"], r1["grads"], "ranks' gradients")


def test_cli_rank0_writes_and_both_ranks_resume(runs):
    """Through the CLI: rank 0 alone writes the checkpoints (steps 2 and
    3) and the metrics file and prints the metric lines; the half-way
    accumulation of step 3 is the same on both ranks before it is saved;
    the checkpoint restores each rank's state bitwise; the resumed run
    continues on both ranks."""
    r0, r1 = (res["cli"] for res in runs["ranks"])
    assert r0["writes"] == [2, 3, 4] and r1["writes"] == []
    lines = lambda out: [json.loads(s) for s in out.splitlines()
                         if s.startswith("{")]
    assert [e["step"] for e in lines(r0["stdout"])] == [1, 2, 3, 4]
    assert lines(r1["stdout"]) == []
    assert "multi-process topology" in r0["stdout"]
    assert "multi-process topology" not in r1["stdout"]
    for out in (r0["stdout"], r1["stdout"]):
        assert "resumed from step 3" in out and "trained to step 4" in out
    logs = runs["tmp"] / "logs"
    logged = [json.loads(s) for s in open(logs / "metrics.jsonl")]
    assert [e["step"] for e in logged] == [1, 2, 3, 4]
    assert os.listdir(logs) == ["metrics.jsonl"]
    assert sorted(os.listdir(runs["tmp"] / "ck")) == [
        f"step_{s:08d}.pt" for s in (2, 3, 4)]
    assert r0["mini_step"] == r1["mini_step"] == 1
    _bitwise(r0["acc"], r1["acc"], "accumulation")
    assert any(float(v.abs().max()) > 0 for v in r0["acc"].values())
    assert r0["restored_bitwise"] and r1["restored_bitwise"]
    _bitwise(r0["final"], r1["final"], "ranks' state after the resume")


# --- in this process ----------------------------------------------------------

def test_initialize_without_launcher_is_a_noop(monkeypatch):
    """No launcher environment: no process group, one process, JAX's keys
    (``tests/test_parallel.py``), rank 0 primary, a barrier that returns."""
    from mas_tpu.parallel.distributed import initialize as jinitialize

    for key in distributed.LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    info = distributed.initialize("cpu")
    assert not torch.distributed.is_initialized()
    assert set(jinitialize()) | {"device"} == set(info)
    assert (info["process_index"], info["process_count"],
            info["global_devices"], info["backend"]) == (0, 1, 1, None)
    assert info["device"] == torch.device("cpu")
    assert distributed.is_primary() and distributed.world_size() == 1
    distributed.barrier()


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("kind", ["webdataset", "local_npz"])
def test_rank_input_matches_jax(tmp_path, monkeypatch, kind, index):
    """Process ``index`` of 2 reads the same rows in both packages: its
    shards of the webdataset, its stride of each local_npz epoch
    (``jax.process_index`` / ``process_count`` patched for JAX)."""
    from mas_tpu.cli import _data_iter
    from mas_tpu_torch.cli import data_iter
    from test_torch_port_data import (_seg_cfg, assert_same, shards,
                                      write_local, write_processed_shard)

    if kind == "webdataset":
        shards(tmp_path)
        for k in (2, 3):
            write_processed_shard(str(tmp_path / "shards" / f"{k:03d}.tar"),
                                  4, k)
        cfg = {"kind": kind, "shards": str(tmp_path / "shards"),
               "resolution": 32, "max_boxes": 2}
    else:
        img_dir, pre = write_local(tmp_path, n=5)
        cfg = {"kind": kind, "image_dir": img_dir, "preprocessed_dir": pre,
               "resolution": 24, "seed": 5, "prefetch": 1}
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    got = data_iter(cfg, 2, _seg_cfg(159), index, 2)
    want = _data_iter(cfg, "pretrain_segmentation", 2)
    got = [next(got) for _ in range(3)]
    want = [next(want) for _ in range(3)]
    assert_same(got, want)
    other = data_iter(cfg, 2, _seg_cfg(159), 1 - index, 2)
    assert not np.array_equal(next(other)["image"], got[0]["image"])


def test_mesh_config_and_rank_batch_match_jax():
    """``mesh.data`` -1 and 2 and ``mesh.model`` 2 load in both packages;
    a transformer whose heads ``mesh.model`` does not divide is the port's
    ``ConfigError``; ``MeshConfig.shape`` and the per-rank batch raise
    JAX's ``ConfigError``s; a batch that does not tile the data axis
    raises JAX's message unless ``allow_replicated_batch``."""
    from mas_tpu_torch.parallel.sharding import check_shardable
    from mas_tpu_torch.utils.config import TransformerConfig

    for data in (-1, 2):
        for pkg in (TrainConfig, jconfig.TrainConfig):
            assert pkg(mesh={"data": data}).mesh.data == data
    for pkg in (TrainConfig, jconfig.TrainConfig):
        assert pkg(mesh={"model": 2}).mesh.model == 2
    with pytest.raises(ConfigError, match="num_attn_heads 2"):
        check_shardable(TransformerConfig(**T_CFG), 4)
    for data, model, n in ((-1, 1, 4), (2, 1, 2), (-1, 2, 4), (3, 1, 4)):
        try:
            want = jconfig.MeshConfig(data=data, model=model).shape(n)
        except jconfig.ConfigError as e:
            with pytest.raises(ConfigError, match=str(e)):
                MeshConfig(data=data, model=model).shape(n)
        else:
            assert MeshConfig(data=data, model=model).shape(n) == want
    cfg = TrainConfig(batch_size=3, mesh={"data": 2})
    assert mesh.rank_batch(cfg, 2) == 3
    assert mesh.rank_batch(TrainConfig(batch_size=3, mesh={"data": 4}),
                           4) == 3
    with pytest.raises(ConfigError, match="does not cover 3 devices"):
        mesh.rank_batch(cfg, 3)
    assert mesh.batch_is_sharded(3, 2, 2, False)
    with pytest.raises(ValueError, match="does not tile the data axis"):
        mesh.batch_is_sharded(3, 1, 2, False)
    assert not mesh.batch_is_sharded(3, 1, 2, True)
    assert TrainConfig(allow_replicated_batch=True).allow_replicated_batch


class _Writer:
    """Stands in for ``SummaryWriter``: records what it is given."""

    def __init__(self, log_dir):
        self.log_dir, self.scalars = log_dir, []

    def add_scalar(self, key, value, step):
        self.scalars.append((key, value, step))

    def add_image(self, *args, **kwargs):
        pass

    def flush(self):
        pass

    def close(self):
        pass


@pytest.mark.parametrize("process_index", [0, 1])
@pytest.mark.parametrize("use_tensorboard", [True, False])
@pytest.mark.parametrize("installed", [True, False])
def test_logger_sink_matches_jax(tmp_path, monkeypatch, installed,
                                 use_tensorboard, process_index):
    """The port's ``Logger`` picks the sink JAX's picks under the same
    arguments, with ``torch.utils.tensorboard`` importable (a recording
    stand-in) or not: TensorBoard, else metrics.jsonl, and nothing on a
    process other than 0."""
    import types

    from mas_tpu.utils.logging import Logger as JLogger
    from mas_tpu_torch.utils.logging import Logger

    tb = None
    if installed:
        tb = types.ModuleType("torch.utils.tensorboard")
        tb.SummaryWriter = _Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", tb)
    mine = Logger(str(tmp_path / "port"), process_index, 2, use_tensorboard)
    ref = JLogger(str(tmp_path / "jax"), process_index, 2, use_tensorboard)
    for logger in (mine, ref):
        logger.log(step=2, loss=np.float32(1.5))
        logger.close()
    assert (mine.writer is None) == (ref.writer is None)
    assert (mine.writer is not None) == (installed and use_tensorboard
                                         and process_index == 0)
    if process_index:
        assert not (tmp_path / "port").exists()
        assert not (tmp_path / "jax").exists()
    elif ref.writer is not None:
        assert mine.writer.scalars == ref.writer.scalars == [
            ("loss", 1.5, 2)]
        assert os.listdir(tmp_path / "port") == []
    else:
        got, want = (json.loads((tmp_path / w / "metrics.jsonl").read_text())
                     for w in ("port", "jax"))
        assert (got["step"], got["loss"]) == (want["step"], want["loss"])
