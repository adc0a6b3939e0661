"""The port's data factory and tokenize path vs the JAX package, on CPU:
``preprocess_web`` (shard sink in a dir or a ``pipe:`` command, a failing
sink), ``preprocess_local`` and ``--mode preprocess_dataset`` with the
synthetic annotators, the TorchScript annotator, ``tokenize_batches``
with the two frozen VQ encoders, ``--mode train_transformer`` on the
processed shards, and what a token grid that does not match the
transformer does.

Processed shards are compared by their decoded members and arrays, never
their bytes: ``np.savez`` stamps zip entries with the time.  Tokens are
compared in fp32 with the weights carried across by ``vq_from_flax``.
"""

import io
import json
import os
import sys
import tarfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu.data import preprocess as jpreprocess

from mas_tpu_torch.data import preprocess
from mas_tpu_torch.utils.config import VQModelConfig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_data import SIZES, _jpeg, add_member  # noqa: E402
from test_torch_port_models import T_TINY  # noqa: E402

KINDS = ("panoptic", "human", "face")
NPZ_KEYS = {"seg_panoptic", "edge_panoptic", "box_things", "seg_human",
            "edge_human", "seg_face", "box_face"}


def write_raw_shards(d, n_shards=2, n=3):
    """Raw shards of JPEGs (SIZES in turn) and captions."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(40)
    for k in range(n_shards):
        with tarfile.open(os.path.join(d, f"raw{k}.tar"), "w") as tf:
            for i in range(n):
                h, w = SIZES[(k + i) % len(SIZES)]
                add_member(tf, f"{k}_{i:03d}.jpg", _jpeg(rng, h, w))
                add_member(tf, f"{k}_{i:03d}.txt", f"a scene {k} {i}".encode())
    return d


def decoded(path):
    """[(member name, bytes or {array name: array})] of a tar, in order."""
    out = []
    with tarfile.open(path) as tf:
        for m in tf:
            data = tf.extractfile(m).read()
            if m.name.endswith(".npz"):
                with np.load(io.BytesIO(data)) as z:
                    data = {k: z[k] for k in z.files}
            out.append((m.name, data))
    return out


def assert_same_members(a, b):
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        if isinstance(x, dict):
            assert set(x) == set(y) == NPZ_KEYS, name
            for k in x:
                assert x[k].dtype == y[k].dtype, (name, k)
                np.testing.assert_array_equal(x[k], y[k])
        else:
            assert x == y, name


def _synthetic(mod):
    return {k: mod.SyntheticAnnotator(k, seed=3) for k in KINDS}


def _run_cli_preprocess(tmp_path, cfg):
    from mas_tpu_torch.cli import main

    path = tmp_path / "preprocess.json"
    path.write_text(json.dumps({"train": {"mode": "preprocess_dataset"},
                                "preprocess": cfg}))
    assert main(["--config", str(path), "--device", "cpu"]) == 0


@pytest.mark.parametrize("mode", ["web", "local"])
def test_cli_preprocess_dataset_matches_jax(tmp_path, mode):
    """``--mode preprocess_dataset`` of the port (configs/preprocess_web.json
    with its paths in the test's dir; local mode over the same JPEGs)
    against ``mas_tpu``'s ``run_preprocessor``: the same shards, every
    sample read written with jpg, txt and the npz of seven keys, and the
    same info.state; the same npz triplets."""
    raw = write_raw_shards(str(tmp_path / "raw"))
    with open(os.path.join(os.path.dirname(__file__), "..", "configs",
                           "preprocess_web.json")) as f:
        cfg = json.load(f)["preprocess"]
    cfg["annotators"]["face"]["seed"] = 9
    if mode == "local":
        images = []
        for k in range(2):
            for name, data in decoded(os.path.join(raw, f"raw{k}.tar")):
                if name.endswith(".jpg"):
                    images.append(str(tmp_path / name))
                    with open(images[-1], "wb") as f:
                        f.write(data)
        cfg = dict(cfg, mode="local", images=images,
                   workers_per_annotator=2)
    outs = {}
    for who in ("port", "jax"):
        cfg_w = dict(cfg, shards=raw, out_dir=str(tmp_path / who))
        if who == "port":
            _run_cli_preprocess(tmp_path, cfg_w)
        else:
            jpreprocess.run_preprocessor(cfg_w)
        outs[who] = tmp_path / who
    if mode == "local":
        files = sorted(os.listdir(outs["port"]))
        assert files == sorted(os.listdir(outs["jax"]))
        assert len(files) == 6 * 3
        for f in files:
            with np.load(outs["port"] / f) as a, np.load(outs["jax"] / f) as b:
                assert a.files == b.files
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])
        return
    for k in range(2):
        got = decoded(outs["port"] / f"raw{k}.tar")
        assert_same_members(got, decoded(outs["jax"] / f"raw{k}.tar"))
        read = [n for n, _ in decoded(os.path.join(raw, f"raw{k}.tar"))]
        assert [n for n, _ in got if not n.endswith(".npz")] == read
        assert len(got) == 3 * 3
    # info.state: ``done`` and the shards are deterministic; each shard's
    # ``state`` entry is the "started" message of whichever annotator
    # process reported last, in either package, so hold it to that set
    state = json.loads((outs["port"] / "info.state").read_text())
    jstate = json.loads((outs["jax"] / "info.state").read_text())
    assert state["done"] == jstate["done"]
    assert set(state["state"]) == set(jstate["state"]) == set(state["done"])
    started = {f"{kind}:started" for kind in cfg["annotators"]}
    for entries in (state["state"], jstate["state"]):
        assert set(entries.values()) <= started, entries
    assert set(state["done"].values()) == {3}


def test_preprocess_web_pipe_sink_matches_jax(tmp_path):
    """Output shards streamed through a ``pipe:`` command: nothing lands in
    out_dir, and the piped shards equal JAX's."""
    raw = write_raw_shards(str(tmp_path / "raw"), n_shards=1)
    for who, mod in (("port", preprocess), ("jax", jpreprocess)):
        sink = tmp_path / f"sink_{who}"
        sink.mkdir()
        outs = mod.preprocess_web(raw, str(tmp_path / who), _synthetic(mod),
                                  out_url=f"pipe:cat > {sink}/{{name}}")
        assert outs == [f"pipe:cat > {sink}/raw0.tar"]
        assert not (tmp_path / who / "raw0.tar").exists()
    assert_same_members(decoded(tmp_path / "sink_port" / "raw0.tar"),
                        decoded(tmp_path / "sink_jax" / "raw0.tar"))


@pytest.mark.parametrize("where", ["call", "child"])
def test_failing_sink_raises_as_jax(tmp_path, where):
    """A sink command that fails raises, called directly and from the
    repack process of ``preprocess_web``, with JAX's error."""
    raw = write_raw_shards(str(tmp_path / "raw"), n_shards=1, n=1)
    for mod in (preprocess, jpreprocess):
        if where == "call":
            with pytest.raises(RuntimeError, match="repack sink command"):
                mod.repack_single_tar(os.path.join(raw, "raw0.tar"),
                                      str(tmp_path), "pipe:exit 3",
                                      ("panoptic",))
        else:
            with pytest.raises(RuntimeError, match="repack process"):
                mod.preprocess_web(raw, str(tmp_path / "out"),
                                   _synthetic(mod), out_url="pipe:exit 3")


class _Failing:
    """An annotator that raises on its second image."""

    def __init__(self):
        self.calls = 0

    def __call__(self, image):
        self.calls += 1
        if self.calls == 2:
            raise ValueError("annotator fault")
        return {"seg_face": np.zeros(image.shape[:2], np.uint8)}


@pytest.mark.parametrize("mode", ["web", "local"])
def test_failing_annotator_fails_the_run(tmp_path, mode):
    """An annotator worker that raises fails the run, after every process
    has ended, in local and web mode alike (``mas_tpu`` raises in local
    mode only)."""
    raw = write_raw_shards(str(tmp_path / "raw"), n_shards=2, n=2)
    anns = dict(_synthetic(preprocess), face=_Failing())
    with pytest.raises(RuntimeError, match="annotator worker"):
        if mode == "web":
            preprocess.preprocess_web(raw, str(tmp_path / "out"), anns)
        else:
            paths = []
            for k in range(2):
                for name, data in decoded(os.path.join(raw, f"raw{k}.tar")):
                    if name.endswith(".jpg"):
                        paths.append(str(tmp_path / name))
                        with open(paths[-1], "wb") as f:
                            f.write(data)
            preprocess.preprocess_local(paths, str(tmp_path / "out"), anns)


def test_torchscript_annotator_matches_jax(tmp_path):
    """A user's traced module on the CPU gives JAX's arrays; an annotator
    on a CUDA device makes the run's workers start by spawn."""
    class Ann(torch.nn.Module):
        def forward(self, x):
            seg = (x[0, 0] * 7).long() - 1
            return {"seg_panoptic": seg, "edges": (seg > 2).to(torch.uint8),
                    "box_things": x[0, :, :2, :2].reshape(-1, 4)}

    path = str(tmp_path / "ann.pt")
    torch.jit.trace(Ann(), torch.zeros(1, 3, 8, 8), strict=False).save(path)
    img = np.random.default_rng(50).random((12, 10, 3)).astype(np.float32)
    got = preprocess.TorchScriptAnnotator("panoptic", path, "cpu")(img)
    want = jpreprocess.TorchScriptAnnotator("panoptic", path)(img)
    assert set(got) == set(want) == {"seg_panoptic", "edges", "box_things"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    cuda = {"face": preprocess.TorchScriptAnnotator("face", path, "cuda:0")}
    assert preprocess._context(cuda).get_start_method() == "spawn"
    assert preprocess._context(_synthetic(preprocess)).get_start_method() \
        == jpreprocess.mp.get_start_method()


# --- tokenize and train -----------------------------------------------------

SEG_TINY = dict(in_channels=159, out_channels=159, channels=(32, 32, 64),
                resolution=32, attn_resolutions=(), z_channels=32,
                embed_dim=32, num_res_blocks=1)


def _vq_pair(in_channels, seed):
    """A JAX VQModel + variables and the port's with the same weights (a
    standard-normal codebook, so no distance is a near-tie)."""
    from mas_tpu.models.vqvae import VQModel as JVQModel
    from mas_tpu.utils.config import CodebookConfig as JCodebookConfig
    from mas_tpu.utils.config import VQModelConfig as JVQModelConfig
    from mas_tpu_torch.models.vqvae import VQModel
    from mas_tpu_torch.utils.weights import vq_from_flax

    cb = dict(codebook_size=64, codebook_dim=32)
    kw = dict(SEG_TINY, in_channels=in_channels, out_channels=in_channels)
    jmodel = JVQModel(JVQModelConfig(**kw, codebook=JCodebookConfig(**cb)))
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, in_channels))))
    variables["params"]["codebook_embedding"] = np.random.default_rng(
        seed).standard_normal((64, 32)).astype(np.float32)
    model = VQModel(VQModelConfig(**kw, codebook=cb)).eval()
    model.load_state_dict(vq_from_flax(variables, model.cfg), strict=True)
    return jmodel, variables, model


def test_tokenize_batches_match_jax():
    """Seg maps and uint8 / float images through both encoders, captions
    through the hash tokenizer: JAX's tokens, fp32."""
    from mas_tpu.data.segmap import assemble_seg_map
    from mas_tpu.data.tokenizer import HashWordTokenizer as JTokenizer
    from mas_tpu.train.loop import tokenize_batches as jtokenize
    from mas_tpu_torch.data.tokenizer import HashWordTokenizer
    from mas_tpu_torch.train.loop import tokenize_batches

    jseg, seg_vars, vq_seg = _vq_pair(159, 1)
    jimg, img_vars, vq_img = _vq_pair(3, 2)
    rng = np.random.default_rng(60)
    masks = np.stack([assemble_seg_map(
        rng.integers(-1, 133, (32, 32)), rng.integers(0, 2, (32, 32)),
        rng.integers(-1, 20, (32, 32)), rng.integers(0, 2, (32, 32)),
        rng.integers(0, 6, (32, 32))) for _ in range(2)])
    batches = [dict(mask=masks, image=rng.random((2, 32, 32, 3), np.float32),
                    caption=["a red bus", "Two dogs on grass"]),
               dict(mask=masks[::-1].copy(),
                    image=(rng.random((2, 32, 32, 3)) * 255).astype(
                        np.uint8))]
    got = list(tokenize_batches(batches, vq_seg, vq_img,
                                HashWordTokenizer(64, 8), "cpu"))
    want = list(jtokenize(iter(batches), jseg, seg_vars, jimg, img_vars,
                          JTokenizer(64, 8)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["text"].dtype == np.int32
        np.testing.assert_array_equal(g["text"], w["text"])
        for k in ("seg", "image"):
            assert g[k].shape == w[k].shape == (2, 256)
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    assert len(np.unique(want[0]["image"])) > 8


# a transformer whose seg and image grids are 4 x 4 (T_TINY), and VQ models
# that give 4 x 4 tokens from 32^2 data
VQ_GRID4 = dict(channels=(32, 32, 32, 32, 32), resolution=32,
                attn_resolutions=[], z_channels=8, embed_dim=8,
                num_res_blocks=1)


def test_cli_train_transformer_on_processed_shards(tmp_path, monkeypatch,
                                                   capsys):
    """raw shards -> --mode preprocess_dataset -> --mode train_transformer
    --device cpu on ``kind: webdataset`` for 2 steps (5 samples, batch 2:
    the one pass ends there and the progress is saved)."""
    from mas_tpu_torch.cli import main
    from mas_tpu_torch.utils import checkpoint

    monkeypatch.chdir(tmp_path)
    raw = write_raw_shards(str(tmp_path / "raw"), n_shards=1, n=5)
    _run_cli_preprocess(tmp_path, {"shards": raw,
                                   "out_dir": str(tmp_path / "proc")})
    vq = {k: {"model": dict(VQ_GRID4, in_channels=c, out_channels=c,
                            codebook={"codebook_size": n,
                                      "codebook_dim": 8})}
          for k, c, n in (("vq_seg", 159, T_TINY["seg_vocab_size"]),
                          ("vq_img", 3, T_TINY["image_vocab_size"]))}
    cfg = {"train": {"mode": "train_transformer", "total_steps": 10,
                     "batch_size": 2, "log_period": 1,
                     "checkpoint_dir": str(tmp_path / "ck"),
                     "optimizer": {"lr": 1e-3}},
           "transformer": T_TINY, **vq,
           "data": {"kind": "webdataset", "shards": str(tmp_path / "proc"),
                    "resolution": 32}}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(cfg))
    assert main(["--config", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    logged = [json.loads(line) for line in out.splitlines()
              if line.startswith("{")]
    assert [e["step"] for e in logged] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in logged)
    assert "trained to step 2" in out
    assert checkpoint.latest_step(str(tmp_path / "ck")) == 2


@pytest.mark.parametrize("seg_tokens", [64, 4])
def test_seg_grid_that_does_not_match_the_transformer(seg_tokens):
    """JAX raises nowhere: its step takes [B, 64] seg tokens for a 4 x 4
    grid with a NaN loss (the embeddings' out-of-range rows read as NaN)
    and [B, 4] with a finite one.  The port raises a ValueError naming the
    shape before the step, for both (on CUDA an out-of-range embedding
    index is a device-side assert)."""
    from mas_tpu.models.transformer import MakeAScene as JMakeAScene
    from mas_tpu.train.state import TransformerTrainState as JState
    from mas_tpu.train.state import make_adam as jmake_adam
    from mas_tpu.train.steps import make_transformer_train_step as jstep
    from mas_tpu.utils.config import OptimizerConfig as JOptimizerConfig
    from mas_tpu.utils.config import TransformerConfig as JTransformerConfig
    from mas_tpu_torch.train.loop import run_train_transformer
    from mas_tpu_torch.utils.config import TrainConfig, TransformerConfig

    cfg = JTransformerConfig(**T_TINY)
    jmodel = JMakeAScene(cfg)
    zeros = [jnp.zeros((1, n), jnp.int32)
             for n in (cfg.text_length, cfg.seg_length, cfg.image_length)]
    params = jmodel.init(jax.random.PRNGKey(0), *zeros)["params"]
    tx = jmake_adam(JOptimizerConfig(lr=1e-3), rescale_lr=False)
    state = JState(step=jnp.zeros((), jnp.int32), params=params,
                   opt_state=tx.init(params))
    batch = {"text": np.ones((2, cfg.text_length), np.int32),
             "seg": np.ones((2, seg_tokens), np.int32),
             "image": np.ones((2, cfg.image_length), np.int32)}
    _, metrics = jstep(jmodel, tx, uncond_p=0.0)(
        state, *map(jnp.asarray, batch.values()), jax.random.PRNGKey(1))
    assert bool(np.isfinite(float(metrics["loss"]))) == (seg_tokens < 16)
    want = (rf"seg tokens of shape \(2, {seg_tokens}\), the transformer "
            r"takes \[batch, 16\]")
    with pytest.raises(ValueError, match=want):
        run_train_transformer(
            TrainConfig.from_dict({"mode": "train_transformer",
                                   "total_steps": 1, "batch_size": 2}),
            TransformerConfig(**T_TINY), [batch], "cpu")
