"""The port's VQ-IMG (VQGAN) loss towers vs the JAX package, on CPU: the
PatchGAN discriminator and the GAN loss heads, LPIPS and its two torch
checkpoint layouts, the object-aware gradient weighting, the face crop,
FaceNet, the face loss and its torch checkpoint conversion.

Inputs are numpy arrays from a seed; weights are the JAX towers' own
(``jax.random`` init, BN statistics drawn from numpy), crossed to the port
by ``utils/weights.py``.  fp32 throughout.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mas_tpu.losses import discriminator as jdisc
from mas_tpu.losses import lpips as jlpips
from mas_tpu.losses import lpips_object as jobject

from mas_tpu_torch.losses import discriminator, face_loss, lpips, \
    lpips_object
from mas_tpu_torch.utils.weights import (disc_from_flax, face_from_flax,
                                         lpips_from_flax)

# the package's __init__ re-exports a function named face_loss
jface = importlib.import_module("mas_tpu.losses.face_loss")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _random_stats(stats, seed):
    """BN running statistics drawn from numpy: mean N(0, 0.1), var
    U(0.5, 1.5), so eval mode reads something other than (0, 1)."""
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (r.uniform(0.5, 1.5, a.shape) if a.ndim and a.min() == 1
                   else r.normal(0, 0.1, a.shape)).astype(np.float32),
        _np(stats))


def _nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


# --- discriminator -----------------------------------------------------------

def _disc_pair(seed=0):
    jmodel = jdisc.PatchDiscriminator(base_filters=8)
    x = np.random.default_rng(seed).random((2, 32, 32, 3), np.float32)
    variables = _np(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    variables["batch_stats"] = _random_stats(variables["batch_stats"], seed)
    model = discriminator.PatchDiscriminator(base_filters=8)
    model.load_state_dict(disc_from_flax(variables), strict=True)
    return jmodel, variables, model, x


def test_discriminator_matches_jax_train_and_eval():
    """32^2, base_filters 8, n_layers 3: train-mode logits and the updated
    running statistics, then eval-mode logits; fp32 atol 1e-5, rtol 1e-5
    (convolutions summed in another order)."""
    jmodel, variables, model, x = _disc_pair()
    jout, upd = jmodel.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    out = model(torch.from_numpy(x), train=True)
    assert out.shape == (2, 2, 2, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    state = model.state_dict()
    for name, s in _np(upd["batch_stats"]).items():
        for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(state[f"{name}.{key}"].numpy(),
                                       s[leaf], atol=1e-6, rtol=1e-5,
                                       err_msg=f"{name} {leaf}")
    variables = {"params": variables["params"],
                 "batch_stats": _np(upd["batch_stats"])}
    jeval = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        ev = model(torch.from_numpy(x))
    np.testing.assert_allclose(ev.numpy(), np.asarray(jeval), atol=1e-5,
                               rtol=1e-5)


def test_discriminator_batch_stats_without_update():
    """``update_stats=False``: the same logits as a train-mode call and the
    running statistics untouched, bitwise."""
    _, _, model, x = _disc_pair(1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    a = model(torch.from_numpy(x), train=True, update_stats=False)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    b = model(torch.from_numpy(x), train=True)
    assert torch.equal(a, b)
    assert not torch.equal(model.bn_1.running_mean,
                           before["bn_1.running_mean"])


def test_discriminator_init_families():
    """Seeded init: conv weights N(0, 0.02), biases 0, BN scale N(1, 0.02);
    checked by their moments over the 64-filter tower's 2.8M weights."""
    model = discriminator.PatchDiscriminator()
    model.init_weights_(torch.Generator().manual_seed(0))
    w = torch.cat([p.detach().flatten() for n, p in
                   model.named_parameters()
                   if n.endswith("weight") and n.startswith("conv")])
    assert w.numel() > 2_700_000
    assert abs(float(w.mean())) < 1e-4 and abs(float(w.std()) - 0.02) < 1e-4
    scale = torch.cat([model.get_submodule(f"bn_{n}").weight.detach()
                       for n in (1, 2, 3)])
    assert abs(float(scale.mean()) - 1.0) < 3e-3
    assert float(model.conv_0.bias.detach().abs().max()) == 0.0


def test_gan_loss_heads_match_jax():
    """hinge, vanilla and generator losses (fp32 rtol 1e-6) and
    ``adopt_weight`` at both sides of its gate (exact once rounded to
    JAX's fp32)."""
    r = np.random.default_rng(2)
    real, fake = (r.normal(0, 1.5, (2, 6, 6, 1)).astype(np.float32)
                  for _ in range(2))
    for fn, jfn in ((discriminator.hinge_d_loss, jdisc.hinge_d_loss),
                    (discriminator.vanilla_d_loss, jdisc.vanilla_d_loss)):
        np.testing.assert_allclose(
            float(fn(torch.from_numpy(real), torch.from_numpy(fake))),
            float(jfn(jnp.asarray(real), jnp.asarray(fake))), rtol=1e-6)
    np.testing.assert_allclose(
        float(discriminator.generator_loss(torch.from_numpy(fake))),
        float(jdisc.generator_loss(jnp.asarray(fake))), rtol=1e-6)
    for step in (0, 7, 8, 9):
        assert np.float32(discriminator.adopt_weight(0.7, step, 8)) == \
            jdisc.adopt_weight(0.7, jnp.int32(step), 8)
    assert discriminator.adopt_weight(1.0, 7, 8, value=0.25) == 0.25


# --- LPIPS -------------------------------------------------------------------

def _lpips_pair():
    x = np.random.default_rng(3).random((2, 32, 32, 3), np.float32)
    jmodel = jlpips.LPIPS()
    params = _np(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x),
                             jnp.asarray(x)))["params"]
    r = np.random.default_rng(4)
    for i in range(5):                 # lin weights other than ones
        params[f"lin{i}"] = r.uniform(0.5, 1.5, params[f"lin{i}"].shape
                                      ).astype(np.float32)
    model = lpips.LPIPS()
    model.load_state_dict(lpips_from_flax(params), strict=True)
    return jmodel, params, model


def test_lpips_matches_jax():
    """Full VGG16 widths at 32^2 (taps down to 2^2), two pairs: [B]
    distances, fp32 rtol 1e-5."""
    jmodel, params, model = _lpips_pair()
    r = np.random.default_rng(5)
    real, fake = (r.random((2, 32, 32, 3), np.float32) for _ in range(2))
    want = jmodel.apply({"params": params}, jnp.asarray(real),
                        jnp.asarray(fake))
    with torch.no_grad():
        got = model(torch.from_numpy(real), torch.from_numpy(fake))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def _slice_of(idx):
    """The reference LPIPS slice holding torchvision features index idx."""
    return 1 + sum(idx >= b for b in (4, 9, 16, 23))


@pytest.mark.parametrize("layout", ["features", "slice"])
def test_lpips_torch_checkpoint_layouts(layout):
    """A torchvision-layout state_dict (``features.{i}.*``) and a reference
    LPIPS one (``vgg.slice{k}.{i}.*``), each with ``lin{k}.model.1.weight``,
    convert to the same port state as JAX's converter (bitwise, through
    ``lpips_from_flax``) and load strict."""
    _, _, model = _lpips_pair()
    state = model.state_dict()
    torch_state = {}
    for name, idx in zip(lpips._conv_names(), lpips._TORCH_CONV_IDX):
        prefix = (f"features.{idx}" if layout == "features"
                  else f"vgg.slice{_slice_of(idx)}.{idx}")
        for leaf in ("weight", "bias"):
            torch_state[f"{prefix}.{leaf}"] = state[f"vgg.{name}.{leaf}"]
    for i in range(5):
        torch_state[f"lin{i}.model.1.weight"] = \
            state[f"lin{i}"].T.reshape(1, -1, 1, 1)
    got = lpips.convert_torch_lpips_state(torch_state)
    want = lpips_from_flax(_np(jlpips.convert_torch_lpips_state(torch_state)))
    assert set(got) == set(state) == set(want)
    for k in state:
        assert torch.equal(got[k], state[k]), k
        assert torch.equal(want[k], state[k]), k
    fresh = lpips.LPIPS()
    fresh.load_state_dict(got, strict=True)


# --- object weighting --------------------------------------------------------

def test_box_weight_map_matches_jax():
    """Fractional, clipped and zero-area boxes; exact."""
    boxes = np.array([[[2.5, 3.0, 9.25, 7.0], [0, 0, 0, 0],
                       [10, 1, 16, 12]],
                      [[0, 0, 0, 0], [-3, 5, 4.5, 30], [6, 6, 6, 9]]],
                     np.float32)
    want = jobject.box_weight_map(jnp.asarray(boxes), 14, 17, 2.0)
    got = lpips_object.box_weight_map(torch.from_numpy(boxes), 14, 17, 2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scale_gradient_is_identity_with_weighted_cotangent():
    """Forward: x unchanged; backward: the cotangent times the map, in the
    cotangent's dtype, and no gradient to the weights."""
    r = np.random.default_rng(6)
    x = torch.from_numpy(r.normal(size=(2, 5, 7, 3)).astype(np.float32))
    x.requires_grad_()
    boxes = torch.tensor([[[1, 1, 4, 3]], [[0, 0, 0, 0]]], dtype=torch.float32)
    w = lpips_object.box_weight_map(boxes, 5, 7, 3.0).requires_grad_()
    cot = torch.from_numpy(r.normal(size=(2, 5, 7, 3)).astype(np.float32))
    y = lpips_object.scale_gradient(x, w)
    assert torch.equal(y, x)
    (y * cot).sum().backward()
    assert torch.equal(x.grad, cot * w.detach())
    assert w.grad is None


# --- face --------------------------------------------------------------------

@pytest.mark.parametrize("box", [
    (50.5, 60.25, 74.5, 84.25),    # 24 px: s = 10.7, interpolation
    (10.0, 5.0, 310.0, 305.0),     # 300 px: s = 0.85, antialiased
    (100.0, 40.0, 130.0, 300.0),   # tall box: s from its 30 px width
])
def test_crop_resize_face_matches_scale_and_translate(box):
    """One face from a 320^2 RGB image against ``jax.image.
    scale_and_translate`` (bilinear, antialias on): atol 1e-4."""
    img = np.random.default_rng(7).random((320, 320, 3), np.float32)
    want = jface.crop_resize_face(jnp.asarray(img),
                                  jnp.asarray(box, jnp.float32))
    got = face_loss.crop_resize_face(torch.from_numpy(img),
                                     torch.tensor(box))
    assert got.shape == (254, 254, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _face_pair():
    jmodel = jface.FaceNet(layers=(1, 1, 1, 1))
    x = np.zeros((1, 64, 64, 3), np.float32)
    variables = _np(jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    variables["batch_stats"] = _random_stats(variables["batch_stats"], 8)
    model = face_loss.FaceNet(layers=(1, 1, 1, 1))
    model.load_state_dict(face_from_flax(variables), strict=True)
    return jmodel, variables, model.eval()


def test_facenet_taps_match_jax():
    """layers (1, 1, 1, 1) at 70^2 (odd sizes through the ceil-mode pool):
    all five taps, max |d| <= 1e-4 * max |tap| (fp32, 16 convolutions)."""
    jmodel, variables, model = _face_pair()
    x = np.random.default_rng(9).random((2, 70, 70, 3), np.float32)
    want = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = _nchw_to_nhwc(g)
        assert g.shape == w.shape, i
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), i


@pytest.mark.parametrize("n_valid", [0, 1, 3])
def test_face_loss_matches_jax(n_valid):
    """Two images of 48^2, three box slots each, ``n_valid`` of them real
    faces (the rest zero-area): rtol 1e-4; no face gives exactly 0."""
    jmodel, variables, model = _face_pair()
    r = np.random.default_rng(10 + n_valid)
    images, recon = (r.random((2, 48, 48, 3), np.float32) for _ in range(2))
    boxes = np.zeros((2, 3, 4), np.float32)
    for k in range(n_valid):
        i, j = divmod(k, 3)
        x0, y0 = r.integers(0, 20, 2)
        side = r.integers(8, 28)
        boxes[i, j] = (x0, y0, x0 + side, y0 + side)
    want = float(jface.face_loss(lambda x: jmodel.apply(variables, x),
                                 jnp.asarray(images), jnp.asarray(recon),
                                 jnp.asarray(boxes)))
    with torch.no_grad():
        got = float(face_loss.face_loss(model, torch.from_numpy(images),
                                        torch.from_numpy(recon),
                                        torch.from_numpy(boxes)))
    if n_valid == 0:
        assert got == 0.0 and want == 0.0
    else:
        assert got > 0
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_convert_torch_face_state():
    """A VGGFace2-layout state_dict with a classifier and without
    ``num_batches_tracked``: the port's converter and JAX's (through
    ``face_from_flax``) give the same state, which loads strict."""
    _, _, model = _face_pair()
    state = model.state_dict()
    torch_state = {k: v for k, v in state.items()
                   if not k.endswith("num_batches_tracked")}
    torch_state["fc.weight"] = torch.zeros(8631, 2048)
    torch_state["fc.bias"] = torch.zeros(8631)
    got = face_loss.convert_torch_face_state(torch_state)
    want = face_from_flax(_np(jface.convert_torch_face_state(torch_state)))
    assert set(got) == set(state) == set(want)
    for k in state:
        assert torch.equal(got[k], state[k]), k
        assert torch.equal(want[k], state[k]), k
    face_loss.FaceNet(layers=(1, 1, 1, 1)).load_state_dict(got, strict=True)


def test_gan_modules_leave_jax_out():
    """The VQ-IMG modules import neither jax, flax, mas_tpu nor triton."""
    code = ("import sys, mas_tpu_torch.losses.discriminator, "
            "mas_tpu_torch.losses.lpips, mas_tpu_torch.losses.lpips_object, "
            "mas_tpu_torch.losses.face_loss, mas_tpu_torch.losses.vqgan, "
            "mas_tpu_torch.train.steps, mas_tpu_torch.train.loop, "
            "mas_tpu_torch.data.dataset, mas_tpu_torch.cli; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'mas_tpu', 'triton')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
