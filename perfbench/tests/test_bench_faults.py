"""Whole runs of each cell at a tiny size on the CPU, the chip check
skipped: sound, they come out correct under the cells' limits; with the
timed path broken underneath, ``correct`` comes out false."""

import pytest

from mas_tpu_torch.models import sampler, transformer, vqvae
from mas_tpu_torch.ops import decode_cache
from mas_tpu_torch.train import state, steps
from perfbench import run
from perfbench.tests import tiny

SEEDS = (11, 2 ** 33 + 5)


def _run(name, seed):
    return run.execute(name, seed, 0.0, False, "cpu", tiny.cell(name))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["sample_256.b384",
                                  "transformer_512.train_b8"])
def test_sound_run_is_correct(name, seed):
    out = _run(name, seed)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _altered_logits(monkeypatch):
    """The decode step's logits are scaled where they are produced."""
    inner = transformer.MakeAScene.decode_step
    monkeypatch.setattr(transformer.MakeAScene, "decode_step",
                        lambda self, *a: inner(self, *a) * 1.1)


def _state_unchanged(monkeypatch):
    """The decode step writes nothing into the cache."""
    monkeypatch.setattr(decode_cache, "write_quant_kv",
                        lambda *args, **kwargs: None)


def _altered_image(monkeypatch):
    """The VQ decoder's answer is scaled where it is produced."""
    inner = vqvae.VQModel.decode_code
    monkeypatch.setattr(vqvae.VQModel, "decode_code",
                        lambda self, idx: inner(self, idx) * 1.25)


def _guidance_dropped(monkeypatch):
    """The sampling head draws from the cond logits alone."""
    monkeypatch.setattr(sampler, "_guided",
                        lambda logits, batch, scale: logits[:batch])


def _token_altered(monkeypatch):
    """Each token is altered where the sampling head produces it."""
    inner = sampler._sample_logits

    def altered(logits, *args):
        return (inner(logits, *args) + 1) % logits.shape[-1]

    monkeypatch.setattr(sampler, "_sample_logits", altered)


@pytest.mark.parametrize("fault", [_altered_logits, _state_unchanged,
                                   _altered_image, _guidance_dropped,
                                   _token_altered])
def test_serving_faults_fail(monkeypatch, fault):
    fault(monkeypatch)
    assert not _run("sample_256.b384", SEEDS[0])["correct"]


def _adam_unchanged(monkeypatch):
    """The optimizer step returns the state unchanged."""
    monkeypatch.setattr(state.Adam, "step", lambda self, grads: True)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    inner = steps.transformer_loss

    def half(model, text, seg, img):
        b = text.shape[0] // 2
        return inner(model, text[:b], seg[:b], img[:b])

    monkeypatch.setattr(steps, "transformer_loss", half)


@pytest.mark.parametrize("fault", [_adam_unchanged, _half_batch])
def test_training_faults_fail(monkeypatch, fault):
    fault(monkeypatch)
    out = _run("transformer_512.train_b8", SEEDS[0])
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("name", ["sample_256.b384",
                                  "transformer_512.train_b8"])
def test_traced_run_reads_its_layers(name):
    # on the CPU the slice holds no device time: the span, operation and
    # optimizer readers find their numbers, the device's readers none
    out = run.execute(name, 3, 0.0, True, "cpu", tiny.cell(name))
    got = out["layer_metrics"]
    spans = {"sample_256.b384": {"decode_step_ms.b384", "prefill_ms.b384",
                                "vq_decode_ms.b384", "serve_mfu.b384"},
             "transformer_512.train_b8": {"adam_ms.train", "train_mfu"}}
    assert set(got) == spans[name]
    assert all(v > 0 for v in got.values())
