"""Train steps, as ``mas_tpu/train/steps.py``.

``make_seg_train_step`` (VQ-SEG): encode in training mode (BN batch
statistics), ``quantize_train``, decode, weighted BCE + codebook loss,
backward, the optimizer micro-step, and *then* the k-means write-back into
the codebook when this micro-step re-initialized it.  On such a micro-step
the codebook gets a zero gradient: the centroids it was quantized with are
detached.

``make_img_train_step`` (VQ-IMG, the VQGAN's two optimizers): the
generator micro-step as the seg one, with the VQGAN generator loss
(``losses/vqgan.py``: L1, object-aware LPIPS, face loss, the adaptively
weighted GAN term, codebook loss) over ``decode_trunk`` /
``decode_final``, the discriminator run on batch statistics whose update
is discarded and no gradient reaching it; then the discriminator
micro-step on the detached reconstruction, its running statistics updated
by the real batch, then the fake one.

``make_transformer_train_step``: CFG text dropout, the image-token
cross-entropy, backward, the optimizer micro-step.

``make_seg_eval_step``: the eval-mode forward (BN running statistics,
``quantize_eval``) without gradients.

Under data parallelism each rank steps on its own rows: BatchNorm
statistics, the reservoir and the adaptive GAN weight span the data group
(``models/``, ``losses/``), Adam applies the gradient mean over it
(``train/state.py``), and the returned scalars are the means over it
(``parallel.collectives.reduce_metrics``), the global batch's values.
Under tensor parallelism the transformer's loss is the vocab-parallel
cross-entropy (``parallel.collectives.vocab_parallel_cross_entropy``),
the same value on every rank of the model group.  Every rank draws from
the same generator in the same order, so CFG dropout's one draw a step
agrees across the grid.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.nn import functional as F

from ..data.segmap import one_hot_seg_packed
from ..losses.discriminator import PatchDiscriminator
from ..losses.seg import bce_loss_with_quant
from ..losses.vqgan import (PerceptualFns, discriminator_step_loss,
                            generator_step_loss)
from ..models.codebook import CodebookState, quantize_train
from ..models.transformer import MakeAScene
from ..models.vqvae import VQModel
from ..parallel.collectives import (reduce_metrics,
                                    vocab_parallel_cross_entropy)
from ..utils.config import SegLossConfig, VQGANLossConfig
from .state import Adam, TransformerTrainState, VQTrainState


def _grads(loss: torch.Tensor, model: torch.nn.Module) -> List[torch.Tensor]:
    """d loss / d parameter, in ``model.named_parameters()`` order; zeros
    for a parameter the loss does not reach."""
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def seg_loss_and_grads(model: VQModel, vq_state: CodebookState,
                       seg: torch.Tensor, generator: torch.Generator,
                       loss_cfg: SegLossConfig = SegLossConfig()
                       ) -> Tuple[torch.Tensor, Dict, List[torch.Tensor]]:
    """Forward and backward of one micro-step on seg [B, H, W, C] ->
    (loss, aux, gradients in ``model.named_parameters()`` order).  Updates
    the BN running statistics and the reservoir in place."""
    z = model.encode_latent(seg, train=True)
    z_q, q_loss, idx, vq_state, emb_wb, triggered = quantize_train(
        z, model.quantize.embedding.weight, vq_state, model.cfg.codebook,
        generator)
    recon = model.decode_latent(z_q)
    loss = bce_loss_with_quant(q_loss, seg, recon, loss_cfg)
    grads = _grads(loss, model)
    aux = dict(q_loss=q_loss.detach(), latent=z.detach(), indices=idx,
               vq_state=vq_state, emb_writeback=emb_wb,
               kmeans_triggered=triggered)
    return loss.detach(), aux, grads


def make_seg_train_step(model: VQModel, opt: Adam,
                        loss_cfg: SegLossConfig = SegLossConfig(),
                        from_packed_labels: bool = False) -> Callable:
    """Returns ``step(state, seg, generator) -> metrics``, which advances
    ``state`` in place.  ``seg``: [B, H, W, 159] float targets, or with
    ``from_packed_labels`` int16 [B, H, W, 4] label maps expanded on the
    device.  ``metrics`` holds ``loss``, ``q_loss``, ``kmeans_triggered``
    and, on a k-means micro-step, the ``centroids`` written back."""

    def step(state: VQTrainState, seg: torch.Tensor,
             generator: torch.Generator) -> Dict:
        if from_packed_labels:
            seg = one_hot_seg_packed(seg)
        model.train()
        loss, aux, grads = seg_loss_and_grads(model, state.vq_state, seg,
                                              generator, loss_cfg)
        opt.step(grads)
        triggered = aux["kmeans_triggered"]
        if triggered:
            with torch.no_grad():
                model.quantize.embedding.weight.copy_(aux["emb_writeback"])
        state.step += 1
        state.vq_state = aux["vq_state"]
        metrics = dict(loss=loss, q_loss=aux["q_loss"],
                       kmeans_triggered=triggered)
        if triggered:
            metrics["centroids"] = aux["emb_writeback"]
        return reduce_metrics(metrics)

    return step


def make_seg_eval_step(model: VQModel) -> Callable:
    """Returns ``step(seg) -> (recon, q_loss)``: the model's eval forward
    under ``torch.no_grad()`` (``mas_tpu/train/steps.py::
    make_seg_eval_step``)."""

    def step(seg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            return model(seg)

    return step


def to_float_image(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> fp32 [0, 1]; float images pass through."""
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images


def img_generator_loss_and_grads(
        model: VQModel, disc: PatchDiscriminator, lpips: torch.nn.Module,
        facenet: Optional[torch.nn.Module], vq_state: CodebookState,
        images: torch.Tensor, bbox_obj: torch.Tensor,
        bbox_face: torch.Tensor, step_no: int, generator: torch.Generator,
        loss_cfg: VQGANLossConfig) -> Tuple[Dict, Dict, List[torch.Tensor]]:
    """Forward and backward of the generator's micro-step on float
    images [B, H, W, 3] -> (metrics, aux, gradients in
    ``model.named_parameters()`` order).  The discriminator runs on batch
    statistics, their update discarded; ``facenet`` None drops the face
    term.  Updates the VQ model's BN running statistics and the reservoir
    in place."""
    z = model.encode_latent(images, train=True)
    z_q, q_loss, idx, vq_state, emb_wb, triggered = quantize_train(
        z, model.quantize.embedding.weight, vq_state, model.cfg.codebook,
        generator)
    recon = model.decode_final(model.decode_trunk(z_q))
    fns = PerceptualFns(
        lpips=lpips, facenet=facenet,
        disc=lambda x: disc(x, train=True, update_stats=False))
    m = generator_step_loss(fns, loss_cfg, images, recon, q_loss, step_no,
                            bbox_obj, bbox_face, model.last_layer)
    grads = _grads(m["loss"], model)
    m["loss"] = m["loss"].detach()
    aux = dict(q_loss=q_loss.detach(), latent=z.detach(),
               recon=recon.detach(), indices=idx, vq_state=vq_state,
               emb_writeback=emb_wb, kmeans_triggered=triggered)
    return m, aux, grads


def img_discriminator_loss_and_grads(
        disc: PatchDiscriminator, images: torch.Tensor, recon: torch.Tensor,
        step_no: int, loss_cfg: VQGANLossConfig
) -> Tuple[Dict, List[torch.Tensor]]:
    """The discriminator's micro-step: (metrics, gradients in
    ``disc.named_parameters()`` order); updates its running statistics."""
    m = discriminator_step_loss(lambda x: disc(x, train=True), loss_cfg,
                                images, recon, step_no)
    grads = _grads(m["loss"], disc)
    m["loss"] = m["loss"].detach()
    return m, grads


def make_img_train_step(model: VQModel, disc: PatchDiscriminator, opt: Adam,
                        disc_opt: Adam, loss_cfg: VQGANLossConfig,
                        lpips: torch.nn.Module,
                        facenet: Optional[torch.nn.Module] = None
                        ) -> Callable:
    """Returns ``step(state, image, bbox_obj, bbox_face, generator) ->
    metrics``, which advances ``state`` in place (``mas_tpu/train/
    steps.py::make_img_train_step``).  ``image``: [B, H, W, 3] uint8 or
    float; boxes [B, M, 4] padded.  ``lpips`` and ``facenet`` are the
    frozen towers (``facenet`` None, or ``loss_cfg.face_loss`` false,
    drops the face term).  ``metrics``: ``loss``, ``nll_loss``,
    ``g_loss``, ``face_loss``, ``d_weight``, ``disc_factor``, ``q_loss``,
    ``d_loss``, ``logits_real``, ``logits_fake``, ``kmeans_triggered``
    and, on a k-means micro-step, the ``centroids`` written back."""
    facenet = facenet if loss_cfg.face_loss else None

    def step(state: VQTrainState, image: torch.Tensor,
             bbox_obj: torch.Tensor, bbox_face: torch.Tensor,
             generator: torch.Generator) -> Dict:
        images = to_float_image(image)
        model.train()
        g_m, aux, grads = img_generator_loss_and_grads(
            model, disc, lpips, facenet, state.vq_state, images, bbox_obj,
            bbox_face, state.step, generator, loss_cfg)
        opt.step(grads)
        triggered = aux["kmeans_triggered"]
        if triggered:
            with torch.no_grad():
                model.quantize.embedding.weight.copy_(aux["emb_writeback"])
        d_m, d_grads = img_discriminator_loss_and_grads(
            disc, images, aux["recon"], state.step, loss_cfg)
        disc_opt.step(d_grads)
        state.step += 1
        state.vq_state = aux["vq_state"]
        metrics = dict(g_m, q_loss=aux["q_loss"], d_loss=d_m["loss"],
                       logits_real=d_m["logits_real"],
                       logits_fake=d_m["logits_fake"],
                       kmeans_triggered=triggered)
        if triggered:
            metrics["centroids"] = aux["emb_writeback"]
        return reduce_metrics(metrics)

    return step


def transformer_loss(model: MakeAScene, text: torch.Tensor,
                     seg: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the fp32 image-position logits against the
    image tokens (``mas_tpu/train/steps.py:266-270``); vocab-parallel on a
    tensor-parallel model."""
    logits = model(text, seg, img)
    logits, target = logits.reshape(-1, logits.shape[-1]), img.reshape(-1)
    if model.shard[1] > 1:
        return vocab_parallel_cross_entropy(logits, target)
    return F.cross_entropy(logits, target.long())


def transformer_loss_and_grads(model: MakeAScene, text: torch.Tensor,
                               seg: torch.Tensor, img: torch.Tensor
                               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    loss = transformer_loss(model, text, seg, img)
    return loss.detach(), _grads(loss, model)


def make_transformer_train_step(model: MakeAScene, opt: Adam,
                                uncond_p: float = 0.1,
                                start_uncond: int = 0) -> Callable:
    """Returns ``step(state, text, seg, img, generator) -> metrics``, which
    advances ``state`` in place (``mas_tpu/train/steps.py::
    make_transformer_train_step``).

    CFG dropout: one uniform draw per step from ``generator``; with
    probability ``uncond_p``, from step ``start_uncond`` on, the *whole
    batch's* text tokens become 0 (pad, remapped by the model), as the
    reference's one host-side ``random()`` per step.  The draw and the
    choice stay on the device.  ``metrics``: ``loss`` and ``uncond``."""

    def step(state: TransformerTrainState, text: torch.Tensor,
             seg: torch.Tensor, img: torch.Tensor,
             generator: torch.Generator) -> Dict:
        u = torch.rand((), generator=generator, device=generator.device)
        drop = (u < uncond_p) & (state.step >= start_uncond)
        text = torch.where(drop, torch.zeros_like(text), text)
        model.train()
        loss, grads = transformer_loss_and_grads(model, text, seg, img)
        opt.step(grads)
        state.step += 1
        return reduce_metrics(dict(loss=loss, uncond=drop))

    return step
