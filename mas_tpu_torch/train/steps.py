"""Train steps, as ``mas_tpu/train/steps.py``.

``make_seg_train_step`` (VQ-SEG): encode in training mode (BN batch
statistics), ``quantize_train``, decode, weighted BCE + codebook loss,
backward, the optimizer micro-step, and *then* the k-means write-back into
the codebook when this micro-step re-initialized it.  On such a micro-step
the codebook gets a zero gradient: the centroids it was quantized with are
detached.

``make_transformer_train_step``: CFG text dropout, the image-token
cross-entropy, backward, the optimizer micro-step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
from torch.nn import functional as F

from ..data.segmap import one_hot_seg_packed
from ..losses.seg import bce_loss_with_quant
from ..models.codebook import CodebookState, quantize_train
from ..models.transformer import MakeAScene
from ..models.vqvae import VQModel
from ..utils.config import SegLossConfig
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
        return metrics

    return step


def transformer_loss(model: MakeAScene, text: torch.Tensor,
                     seg: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the fp32 image-position logits against the
    image tokens (``mas_tpu/train/steps.py:266-270``)."""
    logits = model(text, seg, img)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           img.reshape(-1).long())


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
        return dict(loss=loss, uncond=drop)

    return step
