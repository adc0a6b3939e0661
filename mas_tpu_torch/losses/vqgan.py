"""VQ-IMG composite loss (taming-style VQGAN), as
``mas_tpu/losses/vqgan.py``.

  generator:     pixelloss_weight * L1 + perceptual_weight * object-aware
                 LPIPS + face loss + d_weight * disc_factor * (-mean D(rec))
                 + codebook_weight * q_loss
  discriminator: disc_factor * hinge(D(real), D(fake))

The adaptive d_weight = ||dnll/dW|| / (||dg/dW|| + 1e-4), clipped to
[0, 1e4], detached, times ``disc_weight``, where W is the decoder's final
conv weight (the fp32 master).  JAX takes both gradients by re-running the
final conv on the stop-gradient trunk; the trunk does not depend on W, so
two ``torch.autograd.grad`` calls on the step's own graph
(``retain_graph``) give the same gradients without a re-run.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..utils.config import VQGANLossConfig
from .discriminator import adopt_weight, generator_loss, hinge_d_loss
from .face_loss import face_loss
from .lpips_object import lpips_with_object


class PerceptualFns(NamedTuple):
    """The frozen towers and the discriminator as callables: lpips(real,
    fake) -> [B]; disc(x) -> patch logits; facenet(x) -> 5 taps, or None
    without the face term."""

    lpips: Callable
    disc: Callable
    facenet: Optional[Callable] = None


def nll_loss_fn(fns: PerceptualFns, cfg: VQGANLossConfig,
                images: torch.Tensor, recon: torch.Tensor,
                bbox_obj: torch.Tensor) -> torch.Tensor:
    """pixelloss_weight * mean L1 + perceptual_weight * mean LPIPS of the
    gradient-scaled recon."""
    l1 = (images.float() - recon.float()).abs().mean()
    p = lpips_with_object(fns.lpips, images, recon, bbox_obj,
                          cfg.object_weight).mean()
    return cfg.pixelloss_weight * l1 + cfg.perceptual_weight * p


def _grad_norm(loss: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    (g,) = torch.autograd.grad(loss, weight, retain_graph=True)
    return torch.linalg.vector_norm(g.float())


def generator_step_loss(fns: PerceptualFns, cfg: VQGANLossConfig,
                        images: torch.Tensor, recon: torch.Tensor,
                        q_loss: torch.Tensor, step: int,
                        bbox_obj: torch.Tensor, bbox_face: torch.Tensor,
                        last_layer: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The generator's loss with the adaptive GAN weight.  ``recon``
    [B, H, W, 3] must depend on ``last_layer`` (the decoder's final conv
    weight) through the final conv.  Returns ``loss`` and the metrics
    ``nll_loss``, ``g_loss``, ``face_loss``, ``d_weight``,
    ``disc_factor``."""
    nll = nll_loss_fn(fns, cfg, images, recon, bbox_obj)
    f_loss = torch.zeros((), device=recon.device)
    if cfg.face_loss and fns.facenet is not None:
        f_loss = face_loss(fns.facenet, images, recon, bbox_face)
    g = generator_loss(fns.disc(recon))
    d_weight = (_grad_norm(nll, last_layer)
                / (_grad_norm(g, last_layer) + 1e-4))
    d_weight = d_weight.clamp(0.0, 1e4).detach() * cfg.disc_weight
    disc_factor = adopt_weight(cfg.disc_factor, step, cfg.disc_start)
    loss = (nll + d_weight * disc_factor * g
            + cfg.codebook_weight * q_loss.float().mean() + f_loss)
    return dict(loss=loss, nll_loss=nll.detach(), g_loss=g.detach(),
                face_loss=f_loss.detach(), d_weight=d_weight,
                disc_factor=disc_factor)


def discriminator_step_loss(disc: Callable, cfg: VQGANLossConfig,
                            images: torch.Tensor, recon: torch.Tensor,
                            step: int) -> Dict[str, torch.Tensor]:
    """disc_factor * hinge loss on the detached real and fake batches,
    real first; ``disc(x)`` updates the running statistics in turn."""
    logits_real = disc(images.detach())
    logits_fake = disc(recon.detach())
    disc_factor = adopt_weight(cfg.disc_factor, step, cfg.disc_start)
    return dict(loss=disc_factor * hinge_d_loss(logits_real, logits_fake),
                logits_real=logits_real.detach().mean(),
                logits_fake=logits_fake.detach().mean())
