"""Vector-quantizer codebook with the staged k-means bootstrap, as
``mas_tpu/models/codebook.py``.

The phase machine runs on the micro-step ``counter`` (a Python int, so
each phase is a plain ``if``):
  * counter > q_start_collect: sample ``samples_per_image`` latents per
    image into the reservoir (uniform random-slot eviction once full);
  * counter < q_init: latents pass through unquantized, q_loss is 0;
  * q_init <= counter < q_re_end, every q_re_step: k-means over the
    reservoir gives the codebook used for this micro-step, and the train
    step writes it into the embedding after the optimizer update;
  * from q_init on: quantize with kernel B5, straight-through estimator.

Under data parallelism the reservoir samples the global batch, as JAX's
global view does: every rank gathers all ranks' latents in rank order
and draws the same positions and slots from the shared generator; rank
0's written rows and k-means centroids are then broadcast, since CUDA's
``index_copy_`` (duplicate slots) and ``index_add_`` (k-means sums) pick
an order per run.  Every rank thus holds one reservoir and one codebook.

Known deviations from the reference, kept from the JAX package: eviction
replaces uniform random slots instead of concat + shuffle + truncate;
per-image latent sampling is with replacement; on a k-means micro-step the
codebook gets no gradient (the centroids are detached).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import nn

from ..ops.kmeans import kmeans
from ..ops.vq import vq_quantize
from ..parallel.collectives import active, broadcast_, gather_rows
from ..utils.config import CodebookConfig


def lookup(indices: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """indices [...] -> codebook vectors [..., D]."""
    return nn.functional.embedding(indices.long(), embedding)


class Codebook(nn.Module):
    """Holds the [K, D] codebook under the reference key
    ``quantize.embedding.weight``."""

    def __init__(self, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(codebook_size, codebook_dim)


@dataclass
class CodebookState:
    counter: int               # micro-steps taken
    reservoir: torch.Tensor    # [R, D] fp32 sampled latents
    filled: int                # valid rows of the reservoir


def codebook_init_state(cfg: CodebookConfig, device=None) -> CodebookState:
    return CodebookState(
        counter=0,
        reservoir=torch.zeros(cfg.reservoir_size, cfg.codebook_dim,
                              device=device),
        filled=0)


def codebook_init_embedding(codebook_size: int, codebook_dim: int,
                            generator: torch.Generator,
                            device=None) -> torch.Tensor:
    """uniform(-1/K, 1/K), as the reference."""
    k = codebook_size
    return torch.empty(k, codebook_dim, device=device).uniform_(
        -1.0 / k, 1.0 / k, generator=generator)


def _update_reservoir(state: CodebookState, z_img: torch.Tensor,
                      cfg: CodebookConfig,
                      generator: torch.Generator) -> CodebookState:
    """Sample latents of z_img [B, h*w, D] (every rank's rows) into the
    reservoir.  The reservoir is written in place (``index_copy_``): the
    state passed in and the one returned share it."""
    b, hw, d = z_img.shape
    s = min(cfg.samples_per_image, hw)
    dev = z_img.device
    pos = torch.randint(0, hw, (b, s), generator=generator, device=dev)
    samples = torch.gather(z_img, 1, pos[:, :, None].expand(b, s, d))
    samples = samples.reshape(b * s, d).detach().float()
    r = cfg.reservoir_size
    seq = state.filled + torch.arange(b * s, device=dev)
    rand = torch.randint(0, r, (b * s,), generator=generator, device=dev)
    slots = torch.where(seq < r, seq % r, rand)
    state.reservoir.index_copy_(0, slots, samples)
    if active():
        # a slot drawn twice keeps one writer, chosen per run on CUDA
        state.reservoir.index_copy_(
            0, slots, broadcast_(state.reservoir.index_select(0, slots)))
    return dataclasses.replace(state, filled=min(state.filled + b * s, r))


def quantize_eval(z: torch.Tensor, embedding: torch.Tensor):
    """z [..., D] -> (z_q, indices); no straight-through, no state."""
    return vq_quantize(z, embedding.to(z.dtype))


def kmeans_due(counter: int, cfg: CodebookConfig) -> bool:
    """True on the micro-steps that re-initialize the codebook."""
    return (cfg.q_init <= counter < cfg.q_re_end
            and (counter - cfg.q_init) % max(cfg.q_re_step, 1) == 0)


def quantize_train(z: torch.Tensor, embedding: torch.Tensor,
                   state: CodebookState, cfg: CodebookConfig,
                   generator: torch.Generator):
    """One training-mode quantization with the full phase schedule.

    z [B, h, w, D] latents after quant_conv; ``embedding`` the [K, D]
    codebook parameter.  Returns ``(z_q_st, q_loss, indices, new_state,
    emb_writeback, kmeans_triggered)``; ``emb_writeback`` (detached) is
    what the train step stores into the embedding after the optimizer
    update when ``kmeans_triggered``."""
    b, h, w, d = z.shape
    counter = state.counter + 1
    state = dataclasses.replace(state, counter=counter)
    if counter > cfg.q_start_collect:
        state = _update_reservoir(
            state, gather_rows(z.detach().float().reshape(b, h * w, d)), cfg,
            generator)
    triggered = kmeans_due(counter, cfg)
    emb_used = embedding
    if triggered:
        emb_used = broadcast_(kmeans(state.reservoir, generator,
                                     cfg.codebook_size,
                                     iters=cfg.kmeans_iters,
                                     n_valid=state.filled))
    if counter < cfg.q_init:
        z_q = z
        q_loss = torch.zeros((), dtype=z.dtype, device=z.device)
        idx = torch.zeros((b, h, w), dtype=torch.int32, device=z.device)
    else:
        zq, idx = vq_quantize(z, emb_used.to(z.dtype))
        zf, zqf = z.float(), zq.float()
        q_loss = ((zqf.detach() - zf).square().mean()
                  + cfg.beta * (zqf - zf.detach()).square().mean())
        z_q = z + (zq - z).detach()          # straight-through estimator
        q_loss = q_loss.to(z.dtype)
    return z_q, q_loss, idx, state, emb_used.detach(), triggered
