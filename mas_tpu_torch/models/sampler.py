"""Autoregressive sampling with KV caches and classifier-free guidance.

Counterpart of ``mas_tpu/models/sampler.py`` (default branch of
``sample_tokens``, plus ``sample_images``):

  * guidance by batch doubling: the conditional half keeps the text, the
    unconditional half gets all-pad text (remapped per position by the
    embedding), ``logits = uncond + scale * (cond - uncond)``;
  * int8/int4 caches allocated once at full length and written in place
    by every decode step (kernel B3) — nothing grows or is copied;
  * temperature, then top-k as select-k then categorical over the k
    values, with the exact ``torch.topk`` (the JAX ``approx=False`` path);
    random draws come from an explicit ``torch.Generator``.

The decode loop is a Python loop; capturing a step in a CUDA graph is
later work (ROADMAP A5).
"""

from __future__ import annotations

import torch

from .transformer import MakeAScene
from .vqvae import VQModel


def _sample_logits(logits: torch.Tensor, generator: torch.Generator,
                   temperature: float, top_k: int) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64)."""
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    if 0 < top_k < logits.shape[-1]:
        vals, idx = torch.topk(logits, top_k, dim=-1)
        j = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                              generator=generator)
        return torch.gather(idx, 1, j)[:, 0]
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


def _guided(logits_2b: torch.Tensor, batch: int,
            scale: float) -> torch.Tensor:
    if scale == 1.0:
        return logits_2b[:batch]
    cond, uncond = logits_2b[:batch], logits_2b[batch:]
    return uncond + scale * (cond - uncond)


@torch.inference_mode()
def sample_tokens(model: MakeAScene, text_tokens: torch.Tensor,
                  seg_tokens: torch.Tensor, generator: torch.Generator,
                  guidance_scale: float = 3.0, temperature: float = 1.0,
                  top_k: int = 0, cache_segment: int = 0) -> torch.Tensor:
    """Generate image tokens [B, image_length] (int64) from text + seg."""
    if cache_segment:
        raise NotImplementedError(
            "cache_segment is a TPU ablation, not ported to mas_tpu_torch "
            "(ROADMAP A5)")
    cfg = model.cfg
    cfg.check_decode_cache()
    b = text_tokens.shape[0]
    if guidance_scale != 1.0:
        text_all = torch.cat([text_tokens, torch.zeros_like(text_tokens)])
        seg_all = torch.cat([seg_tokens, seg_tokens])
    else:
        text_all, seg_all = text_tokens, seg_tokens
    copies = text_all.shape[0] // b

    logits, kvs = model.prefill(text_all, seg_all)
    caches = model.allocate_caches(kvs, text_all.shape[0])
    del kvs
    tok = _sample_logits(_guided(logits, b, guidance_scale), generator,
                         temperature, top_k)
    tokens = [tok]
    for step in range(cfg.image_length - 1):
        tok_in = tok.repeat(copies)[:, None]           # feed both halves
        logits = model.decode_step(tok_in, step, caches)
        tok = _sample_logits(_guided(logits, b, guidance_scale), generator,
                             temperature, top_k)
        tokens.append(tok)
    return torch.stack(tokens, dim=1)


@torch.inference_mode()
def sample_images(transformer: MakeAScene, vq_img: VQModel,
                  text_tokens: torch.Tensor, seg_tokens: torch.Tensor,
                  generator: torch.Generator, guidance_scale: float = 3.0,
                  temperature: float = 1.0, top_k: int = 0,
                  decode_chunk: int = 32) -> torch.Tensor:
    """text+seg tokens -> NHWC fp32 images: AR sampling, then VQ-IMG
    ``decode_code`` in chunks of ``decode_chunk`` images."""
    tokens = sample_tokens(transformer, text_tokens, seg_tokens, generator,
                           guidance_scale=guidance_scale,
                           temperature=temperature, top_k=top_k)
    d = transformer.cfg.image_tokens_per_dim
    grid = tokens.reshape(-1, d, d)
    step = decode_chunk or grid.shape[0]
    return torch.cat([vq_img.decode_code(grid[i:i + step])
                      for i in range(0, grid.shape[0], step)])
