"""VQ autoencoder (VQ-SEG / VQ-IMG), as ``mas_tpu/models/vqvae.py``.

``VQModel`` holds the ``Encoder``, ``quant_conv`` (1x1 conv then
``SyncBatchNorm``), the codebook, the 1x1 ``post_quant_conv`` and the
``Decoder``.  Its ``state_dict`` uses the reference ``VQBASE`` keys
(``encoder.model.{i}.*``, ``quant_conv.{0,1}.*``, ``decoder.model.{i}.*``,
``post_quant_conv.*``, ``quantize.embedding.weight``), so a JAX tree
converted by ``utils/weights.py`` and a ``.pt`` written by the JAX
package's ``--mode export`` load with ``strict=True``.

Encoder: conv3x3 -> per stage {num_res_blocks x ResnetBlock (+Attn)} +
Downsample (len(channels)-2 times) -> ResnetBlock-Attn-ResnetBlock ->
GN-swish-conv.  Decoder: conv3x3 -> ResnetBlock-Attn-ResnetBlock -> per
stage {(num_res_blocks+1) x ResnetBlock (+Attn)} + Upsample ->
GN-swish-conv.  The ``nn.Sequential`` index orders replay the reference
construction (``encoder_layout``, ``decoder_layout``).  The reference's
separate Swish module after ``norm_out`` is fused into ``norm_out`` here,
and its index holds an ``nn.Identity`` so the later indices keep their
numbers.

``fp32_params=True`` (training) keeps the conv weights in fp32 and casts
them to the compute dtype at use (``layers.Conv2d``), as flax keeps fp32
params under a bf16 ``dtype``; otherwise a bf16 model casts them once
(serving).  ``decode_trunk`` / ``decode_final`` split the decoder before
its last conv, whose fp32 weight (``last_layer``) the VQGAN loss's
adaptive weight differentiates against.

Public tensors are NHWC, as in the JAX package.  Training-mode
quantization lives in the train step (``codebook.quantize_train``: it
carries the phase state and a generator).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ..utils.config import VQModelConfig
from ..utils.spans import span
from .codebook import Codebook, lookup, quantize_eval
from .layers import (AttnBlock, Downsample, GroupNormSwish, ResnetBlock,
                     SyncBatchNorm, Upsample, conv)


def compute_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def encoder_layout(cfg: VQModelConfig) -> List[Tuple[str, str]]:
    """[(kind, JAX module name)] per reference Sequential index, the
    replay of ``mas_tpu/utils/torch_import.py::_encoder_layout``."""
    plan = [("conv", "conv_in")]
    res = cfg.resolution
    for i in range(len(cfg.channels) - 1):
        for j in range(cfg.num_res_blocks):
            plan.append(("resnet", f"down_{i}_block_{j}"))
            if res in cfg.attn_resolutions:
                plan.append(("attn", f"down_{i}_attn_{j}"))
        if i < len(cfg.channels) - 2:
            plan.append(("down", f"down_{i}_downsample"))
            res //= 2
    plan += [("resnet", "mid_block_1"), ("attn", "mid_attn"),
             ("resnet", "mid_block_2"), ("norm", "norm_out"), ("skip", ""),
             ("conv", "conv_out")]
    return plan


def decoder_layout(cfg: VQModelConfig) -> List[Tuple[str, str]]:
    """[(kind, JAX module name)] per reference Sequential index."""
    ch_mult = cfg.channels[1:]
    n = len(ch_mult)
    res = cfg.resolution // 2 ** (n - 1)
    plan = [("conv", "conv_in"), ("resnet", "mid_block_1"),
            ("attn", "mid_attn"), ("resnet", "mid_block_2")]
    for i in reversed(range(n)):
        for j in range(cfg.num_res_blocks + 1):
            plan.append(("resnet", f"up_{i}_block_{j}"))
            if res in cfg.attn_resolutions:
                plan.append(("attn", f"up_{i}_attn_{j}"))
        if i > 0:
            plan.append(("up", f"up_{i}_upsample"))
        res *= 2
    plan += [("norm", "norm_out"), ("skip", ""), ("conv", "conv_out")]
    return plan


class Encoder(nn.Module):
    def __init__(self, cfg: VQModelConfig):
        super().__init__()
        block_in = cfg.channels[0]
        layers = []
        for kind, name in encoder_layout(cfg):
            if kind == "conv" and name == "conv_in":
                layers.append(conv(cfg.in_channels, block_in))
            elif kind == "resnet":
                cout = (block_in if name.startswith("mid")
                        else cfg.channels[int(name.split("_")[1]) + 1])
                layers.append(ResnetBlock(block_in, cout, cfg.dropout))
                block_in = cout
            elif kind == "attn":
                layers.append(AttnBlock(block_in))
            elif kind == "down":
                layers.append(Downsample(block_in))
            elif kind == "norm":
                layers.append(GroupNormSwish(block_in))
            elif kind == "skip":
                layers.append(nn.Identity())
            else:
                layers.append(conv(block_in, cfg.z_channels))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class Decoder(nn.Module):
    def __init__(self, cfg: VQModelConfig):
        super().__init__()
        ch_mult = cfg.channels[1:]
        block_in = ch_mult[-1]
        stage_out = {f"up_{i}": c for i, c in enumerate(ch_mult)}
        layers = []
        for kind, name in decoder_layout(cfg):
            if kind == "conv" and name == "conv_in":
                layers.append(conv(cfg.z_channels, block_in))
            elif kind == "resnet":
                cout = (block_in if name.startswith("mid")
                        else stage_out[name.rsplit("_block", 1)[0]])
                layers.append(ResnetBlock(block_in, cout, cfg.dropout))
                block_in = cout
            elif kind == "attn":
                layers.append(AttnBlock(block_in))
            elif kind == "up":
                layers.append(Upsample(block_in))
            elif kind == "norm":
                layers.append(GroupNormSwish(block_in))
            elif kind == "skip":
                layers.append(nn.Identity())
            else:
                layers.append(conv(block_in, cfg.out_channels))
        self.model = nn.Sequential(*layers)

    def trunk(self, z: torch.Tensor) -> torch.Tensor:
        """Everything up to ``norm_out`` (and its Identity)."""
        return self.model[:-1](z)

    def final(self, h: torch.Tensor) -> torch.Tensor:
        """``conv_out`` alone."""
        return self.model[-1](h)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model(z)


def _to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


class VQModel(nn.Module):
    """encode -> quant_conv (+SyncBatchNorm) -> codebook ->
    post_quant_conv -> decode."""

    def __init__(self, cfg: VQModelConfig, fp32_params: bool = False):
        super().__init__()
        if cfg.embed_dim != cfg.codebook.codebook_dim:
            raise ValueError("embed_dim must equal codebook.codebook_dim")
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Sequential(conv(cfg.z_channels, cfg.embed_dim, 1),
                                        SyncBatchNorm(cfg.embed_dim))
        self.post_quant_conv = conv(cfg.embed_dim, cfg.z_channels, 1)
        self.quantize = Codebook(cfg.codebook.codebook_size,
                                 cfg.codebook.codebook_dim)
        # convs run in the compute dtype; norms and the codebook stay fp32
        if not fp32_params:
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    m.to(self.dtype)

    @property
    def last_layer(self) -> torch.Tensor:
        """The decoder's ``conv_out`` weight."""
        return self.decoder.model[-1].weight

    def encode_latent(self, x: torch.Tensor,
                      train: bool = False) -> torch.Tensor:
        """NHWC image -> NHWC pre-quantization latent [B, h, w, embed_dim]
        in the compute dtype; ``train``: batch statistics in the BN."""
        h = self.quant_conv[0](self.encoder(_to_nchw(x, self.dtype)))
        return self.quant_conv[1](h, train=train).permute(0, 2, 3, 1)

    def decode_latent(self, z_q: torch.Tensor) -> torch.Tensor:
        """NHWC quantized latent -> NHWC fp32 reconstruction."""
        out = self.decoder(self.post_quant_conv(_to_nchw(z_q, self.dtype)))
        return out.float().permute(0, 2, 3, 1).contiguous()

    def decode_trunk(self, z_q: torch.Tensor) -> torch.Tensor:
        """NHWC quantized latent -> NHWC activations ahead of the final
        conv, in the compute dtype."""
        h = self.decoder.trunk(self.post_quant_conv(_to_nchw(z_q, self.dtype)))
        return h.permute(0, 2, 3, 1)

    def decode_final(self, h: torch.Tensor) -> torch.Tensor:
        """NHWC ``decode_trunk`` output -> NHWC fp32 reconstruction."""
        out = self.decoder.final(_to_nchw(h, self.dtype))
        return out.float().permute(0, 2, 3, 1).contiguous()

    def encode(self, x: torch.Tensor):
        """Eval-mode encode: (z_q, int32 indices [B, h, w])."""
        return quantize_eval(self.encode_latent(x),
                             self.quantize.embedding.weight)

    def encode_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> token indices [B, h, w] (kernel B5 on CUDA)."""
        return self.encode(x)[1]

    def decode_code(self, indices: torch.Tensor) -> torch.Tensor:
        """Token indices [B, h, w] -> NHWC fp32 image."""
        with span("vq_decode"):
            return self.decode_latent(
                lookup(indices, self.quantize.embedding.weight))

    def reconstruct(self, x: torch.Tensor,
                    quantize: bool = True) -> torch.Tensor:
        """Encode -> (optionally quantize) -> decode, eval mode;
        ``quantize=False`` is the train step's pass-through window."""
        z = self.encode_latent(x)
        if quantize:
            z = quantize_eval(z, self.quantize.embedding.weight)[0]
        return self.decode_latent(z)

    def forward(self, x: torch.Tensor):
        """Eval full forward -> (reconstruction, q_loss), q_loss being the
        eval value (1 + beta) * mse of the train-step loss."""
        z = self.encode_latent(x)
        z_q = quantize_eval(z, self.quantize.embedding.weight)[0]
        q_loss = (1.0 + self.cfg.codebook.beta) * (
            z_q.float() - z.float()).square().mean()
        return self.decode_latent(z_q), q_loss
