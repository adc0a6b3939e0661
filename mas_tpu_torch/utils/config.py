"""Strict, typed configuration schema for the PyTorch port.

Same field names, defaults and validation as ``mas_tpu/utils/config.py``
(``CodebookConfig``, ``VQModelConfig``, ``TransformerConfig``,
``SegLossConfig``, ``OptimizerConfig``, ``TrainConfig``), so the JAX
package's JSON configs (``configs/sample_256.json``, ``configs/seg_256.json``)
load unchanged.  The
port cannot import that module: importing anything under ``mas_tpu`` pulls
in jax (``mas_tpu/__init__.py`` -> ``mas_tpu/eval.py``).

Fields that exist only as TPU/XLA ablations or workarounds raise
``NotImplementedError`` when set away from their default, naming the
ROADMAP item that would port them; they are never silently ignored.
Fields read only by the JAX package's dispatch (``attention_impl``,
``decode_attention_impl``) are accepted and have no effect here: the port
picks a hand-written kernel for CUDA tensors and its plain twin for CPU
tensors.  The ``ConfigError``s of ``kv_cache_layout`` are the JAX
package's, so a config that one package refuses the other refuses too.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple, Type, TypeVar

T = TypeVar("T")


class ConfigError(ValueError):
    """Raised on unknown keys or invalid field values."""


def _from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Build a dataclass from a dict, rejecting unknown keys recursively."""
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(names)
    if unknown:
        raise ConfigError(
            f"unknown config keys for {cls.__name__}: {sorted(unknown)}; "
            f"valid keys: {sorted(names)}")
    kwargs: Dict[str, Any] = {}
    for key, value in data.items():
        sub = names[key].type if isinstance(names[key].type, type) else None
        if (sub is not None and dataclasses.is_dataclass(sub)
                and isinstance(value, dict)):
            kwargs[key] = _from_dict(sub, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


class _Base:
    @classmethod
    def from_dict(cls, data: Dict[str, Any]):
        return _from_dict(cls, data)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mas_tpu_torch (ROADMAP {item})")


@dataclass(frozen=True)
class CodebookConfig(_Base):
    """Vector-quantizer codebook with the staged k-means bootstrap
    (``mas_tpu/utils/config.py``): collect latents into the reservoir after
    ``q_start_collect`` micro-steps, pass latents through unquantized until
    ``q_init``, then re-initialize the codebook by k-means every
    ``q_re_step`` micro-steps until ``q_re_end``."""

    codebook_size: int = 1024
    codebook_dim: int = 256
    beta: float = 0.25
    init_steps: int = 2000
    reservoir_size: int = 200_000
    samples_per_image: int = 10
    kmeans_iters: int = 10

    def __post_init__(self):
        if self.codebook_size <= 0 or self.codebook_dim <= 0:
            raise ConfigError("codebook_size and codebook_dim must be positive")
        if self.reservoir_size <= 0:
            raise ConfigError("reservoir_size must be positive")
        if self.reservoir_size < self.codebook_size:
            raise ConfigError(
                f"reservoir_size ({self.reservoir_size}) must be >= "
                f"codebook_size ({self.codebook_size})")

    @property
    def q_start_collect(self) -> int:
        return self.init_steps

    @property
    def q_init(self) -> int:
        return self.init_steps * 3

    @property
    def q_re_end(self) -> int:
        return self.init_steps * 30

    @property
    def q_re_step(self) -> int:
        return self.init_steps // 2


@dataclass(frozen=True)
class VQModelConfig(_Base):
    """VQ-VAE / VQGAN autoencoder; len(channels)-2 up/down stages."""

    in_channels: int = 3
    out_channels: int = 3
    channels: Tuple[int, ...] = (128, 128, 128, 256, 512, 512)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (32,)
    resolution: int = 512
    z_channels: int = 256
    embed_dim: int = 256
    dropout: float = 0.0
    codebook: CodebookConfig = field(default_factory=CodebookConfig)
    compute_dtype: str = "float32"

    def __post_init__(self):
        if isinstance(self.channels, list):
            object.__setattr__(self, "channels", tuple(self.channels))
        if isinstance(self.attn_resolutions, list):
            object.__setattr__(self, "attn_resolutions",
                               tuple(self.attn_resolutions))
        if isinstance(self.codebook, dict):
            object.__setattr__(self, "codebook",
                               CodebookConfig.from_dict(self.codebook))
        if len(self.channels) < 2:
            raise ConfigError("channels needs at least 2 entries")
        if self.resolution % self.spatial_reduction != 0:
            raise ConfigError(
                f"resolution {self.resolution} not divisible by reduction "
                f"{self.spatial_reduction}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ConfigError(
                f"compute_dtype must be float32/bfloat16, got "
                f"{self.compute_dtype!r}")

    @property
    def num_down(self) -> int:
        return len(self.channels) - 2

    @property
    def spatial_reduction(self) -> int:
        return 2 ** self.num_down

    @property
    def latent_resolution(self) -> int:
        return self.resolution // self.spatial_reduction


REMAT_POLICIES = ("mlp", "nothing", "dots")


@dataclass(frozen=True)
class TransformerConfig(_Base):
    """MakeAScene AR transformer; sequence = [text | seg | image]."""

    num_layers: int = 24
    hidden_dim: int = 1024
    num_attn_heads: int = 16
    num_kv_heads: int = 0
    image_vocab_size: int = 8192
    seg_vocab_size: int = 1024
    text_vocab_size: int = 16512
    image_tokens_per_dim: int = 32
    seg_tokens_per_dim: int = 16
    text_length: int = 128
    attn_dropout: float = 0.0
    out_dropout: float = 0.0
    # PB-relax subtracts a per-row constant that softmax cancels; the port
    # computes the plain masked softmax with fp32 statistics either way
    cogview_pb_relax: bool = True
    cogview_sandwich_layernorm: bool = True
    pb_relax_alpha: float = 32.0
    # True: bidirectional over the text+seg prefix (paper); False: pure
    # causal, faithful to the reference's effective mask
    prefix_bidirectional: bool = True
    rudalle_relax: bool = False
    cogview_layernorm_prescale: bool = False
    compute_dtype: str = "float32"
    ln_matmul_fold: bool = False
    attention_impl: str = "auto"
    decode_attention_impl: str = "auto"
    # recompute in the backward pass (``torch.utils.checkpoint``): 'mlp'
    # the MLP only, 'nothing' the whole layer, 'dots' the whole layer with
    # the matmul outputs saved
    remat: bool = False
    remat_policy: str = "nothing"
    # decode cache: 'compute' is a float cache in the compute dtype; on the
    # card the port reads every float cache through kernel B9, whatever
    # decode_attention_impl says, as it reads every int8/int4 cache through
    # kernel B2
    kv_cache_dtype: str = "compute"
    decode_ring_tail: bool = False
    # 'lane' and 'lane_aliased' both mean separate k and v caches written
    # in place by kernel B3; 'packed' keeps one layer's k and v in one
    # [B, H, T, 2d] buffer (int4: [B, H, T, d] bytes), written by kernel
    # B10 and read by B2 through strided views.  Caches are preallocated
    # at full length and written in place.
    kv_cache_layout: str = "lane"
    kv_scale_dtype: str = "float32"
    decode_length_buckets: int = 1
    decode_q_rows: int = 1
    layernorm_impl: str = "jnp"
    scan_layers: bool = False

    def __post_init__(self):
        if self.hidden_dim % self.num_attn_heads:
            raise ConfigError("hidden_dim must divide num_attn_heads")
        if self.text_vocab_size < self.text_length:
            raise ConfigError("text_vocab_size must be >= text_length "
                              "(pad-remap needs text_length trailing slots)")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ConfigError(
                f"compute_dtype must be float32/bfloat16, got "
                f"{self.compute_dtype!r}")
        if self.kv_cache_dtype not in ("compute", "int8", "int4"):
            raise ConfigError(
                f"kv_cache_dtype must be compute/int8/int4, got "
                f"{self.kv_cache_dtype!r}")
        if self.kv_cache_layout not in ("lane", "lane_aliased", "packed"):
            raise ConfigError(
                f"kv_cache_layout must be lane/lane_aliased/packed, got "
                f"{self.kv_cache_layout!r}")
        if self.kv_cache_layout in ("lane_aliased", "packed"):
            if self.kv_cache_dtype not in ("int8", "int4"):
                raise ConfigError(
                    f"kv_cache_layout={self.kv_cache_layout!r} is a "
                    "quantized-cache layout; set kv_cache_dtype to int8 "
                    "or int4")
            if self.total_length % 128:
                raise ConfigError(
                    f"kv_cache_layout={self.kv_cache_layout!r} needs "
                    "total_length % 128 == 0, as the JAX package's "
                    "in-place write kernels do")
        if self.decode_length_buckets < 1 or self.decode_q_rows < 1:
            raise ConfigError(
                "decode_length_buckets and decode_q_rows must be >= 1")
        if self.kv_scale_dtype not in ("float32", "bfloat16"):
            raise ConfigError(
                f"kv_scale_dtype must be float32/bfloat16, got "
                f"{self.kv_scale_dtype!r}")
        if self.layernorm_impl not in ("jnp", "pallas"):
            raise ConfigError(
                f"layernorm_impl must be jnp/pallas, got "
                f"{self.layernorm_impl!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ConfigError(
                f"remat_policy must be one of {REMAT_POLICIES}, got "
                f"{self.remat_policy!r}")
        self._reject_tpu_ablations()

    def _reject_tpu_ablations(self):
        checks = (
            (self.decode_ring_tail, "decode_ring_tail", "A5"),
            (self.decode_length_buckets > 1, "decode_length_buckets > 1",
             "A5"),
            (self.decode_q_rows > 1, "decode_q_rows > 1", "A5"),
            (self.num_kv_heads not in (0, self.num_attn_heads),
             "num_kv_heads (grouped-query attention)", "A9b"),
            (self.rudalle_relax, "rudalle_relax", "A9b"),
            (self.cogview_layernorm_prescale, "cogview_layernorm_prescale",
             "A9b"),
            (self.ln_matmul_fold, "ln_matmul_fold", "A9b"),
            (self.scan_layers, "scan_layers (load stacked trees unstacked)",
             "A9b"),
            (self.kv_scale_dtype == "bfloat16", "kv_scale_dtype='bfloat16'",
             "B2/B3"),
        )
        for bad, what, item in checks:
            if bad:
                raise _not_ported(what, item)

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_attn_heads

    @property
    def image_length(self) -> int:
        return self.image_tokens_per_dim ** 2

    @property
    def seg_length(self) -> int:
        return self.seg_tokens_per_dim ** 2

    @property
    def total_length(self) -> int:
        return self.text_length + self.seg_length + self.image_length

    @property
    def prefix_length(self) -> int:
        return self.text_length + self.seg_length

    @property
    def effective_prefix(self) -> int:
        """Bidirectional-prefix extent applied to masks (0 = pure causal)."""
        return self.prefix_length if self.prefix_bidirectional else 0


@dataclass(frozen=True)
class SegLossConfig(_Base):
    """Weighted-BCE seg loss (``losses/seg.py``)."""

    image_channels: int = 159
    codebook_weight: float = 1.0
    face_weight: float = 20.0
    face_channel_start: int = 153
    face_channel_end: int = 158


@dataclass(frozen=True)
class OptimizerConfig(_Base):
    lr: float = 4.5e-6
    beta1: float = 0.5
    beta2: float = 0.9
    eps: float = 1e-8
    accumulate_grad: int = 1


@dataclass(frozen=True)
class MeshConfig(_Base):
    """Device mesh of the JAX package; the port runs on one device until
    ``torch.distributed`` is wired in (ROADMAP A12)."""

    data: int = -1
    model: int = 1


@dataclass(frozen=True)
class TrainConfig(_Base):
    """Training run settings.  The port trains VQ-SEG and the transformer
    (with CFG text dropout: ``uncond_p``, from step ``start_uncond``); the
    VQ-IMG mode, and the fields only it or a device mesh reads, raise
    ``NotImplementedError`` naming the ROADMAP item that ports them."""

    mode: str = "pretrain_segmentation"
    total_steps: int = 100
    batch_size: int = 2
    log_period: int = 50
    save_period: int = 50_000
    checkpoint_dir: str = "checkpoints"
    resume: bool = False
    seed: int = 0
    start_uncond: int = 0
    uncond_p: float = 0.1
    mesh: MeshConfig = field(default_factory=MeshConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    disc_optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    allow_replicated_batch: bool = False

    def __post_init__(self):
        valid = {"pretrain_segmentation", "pretrain_image", "train_transformer"}
        if self.mode not in valid:
            raise ConfigError(f"mode must be one of {sorted(valid)}")
        for name in ("mesh", "optimizer", "disc_optimizer"):
            v = getattr(self, name)
            if isinstance(v, dict):
                cls = MeshConfig if name == "mesh" else OptimizerConfig
                object.__setattr__(self, name, cls.from_dict(v))
        checks = (
            (self.mode == "pretrain_image", "mode 'pretrain_image'", "A10"),
            (self.disc_optimizer != OptimizerConfig(),
             "disc_optimizer (VQ-IMG discriminator)", "A10"),
            (self.mesh != MeshConfig(), "mesh (multi-device training)",
             "A12"),
            (self.allow_replicated_batch, "allow_replicated_batch", "A12"),
        )
        for bad, what, item in checks:
            if bad:
                raise _not_ported(what, item)
