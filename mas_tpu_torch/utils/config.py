"""Strict, typed configuration schema for the PyTorch port.

Same field names, defaults and validation as ``mas_tpu/utils/config.py``
(``CodebookConfig``, ``VQModelConfig``, ``TransformerConfig``,
``SegLossConfig``, ``VQGANLossConfig``, ``OptimizerConfig``,
``TrainConfig``), so the JAX package's JSON configs
(``configs/sample_256.json``, ``configs/seg_256.json``,
``configs/img_512.json``, ``configs/transformer_512.json``) load
unchanged.  The
port cannot import that module: importing anything under ``mas_tpu`` pulls
in jax (``mas_tpu/__init__.py`` -> ``mas_tpu/eval.py``).

Fields that exist only as TPU/XLA ablations (``decode_ring_tail``,
``decode_length_buckets``, ``decode_q_rows``) raise
``NotImplementedError`` when set away from their default, naming the
ROADMAP item that would port them; they are never silently ignored.
``scan_layers`` is accepted: the port always runs the unrolled layers,
as the JAX sampler does.
Fields read only by the JAX package's dispatch (``attention_impl``,
``decode_attention_impl``) are accepted and have no effect here: the port
picks a hand-written kernel for CUDA tensors and its plain twin for CPU
tensors.  The ``ConfigError``s of ``TransformerConfig`` are the JAX
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


def vq_seg_config(**overrides) -> VQModelConfig:
    """VQ-SEG: 159-channel one-hot seg maps at 256^2 -> 16^2 tokens, K 1024
    (``mas_tpu/utils/config.py::vq_seg_config``)."""
    base = dict(in_channels=159, out_channels=159, resolution=256,
                attn_resolutions=(16,),
                codebook=CodebookConfig(codebook_size=1024))
    base.update(overrides)
    return VQModelConfig(**base)


def vq_img_config(**overrides) -> VQModelConfig:
    """VQ-IMG: RGB at 512^2 -> 32^2 tokens, K 8192
    (``mas_tpu/utils/config.py::vq_img_config``)."""
    base = dict(in_channels=3, out_channels=3, resolution=512,
                attn_resolutions=(32,),
                codebook=CodebookConfig(codebook_size=8192, init_steps=3000,
                                        reservoir_size=12500))
    base.update(overrides)
    return VQModelConfig(**base)


REMAT_POLICIES = ("mlp", "nothing", "dots")


@dataclass(frozen=True)
class TransformerConfig(_Base):
    """MakeAScene AR transformer; sequence = [text | seg | image]."""

    num_layers: int = 24
    hidden_dim: int = 1024
    num_attn_heads: int = 16
    # grouped-query attention: heads of k and v (0: num_attn_heads); query
    # head h reads kv head h // (num_attn_heads / num_kv_heads).  A model
    # is trained and served with the same count
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
    # ruDALL-E's relaxed attention (reference checkpoints): scores over
    # sigma^2 = var(k), v over its detached max, the context and MLP
    # rescaled by detached maxima; needs a float ("compute") cache
    rudalle_relax: bool = False
    # divide the inputs of ln_in, the first sandwich LN and ln_out by
    # their detached per-position max
    cogview_layernorm_prescale: bool = False
    compute_dtype: str = "float32"
    # fold ln_in / ln_out into the qkv / mlp.lin1 products (same
    # parameters): LN(x) W = r (x (gamma W)) - r mu colsum + beta W
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
    # the lane int8/int4 cache's per-position scales: fp32, or bf16 (the
    # values are quantized against the rounded bf16 scale)
    kv_scale_dtype: str = "float32"
    decode_length_buckets: int = 1
    decode_q_rows: int = 1
    layernorm_impl: str = "jnp"
    # the JAX package trains such a model as one scanned, stacked layer
    # (an XLA compile-time lever); its checkpoint tree is stacked.  The
    # port always runs the unrolled layers and loads that tree unstacked
    # (``utils/weights.py::transformer_from_flax``)
    scan_layers: bool = False

    def __post_init__(self):
        # the JAX package's checks, in its order and with its messages
        # (``mas_tpu/utils/config.py::TransformerConfig.__post_init__``), so
        # a config one package refuses the other refuses too; the TPU
        # ablations it accepts are refused after them
        if self.layernorm_impl not in ("jnp", "pallas"):
            raise ConfigError(
                f"layernorm_impl must be jnp/pallas, got "
                f"{self.layernorm_impl!r}")
        if self.hidden_dim % self.num_attn_heads:
            raise ConfigError("hidden_dim must divide num_attn_heads")
        if self.num_kv_heads:
            if (self.num_kv_heads < 1
                    or self.num_attn_heads % self.num_kv_heads):
                raise ConfigError(
                    f"num_kv_heads ({self.num_kv_heads}) must be a positive "
                    f"divisor of num_attn_heads ({self.num_attn_heads})")
            if self.num_kv_heads < self.num_attn_heads:
                if self.rudalle_relax:
                    raise ConfigError(
                        "grouped-query attention is not defined for the "
                        "rudalle_relax checkpoint-compat variant")
                if self.decode_ring_tail:
                    raise ConfigError(
                        "grouped-query attention supports only the default "
                        "decode path; disable decode_ring_tail")
                if self.kv_cache_layout == "packed":
                    raise ConfigError(
                        "grouped-query attention supports "
                        "kv_cache_layout 'lane' or 'lane_aliased' (the "
                        "packed write kernel assumes full-head caches)")
                if self.decode_attention_impl in ("pallas",
                                                  "pallas_interpret"):
                    raise ConfigError(
                        "grouped-query attention decodes via the jnp read "
                        "path only (the Pallas decode kernels assume "
                        "full-head q); drop the explicit "
                        "decode_attention_impl")
        if self.text_vocab_size < self.text_length:
            raise ConfigError("text_vocab_size must be >= text_length "
                              "(pad-remap needs text_length trailing slots)")
        if self.rudalle_relax and not self.cogview_pb_relax:
            raise ConfigError(
                "rudalle_relax is a refinement of the PB-relax branch "
                "(reference transformer.py:47-55); enable cogview_pb_relax")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ConfigError(
                f"compute_dtype must be float32/bfloat16, got "
                f"{self.compute_dtype!r}")
        if self.kv_cache_dtype not in ("compute", "int8", "int4"):
            raise ConfigError(
                f"kv_cache_dtype must be compute/int8/int4, got "
                f"{self.kv_cache_dtype!r}")
        if self.rudalle_relax and self.kv_cache_dtype != "compute":
            raise ConfigError(
                "rudalle_relax requires a floating-point KV cache (its "
                "masked sigma/max statistics are not defined over the "
                "quantized cache)")
        if self.decode_length_buckets < 1:
            raise ConfigError("decode_length_buckets must be >= 1")
        if self.decode_q_rows < 1:
            raise ConfigError("decode_q_rows must be >= 1")
        if self.decode_q_rows > 1:
            if self.rudalle_relax or self.decode_ring_tail:
                raise ConfigError(
                    "decode_q_rows > 1 supports only the default decode "
                    "path (no rudalle_relax, no decode_ring_tail)")
            if self.kv_cache_layout != "lane":
                raise ConfigError(
                    "decode_q_rows > 1 requires kv_cache_layout='lane'")
            if self.decode_attention_impl in ("pallas", "pallas_interpret"):
                raise ConfigError(
                    "decode_q_rows > 1 uses the jnp read path only (the "
                    "Pallas decode kernels assume a single query row)")
        if self.kv_scale_dtype not in ("float32", "bfloat16"):
            raise ConfigError(
                f"kv_scale_dtype must be float32/bfloat16, got "
                f"{self.kv_scale_dtype!r}")
        if self.kv_scale_dtype == "bfloat16" and (
                self.kv_cache_layout != "lane" or self.decode_ring_tail
                or self.kv_cache_dtype not in ("int8", "int4")):
            raise ConfigError(
                "kv_scale_dtype='bfloat16' is only supported on the "
                "default quantized decode path (kv_cache_dtype int8/int4, "
                "kv_cache_layout='lane', no ring tail)")
        if self.decode_length_buckets > 1 and self.decode_ring_tail:
            raise ConfigError(
                "decode_length_buckets and decode_ring_tail restructure "
                "the same cache read; pick one")
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
            if self.decode_ring_tail:
                raise ConfigError(
                    f"decode_ring_tail and kv_cache_layout="
                    f"{self.kv_cache_layout!r} are alternative decode "
                    "write-path strategies; pick one")
            if self.total_length % 128:
                raise ConfigError(
                    f"kv_cache_layout={self.kv_cache_layout!r} needs "
                    "total_length % 128 == 0 (the RMW block is one "
                    "128-lane tile)")
        if self.remat_policy not in REMAT_POLICIES:
            raise ConfigError(
                f"remat_policy must be one of {REMAT_POLICIES}, got "
                f"{self.remat_policy!r}")
        checks = (
            (self.decode_ring_tail, "decode_ring_tail"),
            (self.decode_length_buckets > 1, "decode_length_buckets > 1"),
            (self.decode_q_rows > 1, "decode_q_rows > 1"),
        )
        for bad, what in checks:
            if bad:
                raise _not_ported(what, "A5")

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_attn_heads

    @property
    def kv_heads(self) -> int:
        """Heads of k and v: ``num_kv_heads``, or ``num_attn_heads`` when
        it is 0 (multi-head attention)."""
        return self.num_kv_heads or self.num_attn_heads

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
class VQGANLossConfig(_Base):
    """VQ-IMG composite loss (``losses/vqgan.py``)."""

    disc_start: int = 250_001
    codebook_weight: float = 1.0
    pixelloss_weight: float = 1.0
    disc_factor: float = 1.0
    disc_weight: float = 0.8
    perceptual_weight: float = 1.0
    face_loss: bool = True
    object_weight: float = 2.0   # gradient weight inside object boxes
    max_faces: int = 6


@dataclass(frozen=True)
class OptimizerConfig(_Base):
    lr: float = 4.5e-6
    beta1: float = 0.5
    beta2: float = 0.9
    eps: float = 1e-8
    accumulate_grad: int = 1


@dataclass(frozen=True)
class MeshConfig(_Base):
    """Device mesh, one rank a device: ``data`` ranks of data parallelism
    (-1: every rank the model axis leaves) by ``model`` ranks of tensor
    parallelism (``parallel/``; the transformer's heads, MLP columns and
    vocabulary split over them, which ``parallel/sharding.py::
    check_shardable`` holds)."""

    data: int = -1
    model: int = 1

    def shape(self, n_devices: int) -> Tuple[int, int]:
        """(data, model) over ``n_devices``, as the JAX ``MeshConfig``."""
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ConfigError(
                f"mesh {data}x{model} does not cover {n_devices} devices")
        return data, model


@dataclass(frozen=True)
class TrainConfig(_Base):
    """Training run settings.  The port trains VQ-SEG, VQ-IMG (generator
    ``optimizer`` and discriminator ``disc_optimizer``) and the transformer
    (with CFG text dropout: ``uncond_p``, from step ``start_uncond``) on
    one process or a (data, model) grid of ranks (``mesh``;
    ``batch_size`` is per data index)."""

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
