"""The transformer's tensor-parallel layout, as
``mas_tpu/parallel/sharding.py`` (Megatron's pattern over the mesh's
``model`` axis), on the port's ``state_dict`` keys (torch layout: a
linear weight is [out, in]):

  * column-parallel — the ``qkv``, ``mlp.lin1`` and ``to_logits.1`` (JAX's
    ``logits_dense``) weights and biases: split on dim 0;
  * row-parallel — the ``out_proj`` and ``mlp.lin2`` weights: split on
    dim 1; their biases stay whole and are added after the sum over the
    model group;
  * everything else (LayerNorms, embeddings) is replicated.

JAX splits qkv's [q | k | v] columns contiguously and reshards in global
view.  One process a rank has no global view, so the port splits qkv by
heads: model rank m holds the q rows of heads m H/M .. (m + 1) H/M - 1
and the k and v rows of its kv heads.  When the kv heads do not split
over the ranks (grouped-query or multi-query attention with kv_heads % M
!= 0), every rank holds all k and v rows and the model sums their
gradients over the model group (``kv_heads_of`` says which kv heads a
rank attends with).  ``gather_state`` undoes the permutation, so
checkpoints and exports hold the full tree in JAX's layout.  A
``scan_layers`` tree is unstacked first (``utils/weights.py::
transformer_from_flax``); the stack axis is never split.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..utils.config import ConfigError, TransformerConfig

COLUMN_PARALLEL = ("attn.qkv", "mlp.lin1", "to_logits.1")
ROW_PARALLEL = ("attn.out_proj", "mlp.lin2")

State = Dict[str, torch.Tensor]


def split_dim(key: str) -> Optional[int]:
    """The dim of the ``state_dict`` entry ``key`` that the model axis
    splits, None for a replicated one (JAX's ``_spec_for_path``)."""
    module, leaf = key.rsplit(".", 1)
    if module.endswith(COLUMN_PARALLEL) and leaf in ("weight", "bias"):
        return 0
    if module.endswith(ROW_PARALLEL) and leaf == "weight":
        return 1
    return None


def check_shardable(cfg: TransformerConfig, size: int) -> None:
    """Raise ``ConfigError`` unless ``size`` model ranks can split ``cfg``:
    the attention splits by heads, the MLP by its 4 x hidden columns, the
    logits by the image vocabulary."""
    for name, n in (("num_attn_heads", cfg.num_attn_heads),
                    ("4 x hidden_dim", 4 * cfg.hidden_dim),
                    ("image_vocab_size", cfg.image_vocab_size)):
        if n % size:
            raise ConfigError(
                f"mesh.model {size} does not divide {name} {n}: tensor "
                f"parallelism splits the attention by heads, the MLP by "
                f"its columns and the logits by the vocabulary")


def kv_heads_of(cfg: TransformerConfig, index: int, size: int) -> List[int]:
    """The kv heads model rank ``index`` of ``size`` attends with, in the
    order its query heads read them.  Its query heads are index H/M ..
    (index + 1) H/M - 1 and query head h reads kv head h // (H /
    kv_heads): with kv_heads % M == 0 a contiguous share of them; with M %
    kv_heads == 0 the one kv head of its query heads; otherwise one kv
    head a query head."""
    h, kv = cfg.num_attn_heads, cfg.kv_heads
    local, group = h // size, h // kv
    if kv % size == 0:
        n = kv // size
        return list(range(index * n, (index + 1) * n))
    if size % kv == 0:
        return [index * local // group]
    return [q // group for q in range(index * local, (index + 1) * local)]


def _qkv_rows(cfg: TransformerConfig, index: int, size: int
              ) -> List[Tuple[int, int]]:
    """Rank ``index``'s row ranges of the full qkv weight: its q heads,
    then its k and v heads (all of k and v when they do not split)."""
    hd, h, kv = cfg.head_dim, cfg.num_attn_heads, cfg.kv_heads
    q = h // size * hd
    if kv % size == 0:
        n = kv // size * hd
        k0, v0 = h * hd + index * n, (h + kv) * hd + index * n
        kv_rows = [(k0, k0 + n), (v0, v0 + n)]
    else:
        kv_rows = [(h * hd, (h + 2 * kv) * hd)]
    return [(index * q, (index + 1) * q)] + kv_rows


def _is_qkv(key: str) -> bool:
    return key.rsplit(".", 1)[0].endswith("attn.qkv")


def shard_state(full: Mapping[str, torch.Tensor], cfg: TransformerConfig,
                index: int, size: int) -> State:
    """Model rank ``index`` of ``size``'s part of a full ``state_dict`` (or
    of Adam's per-parameter moments, keyed alike); replicated entries as
    they are."""
    if size == 1:
        return dict(full)
    check_shardable(cfg, size)
    out: State = {}
    for key, t in full.items():
        dim = split_dim(key)
        if dim is None:
            out[key] = t
        elif _is_qkv(key):
            out[key] = torch.cat([t[a:b] for a, b in
                                  _qkv_rows(cfg, index, size)])
        else:
            out[key] = t.chunk(size, dim)[index]
    return out


def gather_state(parts: Sequence[Mapping[str, torch.Tensor]],
                 cfg: TransformerConfig) -> State:
    """The full ``state_dict`` (JAX's qkv layout) from every model rank's
    part, in model-rank order: the inverse of ``shard_state``."""
    size = len(parts)
    if size == 1:
        return dict(parts[0])
    out: State = {}
    for key, t in parts[0].items():
        dim = split_dim(key)
        if dim is None:
            out[key] = t
        elif _is_qkv(key):
            hd, h, kv = cfg.head_dim, cfg.num_attn_heads, cfg.kv_heads
            q = h // size * hd
            pieces = [p[key] for p in parts]
            qs = [p[:q] for p in pieces]
            if kv % size == 0:
                n = kv // size * hd
                ks = [p[q:q + n] for p in pieces]
                vs = [p[q + n:] for p in pieces]
            else:
                ks, vs = [pieces[0][q:q + kv * hd]], [pieces[0][q + kv * hd:]]
            out[key] = torch.cat(qs + ks + vs)
        else:
            out[key] = torch.cat([p[key] for p in parts], dim)
    return out
