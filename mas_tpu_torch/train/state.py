"""Train states of the VQ stage and of the transformer, and their
optimizer, as ``mas_tpu/train/state.py``.

``Adam`` is optax's ``adam`` (update m^ / (sqrt(v^) + eps), bias-corrected
moments) behind ``optax.MultiSteps``: with ``accumulate_grad`` k > 1 each
micro-step folds its gradient into a running mean, and every k-th
micro-step applies one Adam update with that mean; the parameters do not
change in between.  Updates are in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from ..losses.discriminator import PatchDiscriminator
from ..models.codebook import CodebookState, codebook_init_state
from ..models.transformer import MakeAScene
from ..models.vqvae import VQModel
from ..utils.config import OptimizerConfig, TransformerConfig, VQModelConfig
from ..utils.weights import init_random_


class Adam:
    """Adam with gradient accumulation over named parameters; state in
    ``state_dict`` / ``load_state_dict`` form for checkpoints."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 lr: float, b1: float, b2: float, eps: float,
                 every_k: int = 1):
        self.params: Dict[str, torch.Tensor] = dict(named_params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.every_k = max(every_k, 1)
        zeros = lambda: {k: torch.zeros_like(p) for k, p in
                         self.params.items()}
        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if self.every_k > 1 else {}
        self.count = 0        # Adam updates applied
        self.mini_step = 0    # micro-steps folded into ``acc``

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one micro-step with ``grads`` (in ``params`` order);
        returns True when the parameters were updated."""
        grads = dict(zip(self.params, grads))
        if self.every_k > 1:
            n = self.mini_step
            for k, g in grads.items():
                acc = self.acc[k]
                acc.add_((g - acc) / (n + 1))
            if n + 1 < self.every_k:
                self.mini_step += 1
                return False
            grads = self.acc
        self.count += 1
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        for k, p in self.params.items():
            g, mu, nu = grads[k], self.mu[k], self.nu[k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g.square() + self.b2 * nu)
            p.add_((mu / bc1) / ((nu / bc2).sqrt() + self.eps),
                   alpha=-self.lr)
        if self.every_k > 1:
            for acc in self.acc.values():
                acc.zero_()
            self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count, self.mini_step = state["count"], state["mini_step"]
        for name in ("mu", "nu", "acc"):
            mine = getattr(self, name)
            if set(state[name]) != set(mine):
                raise ValueError(f"optimizer state {name!r} holds other "
                                 "parameters than the model")
            for k, t in mine.items():
                t.copy_(state[name][k])


def make_adam(cfg: OptimizerConfig,
              named_params: Iterable[Tuple[str, torch.Tensor]],
              rescale_lr: bool = True) -> Adam:
    """Adam with ``accumulate_grad``-step accumulation.  ``rescale_lr``
    divides the lr by the accumulation factor; the seg stage passes False,
    as the JAX package does for it."""
    lr = cfg.lr / max(cfg.accumulate_grad, 1) if rescale_lr else cfg.lr
    return Adam(named_params, lr, cfg.beta1, cfg.beta2, cfg.eps,
                cfg.accumulate_grad)


@dataclass
class VQTrainState:
    step: int                  # micro-steps taken
    model: VQModel             # fp32 parameters and BN running statistics
    vq_state: CodebookState
    opt: Adam
    # VQ-IMG only: the discriminator (parameters and BN statistics) and
    # its optimizer
    disc: Optional[PatchDiscriminator] = None
    disc_opt: Optional[Adam] = None


def create_vq_train_state(cfg: VQModelConfig, opt_cfg: OptimizerConfig,
                          generator: torch.Generator, device,
                          rescale_lr: bool = True,
                          disc_opt_cfg: Optional[OptimizerConfig] = None
                          ) -> VQTrainState:
    """A VQModel on ``device`` with fp32 parameters (cast to the compute
    dtype at use), seeded random weights, a fresh codebook state and Adam;
    with ``disc_opt_cfg`` (VQ-IMG) also a ``PatchDiscriminator`` over the
    model's output channels with its Adam, at the same ``rescale_lr``."""
    with torch.device(device):
        model = VQModel(cfg, fp32_params=True)
    init_random_(model, generator)
    opt = make_adam(opt_cfg, model.named_parameters(), rescale_lr)
    state = VQTrainState(0, model, codebook_init_state(cfg.codebook, device),
                         opt)
    if disc_opt_cfg is not None:
        with torch.device(device):
            state.disc = PatchDiscriminator(cfg.out_channels)
        state.disc.init_weights_(generator)
        state.disc_opt = make_adam(disc_opt_cfg,
                                   state.disc.named_parameters(), rescale_lr)
    return state


@dataclass
class TransformerTrainState:
    step: int                  # micro-steps taken
    model: MakeAScene          # fp32 parameters
    opt: Adam


def create_transformer_train_state(cfg: TransformerConfig,
                                   opt_cfg: OptimizerConfig,
                                   generator: torch.Generator,
                                   device) -> TransformerTrainState:
    """A MakeAScene on ``device`` with fp32 parameters (cast to the compute
    dtype at use), seeded random weights and Adam at the undivided lr, as
    the JAX package's ``run_train_transformer`` builds it."""
    with torch.device(device):
        model = MakeAScene(cfg, fp32_params=True)
    init_random_(model, generator)
    opt = make_adam(opt_cfg, model.named_parameters(), rescale_lr=False)
    return TransformerTrainState(0, model, opt)
