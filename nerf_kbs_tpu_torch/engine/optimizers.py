"""Per-group optimizers over the parameter tree.

One optimizer and schedule per top-level parameter group ('fields',
'proposal_networks'), with optax's semantics, which the JAX package trains
with:
- the global-norm clip is per group and comes before the moments:
  g * max_norm / max(norm, max_norm);
- Adam / RAdam / AdamW add eps outside the root: m_hat / (sqrt(v_hat) +
  eps); AdamW adds ``weight_decay`` times the parameter to that update
  before the learning rate scales it (decoupled decay, also on a parameter
  without a gradient); SGD steps by -lr * g, without momentum;
- the learning rate is read at the 0-based count: exponential decay
  lr * (lr_final / lr) ** (count / max_steps) held at lr_final, after an
  optional linear warm-up;
- a parameter without a gradient (the frozen ``fourier_B``) counts as a zero
  gradient: it does not move and its moments stay zero.
Updates are in place, under ``torch.no_grad``, with ``torch._foreach``
operations over a group's leaves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from nerf_kbs_tpu_torch.device import resolve_device

_B1, _B2 = 0.9, 0.999


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """One group's optimizer and schedule."""

    optimizer: str = "adam"  # adam | radam | adamw | sgd
    lr: float = 1e-3
    eps: float = 1e-15
    weight_decay: float = 0.0  # adamw only
    max_norm: float | None = None
    # exponential decay to lr_final over max_steps (None: constant)
    lr_final: float | None = None
    max_steps: int = 1_000_000
    warmup_steps: int = 0

    def schedule(self):
        """count (0-based) -> learning rate."""

        def base(count: int) -> float:
            if self.lr_final is None:
                return self.lr
            rate = self.lr_final / self.lr
            lr = self.lr * rate ** (count / self.max_steps)
            return max(lr, self.lr_final) if rate < 1.0 else min(lr, self.lr_final)

        def sched(count: int) -> float:
            if self.warmup_steps > 0:
                if count < self.warmup_steps:
                    return self.lr * count / self.warmup_steps
                return base(count - self.warmup_steps)
            return base(count)

        return sched


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


@torch.no_grad()
def tree_copy_(dst, src) -> None:
    """Copy the leaves of ``src`` into the same-shaped tree ``dst`` in place,
    matching dict entries by key (the two may order their keys differently)."""
    if isinstance(dst, dict):
        for k in dst:
            tree_copy_(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            tree_copy_(d, s)
    else:
        dst.copy_(src if isinstance(src, torch.Tensor) else torch.tensor(np.array(src)))


class GroupOptimizer:
    """Holds, per group, the moments ``mu`` / ``nu`` (trees shaped like the
    group's parameters) and the update ``count``. ``step`` reads each leaf's
    ``.grad`` and updates the leaf in place."""

    def __init__(self, group_configs: Mapping[str, OptimizerConfig], params: dict):
        missing = set(params) - set(group_configs)
        if missing:
            raise ValueError(f"no optimizer configured for param groups {sorted(missing)}")
        self.configs = {g: group_configs[g] for g in params}
        for g, c in self.configs.items():
            if c.optimizer not in ("adam", "radam", "adamw", "sgd"):
                raise ValueError(f"unknown optimizer {c.optimizer!r} for group {g!r}")
        self.params = params
        self._schedules = {g: c.schedule() for g, c in self.configs.items()}
        self.state = {
            g: {"mu": tree_map(torch.zeros_like, params[g]),
                "nu": tree_map(torch.zeros_like, params[g]), "count": 0}
            for g in params
        }

    def learning_rate(self, group: str) -> float:
        return self._schedules[group](self.state[group]["count"])

    def zero_grad(self) -> None:
        for p in tree_leaves(self.params):
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for g, cfg in self.configs.items():
            st = self.state[g]
            leaves = tree_leaves(self.params[g])
            have = [i for i, p in enumerate(leaves) if p.grad is not None]
            if cfg.optimizer == "adamw" and cfg.weight_decay:
                # a zero gradient leaves the moments at zero; the decay still applies
                lr = self._schedules[g](st["count"])
                torch._foreach_mul_([p for p in leaves if p.grad is None],
                                    1.0 - lr * cfg.weight_decay)
            if have:
                ps = [leaves[i] for i in have]
                grads = [leaves[i].grad for i in have]
                mus = [tree_leaves(st["mu"])[i] for i in have]
                nus = [tree_leaves(st["nu"])[i] for i in have]
                self._update(cfg, self._schedules[g](st["count"]), st["count"] + 1, ps, grads,
                             mus, nus)
            st["count"] += 1

    @staticmethod
    def _update(cfg, lr, count, ps, grads, mus, nus) -> None:
        if cfg.max_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = cfg.max_norm / torch.clamp_min(norm, cfg.max_norm)
            grads = [g * scale for g in grads]
        if cfg.optimizer == "sgd":
            torch._foreach_add_(ps, grads, alpha=-lr)
            return
        torch._foreach_mul_(mus, _B1)
        torch._foreach_add_(mus, grads, alpha=1.0 - _B1)
        torch._foreach_mul_(nus, _B2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - _B2)
        c1, c2 = 1.0 - _B1**count, 1.0 - _B2**count
        denom = torch._foreach_div(nus, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        if cfg.optimizer == "adam":
            torch._foreach_addcdiv_(ps, mus, denom, value=-lr / c1)
            return
        if cfg.optimizer == "adamw":
            upd = torch._foreach_div(mus, denom)
            torch._foreach_mul_(upd, 1.0 / c1)
            if cfg.weight_decay:
                torch._foreach_add_(upd, ps, alpha=cfg.weight_decay)
            torch._foreach_add_(ps, upd, alpha=-lr)
            return
        # RAdam: the adaptive step once the variance is tractable (rho >= 5),
        # the bias-corrected momentum before
        rho_inf = 2.0 / (1.0 - _B2) - 1.0
        rho = rho_inf - 2.0 * count * _B2**count / c2
        if rho >= 5.0:
            r = math.sqrt((rho - 4.0) * (rho - 2.0) * rho_inf
                          / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho))
            torch._foreach_addcdiv_(ps, mus, denom, value=-lr * r / c1)
        else:
            torch._foreach_add_(ps, mus, alpha=-lr / c1)

    def state_dict(self) -> dict:
        return self.state

    def load_state_dict(self, state: dict) -> None:
        """Moments and counts per group, as ``state_dict`` gives them (or as
        ``convert.opt_state_from_jax`` builds them); tensors are copied into
        the optimizer's own."""
        for g in self.state:
            for key in ("mu", "nu"):
                tree_copy_(self.state[g][key], state[g][key])
            self.state[g]["count"] = int(state[g]["count"])


def build_optimizer(group_configs: Mapping[str, OptimizerConfig], params: dict,
                    device=None) -> GroupOptimizer:
    """The optimizer of ``params``, a dict whose top-level keys are the group
    names in ``group_configs``. The parameters must lie on ``device`` (CUDA
    unless ``device="cpu"``); the state is made beside them."""
    dev = resolve_device(device)
    off = {p.device.type for p in tree_leaves(params)} - {dev.type}
    if off:
        raise ValueError(f"parameters on {sorted(off)}, optimizer asked for {dev.type!r}")
    return GroupOptimizer(group_configs, params)
