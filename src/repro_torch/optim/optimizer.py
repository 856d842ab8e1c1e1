"""Optimizers: AdamW and SGD-momentum over parameter trees.

Counterpart of ``repro.optim.optimizer``.  Moments are fp32 whatever the
parameter dtype.  The reference is pure-functional and its train step
donates the old state; here the moments and (in :meth:`AdamW.apply`) the
parameters are updated in place, which is what donation buys in JAX: at
xlstm-1.3b's 2.0 B parameters a second copy of the fp32 weights and both
moments would be 24 GB.  ``update`` still returns the updates, so the
step's arithmetic reads like the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["AdamW", "SGD", "clip_by_global_norm", "global_norm", "OptState",
           "tree_map", "tree_leaves"]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for v in tree.values() for leaf in tree_leaves(v)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of one or more dict trees of one structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


class OptState(NamedTuple):
    step: int
    mu: Any
    nu: Any  # None for SGD


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale the tree by ``min(1, max_norm / norm)`` (in place); returns
    ``(tree, norm)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for x in tree_leaves(tree):
        x.copy_((x.float() * scale).to(x.dtype))
    return tree, norm


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    # linear warmup then constant (cosine is the caller's schedule)
    warmup_steps: int = 0

    def init(self, params) -> OptState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return OptState(step=0, mu=tree_map(zeros, params),
                        nu=tree_map(zeros, params))

    def schedule(self, step: int, like: torch.Tensor) -> torch.Tensor:
        lr = _f32(self.lr, like)
        if self.warmup_steps <= 0:
            return lr
        return lr * torch.clamp(_f32(step + 1, like) / self.warmup_steps, max=1.0)

    def update(self, grads, state: OptState, params) -> Tuple[Any, OptState]:
        """The updates ``-lr * m_hat / (sqrt(v_hat) + eps)`` (plus weight
        decay) in each parameter's dtype; the moments update in place."""
        step = state.step + 1
        b1, b2 = self.b1, self.b2

        def upd(g, m, v, p):
            g = g.float()
            lr = self.schedule(step, g)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mhat = m / (1 - _f32(b1, g) ** step)
            vhat = v / (1 - _f32(b2, g) ** step)
            u = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (-lr * u).to(p.dtype)

        updates = tree_map(upd, grads, state.mu, state.nu, params)
        return updates, OptState(step=step, mu=state.mu, nu=state.nu)

    def apply(self, params, updates):
        with torch.no_grad():
            for p, u in zip(tree_leaves(params), tree_leaves(updates)):
                p.add_(u.to(p.dtype))
        return params


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float = 1e-2
    momentum: float = 0.9

    def init(self, params) -> OptState:
        mu = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
        return OptState(step=0, mu=mu, nu=None)

    def update(self, grads, state: OptState, params: Optional[Any] = None
               ) -> Tuple[Any, OptState]:
        def upd(g, m):
            m.mul_(self.momentum).add_(g.float())
            return -self.lr * m

        updates = tree_map(upd, grads, state.mu)
        return updates, OptState(step=state.step + 1, mu=state.mu, nu=None)

    def apply(self, params, updates):
        with torch.no_grad():
            for p, u in zip(tree_leaves(params), tree_leaves(updates)):
                p.add_(u.to(p.dtype))
        return params
