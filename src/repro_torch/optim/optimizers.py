"""Functional optimizers over flat buffers (counterpart of ``repro/optim/optimizers.py``).

SGD with heavy-ball momentum and AdamW (decoupled weight decay), with the
JAX package's API: ``opt.init(params) -> state`` and
``opt.update(grads, state, params) -> (updates, state)``, applied as
``p + u``.  Here ``params``/``grads`` are the port's flat ``(..., d)``
buffers, so every update is a handful of elementwise passes.  Algorithm 1
line 15 re-initialises the state after every aggregation, so ``init`` is a
cheap ``zeros_like``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "SgdState", "AdamWState", "sgd", "adamw"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[torch.Tensor], Any]
    update: Callable[[torch.Tensor, Any, torch.Tensor], tuple[torch.Tensor, Any]]
    name: str = "optimizer"


class SgdState(NamedTuple):
    momentum: torch.Tensor


def sgd(learning_rate: float = 1e-3, momentum: float = 0.5) -> Optimizer:
    """SGD with (heavy-ball) momentum: v ← m·v + g;  Δ = -lr·v."""

    def init(params: torch.Tensor) -> SgdState:
        return SgdState(momentum=torch.zeros_like(params))

    def update(grads: torch.Tensor, state: SgdState, params: torch.Tensor):
        del params
        v = momentum * state.momentum + grads
        return -learning_rate * v, SgdState(momentum=v)

    return Optimizer(init=init, update=update, name=f"sgd(lr={learning_rate},m={momentum})")


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, one counter per node: params.shape[:-1]
    mu: torch.Tensor
    nu: torch.Tensor


def adamw(
    learning_rate: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-2,
) -> Optimizer:
    """Adam with decoupled weight decay applied to the parameters."""

    def init(params: torch.Tensor) -> AdamWState:
        step = torch.zeros(params.shape[:-1], dtype=torch.int32, device=params.device)
        return AdamWState(step=step, mu=torch.zeros_like(params), nu=torch.zeros_like(params))

    def update(grads: torch.Tensor, state: AdamWState, params: torch.Tensor):
        step = state.step + 1
        mu = b1 * state.mu + (1 - b1) * grads
        nu = b2 * state.nu + (1 - b2) * torch.square(grads)
        t = step.to(torch.float32).unsqueeze(-1)
        bc1 = 1 - b1**t
        bc2 = 1 - b2**t
        mhat = mu / bc1
        vhat = nu / bc2
        updates = -learning_rate * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * params)
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update, name=f"adamw(lr={learning_rate},wd={weight_decay})")
