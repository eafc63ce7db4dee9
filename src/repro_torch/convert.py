"""Conversion between the JAX package's state layout (as numpy) and the port's.

The JAX ``DFLState`` keeps node-stacked pytrees (``fc{i}.w`` ``(n, in, out)``,
``fc{i}.b`` ``(n, out)``); as numpy arrays (``np.asarray`` of each leaf)
those have exactly the port's leaf layout, so the conversion is a copy into
one flat ``(n, d)`` buffer in the same leaf order.  Optimizer states are
recognised by their fields: ``momentum`` (SGD) or ``step``/``mu``/``nu``
(AdamW, with a per-node ``step`` after the JAX package's vmapped init).
A compressed-gossip mirror (the JAX ``DFLState.residual``, a params-shaped
fp32 tree) crosses over the same way, into ``DFLState.residual``.

A decoder's node-stacked state (nested dicts with ``stack`` / ``tail``
lists) converts the same way: the flat layout walks lists in the JAX
pytree order, so a row is ``ravel_pytree`` of the JAX node's tree.
Decoder parameter trees (one parameter set or node-stacked) also convert
leaf for leaf with ``params_from_numpy`` / ``params_to_numpy``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fed.trainer import DFLState
from repro_torch.flat import FlatLayout, tree_map
from repro_torch.optim import AdamWState, Optimizer, SgdState

__all__ = ["params_from_numpy", "params_to_numpy", "state_from_numpy", "to_numpy"]

Tree = dict[str, Any]


def _tensor_tree(tree: Tree, dev: torch.device) -> Tree:
    return tree_map(lambda a: _leaf_tensor(a, dev), tree)


def _numpy_tree(tree: Tree) -> Tree:
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def state_from_numpy(
    params: Tree,
    opt_state: Any = None,
    *,
    optimizer: Optimizer | None = None,
    residual: Tree | None = None,
    device: str | torch.device | None = None,
) -> DFLState:
    """A port ``DFLState`` at round 0 from node-stacked numpy params (and
    optionally the optimizer state; without it ``optimizer.init`` builds a
    fresh one, and the compressed-gossip mirror ``residual``, a params-shaped
    tree).  The failure-draw generator is a CPU generator seeded 0."""
    dev = resolve_device(device)
    tree = _tensor_tree(params, dev)
    layout = FlatLayout.of(tree)
    flat = layout.flatten(tree)
    fields = getattr(opt_state, "_fields", None)
    if opt_state is None:
        opt = None if optimizer is None else optimizer.init(flat)
    elif fields == ("momentum",):
        opt = SgdState(momentum=layout.flatten(_tensor_tree(opt_state.momentum, dev)))
    elif fields is not None and set(fields) == {"step", "mu", "nu"}:
        opt = AdamWState(
            step=torch.as_tensor(np.asarray(opt_state.step), dtype=torch.int32, device=dev),
            mu=layout.flatten(_tensor_tree(opt_state.mu, dev)),
            nu=layout.flatten(_tensor_tree(opt_state.nu, dev)),
        )
    else:
        raise TypeError(f"unrecognised optimizer state {type(opt_state).__name__} {fields}")
    return DFLState(
        params=flat,
        opt_state=opt,
        layout=layout,
        round=0,
        generator=torch.Generator().manual_seed(0),
        residual=None if residual is None else layout.flatten(_tensor_tree(residual, dev)).to(torch.float32),
    )


def to_numpy(state: DFLState, *, residual: bool = False) -> tuple:
    """(params, opt_state) in the JAX package's layout as numpy: the params
    tree, and the optimizer state's tuple with each flat buffer turned back
    into a tree (``step`` stays an array).  With ``residual=True`` a third
    element: the mirror as a params-shaped tree (None without one)."""
    layout = state.layout
    params = _numpy_tree(layout.views(state.params))
    mirror = None if state.residual is None else _numpy_tree(layout.views(state.residual))
    opt = state.opt_state
    if opt is not None:
        fields = {}
        for name, value in zip(opt._fields, opt):
            if value.shape[-1:] == (layout.size,):
                fields[name] = _numpy_tree(layout.views(value))
            else:
                fields[name] = value.detach().cpu().numpy()
        opt = type(opt)(**fields)
    return (params, opt, mirror) if residual else (params, opt)


def _leaf_tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as bf16 jax arrays convert
        return torch.tensor(a.astype(np.float32), device=dev).to(torch.bfloat16)
    return torch.tensor(a, device=dev)


def params_from_numpy(tree: Any, *, device: str | torch.device | None = None) -> Any:
    """A decoder parameter tree of numpy arrays (the JAX package's layout,
    node-stacked or not) as tensors on ``device`` (default ``cuda``); bf16
    arrays (numpy's view of bf16 jax arrays) stay bf16."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_tensor(a, dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """The tree back as numpy arrays; bf16 leaves come back as fp32 (numpy
    has no bf16), exactly."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)
