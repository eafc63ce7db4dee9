"""Conversion between the JAX package's state layout (as numpy) and the port's flat buffers.

The JAX ``DFLState`` keeps node-stacked pytrees (``fc{i}.w`` ``(n, in, out)``,
``fc{i}.b`` ``(n, out)``); as numpy arrays (``np.asarray`` of each leaf)
those have exactly the port's leaf layout, so the conversion is a copy into
one flat ``(n, d)`` buffer in the same leaf order.  Optimizer states are
recognised by their fields: ``momentum`` (SGD) or ``step``/``mu``/``nu``
(AdamW, with a per-node ``step`` after the JAX package's vmapped init).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fed.trainer import DFLState
from repro_torch.flat import FlatLayout, tree_from_leaves, tree_leaves
from repro_torch.optim import AdamWState, Optimizer, SgdState

__all__ = ["state_from_numpy", "to_numpy"]

Tree = dict[str, Any]


def _tensor_tree(tree: Tree, dev: torch.device) -> Tree:
    paths, leaves = zip(*tree_leaves(tree))
    return tree_from_leaves(paths, [torch.tensor(np.asarray(a), device=dev) for a in leaves])


def _numpy_tree(tree: Tree) -> Tree:
    paths, leaves = zip(*tree_leaves(tree))
    return tree_from_leaves(paths, [t.detach().cpu().numpy() for t in leaves])


def state_from_numpy(
    params: Tree,
    opt_state: Any = None,
    *,
    optimizer: Optimizer | None = None,
    device: str | torch.device | None = None,
) -> DFLState:
    """A port ``DFLState`` at round 0 from node-stacked numpy params (and
    optionally the optimizer state; without it ``optimizer.init`` builds a
    fresh one).  The failure-draw generator is a CPU generator seeded 0."""
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
    )


def to_numpy(state: DFLState) -> tuple[Tree, Any]:
    """(params, opt_state) in the JAX package's layout as numpy: the params
    tree, and the optimizer state's tuple with each flat buffer turned back
    into a tree (``step`` stays an array)."""
    layout = state.layout
    params = _numpy_tree(layout.views(state.params))
    opt = state.opt_state
    if opt is None:
        return params, None
    fields = {}
    for name, value in zip(opt._fields, opt):
        if value.shape[-1:] == (layout.size,):
            fields[name] = _numpy_tree(layout.views(value))
        else:
            fields[name] = value.detach().cpu().numpy()
    return params, type(opt)(**fields)
