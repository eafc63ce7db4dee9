"""Communication-cost accounting: messages and bytes on the wire (counterpart of ``repro/obs/wirecost.py``).

Every trajectory reports what its mixing transmitted, and every count comes
from :func:`make_wire_fn`:

* **synchronous plans**: one DecAvg round exchanges two full models per
  live undirected edge.  A clean round is a static count; under failures,
  membership or fault masks the accountant replays the round's failure
  draw from a copy of the ``torch.Generator`` the mix drew from (the state
  before the round), so the count is exactly that of the operator's masks;
* **event-driven plans**: the executor counts delivered exchanges per
  wall-time bin; bytes follow as ``messages × row bytes``;
* **sharded plans** (``core/shardplan.py``): the halo traffic between
  ranks is a plan static, so :func:`sharded_wire_per_round` prices it once.

Directed plans have no event tables (a pairwise exchange has no
orientation), so they get no wire channels: the accountant is None and the
executors record none.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.commplan import CommPlan, PlanSchedule
from repro_torch.flat import tree_leaves

__all__ = [
    "make_wire_fn",
    "param_row_bytes",
    "sharded_wire_per_round",
    "static_wire_messages",
]


def _itemsize(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.dtype(leaf.dtype).itemsize


def param_row_bytes(params: Any, codec_bytes: Callable[[int, Any], float] | None = None) -> int:
    """Bytes of ONE node's model: every leaf carries a leading node axis, so
    a node's row is ``leaf.numel() / n`` elements of that leaf.

    ``params`` is a node-stacked tree (``DFLState.tree``; tensors or numpy
    arrays) or one flat ``(n, d)`` buffer.  Each leaf is priced at its own
    itemsize, a scalar leaf in full; ``codec_bytes(row_elems, dtype) ->
    float`` prices a compressed encoding instead (pass
    ``Compression.leaf_row_bytes``).  Fractional per-leaf costs add up
    exactly; only the total rounds."""
    total = 0.0
    for _, leaf in tree_leaves(params):
        size = int(np.prod(leaf.shape)) if leaf.ndim else 1
        row_elems = size // leaf.shape[0] if leaf.ndim else size
        if codec_bytes is not None:
            total += float(codec_bytes(int(row_elems), leaf.dtype))
        else:
            total += row_elems * _itemsize(leaf)
    return int(round(total))


def _event_plan(plan: CommPlan | PlanSchedule) -> CommPlan | None:
    probe = plan.plans[0] if isinstance(plan, PlanSchedule) else plan
    return probe if probe.event_uv is not None else None


def static_wire_messages(plan: CommPlan | PlanSchedule, n_rounds: int) -> np.ndarray | None:
    """(n_rounds,) clean-path delivered messages per round, host-side: two
    per undirected edge of the round's plan (a ``PlanSchedule`` resolves its
    round map).  None for directed plans."""
    if _event_plan(plan) is None:
        return None
    if isinstance(plan, PlanSchedule):
        per_plan = np.array([2 * p.n_edges for p in plan.plans], dtype=np.int64)
        return per_plan[[plan.plan_index(r) for r in range(n_rounds)]]
    return np.full(n_rounds, 2 * plan.n_edges, dtype=np.int64)


def make_wire_fn(plan: CommPlan | PlanSchedule) -> Callable[..., torch.Tensor | int] | None:
    """The per-round delivered-message accountant, or None (directed plans).

    ``wire(generator, round_index=0, active=None, edge_live=None)`` counts
    the messages the round's effective operator delivers: two for every
    edge of the plan active at ``round_index`` whose failure draw survives
    and whose endpoints are both active.  ``generator`` must be in the state
    the round's mix drew its masks from (a copy taken before the round);
    None means no draw: the round's draws, if any, are already ANDed into
    ``active`` / ``edge_live`` (the elastic executor's form).  ``active`` /
    ``edge_live`` are the mix's deterministic masks.  A host int when
    nothing is masked, else an int64 scalar on the plan's device."""
    if _event_plan(plan) is None:
        return None
    scheduled = isinstance(plan, PlanSchedule)

    def wire(generator: torch.Generator | None = None, round_index: int = 0, active=None, edge_live=None):
        view = plan.select(round_index) if scheduled else plan
        if generator is None:
            view = view._clean
        if not view._masked(active, edge_live):
            return 2 * view.n_edges
        if view.n_edges == 0:
            return 0
        edge_keep, node_act = view._round_masks_ext(generator, active, edge_live)
        uv = view.event_uv
        live = edge_keep[: uv.shape[0]] & node_act[uv[:, 0]] & node_act[uv[:, 1]]
        return 2 * live.sum()

    return wire


def sharded_wire_per_round(plan, params: Any, codec_bytes: Callable[[int, Any], float] | None = None) -> dict:
    """Static per-round wire stats of a ``ShardedCommPlan``'s mix.

    ``wire_bytes`` is the traffic between ranks for the whole parameter
    payload (the plan's static row count × one node's row bytes, every leaf
    included); ``wire_rows`` that row count; ``wire_collectives`` the
    collective launches a round: the plan's count a payload buffer × the
    buffers the mix packs the leaves into, one a dtype (the JAX package
    mixes, and counts, leaf by leaf).  ``codec_bytes`` follows
    :func:`param_row_bytes`: compressed rows price at the codec's
    encoding."""
    row_bytes = param_row_bytes(params, codec_bytes=codec_bytes)
    n_buffers = len({leaf.dtype for _, leaf in tree_leaves(params)})
    return {
        "wire_bytes": int(plan.cross_shard_bytes_per_round(row_bytes, "mix")),
        "wire_rows": int(plan.cross_shard_rows_per_round("mix")),
        "wire_collectives": int(plan.collectives_per_round("mix") * n_buffers),
    }
