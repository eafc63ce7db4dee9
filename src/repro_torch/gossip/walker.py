"""Random-walk degree polling on the plan's device (counterpart of
``repro/gossip/walker.py``, paper §3/§4.4, ref [35]).

All walkers advance one CSR transition per step, as tensors, so a (starts ×
n_walks) fleet costs ``walk_length`` gathers.  A simple random walk visits
nodes ∝ degree (the excess-degree bias q(k)); ``correct_bias`` resamples
∝ 1/k (``torch.multinomial``) to recover p(k), the distribution
``v_steady_norm_from_degree_sample`` expects.

Degree-0 guard (as the host reference): a walker on a node without
neighbours stays put, and walkers ending on such a sink are left out of the
1/k resample.  Start nodes are checked on the host.

Failure model: given the training ``CommPlan`` as ``plan``, each step draws
a training round's per-edge / per-node Bernoullis (``CommPlan.round_masks``);
a transition over a failed link, or to or from an inactive node, keeps the
walker in place for that step.

``plan`` may be a ``PlanSchedule`` (K > 1): step r then moves over the CSR
of the plan active at round r (a row of ``PlanSchedule.stacked_csr``), its
failure masks drawn at the schedule's edge envelope, and the polled degree
is the final node's degree in the plan active at the last step, the degree
a node observes when the poll ends.  The start nodes are checked on the
schedule's graph (as the JAX package's), on ``graph`` otherwise.

Draws: one CPU generator seeded ``seed``, consumed in order: per step the
(s, n_walks) uniforms (``torch.rand``), then that step's failure masks; then
the resample.  They are copied to the plan's device, so every device walks
the same paths.  ``_uniforms``, ``_step_masks`` and ``_resample`` are the
three places the draws come from (the tests inject the JAX package's there).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.commplan import CommPlan, PlanSchedule
from repro_torch.core.topology import Graph
from repro_torch.device import resolve_device

__all__ = ["poll_degrees_device"]


def _uniforms(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator)


def _step_masks(plan: CommPlan | PlanSchedule, generator: torch.Generator):
    return plan.round_masks(generator)


def _resample(generator: torch.Generator, ks: torch.Tensor) -> torch.Tensor:
    """(s, n_walks) CPU indices into each row of the polled degrees ``ks``,
    drawn ∝ 1/k with replacement: the resample that undoes the ∝ k visit
    bias.  Walkers on a sink (k = 0) carry no degree information and get no
    weight; a row of sinks only is drawn uniformly (as equal logits are in
    the JAX package)."""
    w = torch.where(ks > 0, 1.0 / torch.clamp_min(ks, 1.0), 0.0).cpu()
    w = torch.where(w.sum(dim=1, keepdim=True) > 0, w, 1.0)
    return torch.multinomial(w, w.shape[1], replacement=True, generator=generator)


def poll_degrees_device(
    graph: Graph,
    start,
    *,
    walk_length: int,
    n_walks: int,
    seed: int,
    correct_bias: bool = True,
    plan: CommPlan | PlanSchedule | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """``n_walks`` walks of ``walk_length`` steps from each start node.

    ``start``: a node id → (n_walks,) polled degrees; an (s,) array of ids
    (``arange(n)``: every node polls itself) → (s, n_walks), float32 on the
    plan's device (``device`` without a plan, default cuda).
    """
    dev = plan.device if plan is not None else resolve_device(device)
    scheduled = isinstance(plan, PlanSchedule) and plan.k > 1
    indptr_np, indices_np, uid_np = (plan.graph if scheduled else graph).csr()
    if len(indices_np) == 0:
        raise ValueError("poll_degrees_device: graph has no edges — nothing to poll")
    deg_np = np.diff(indptr_np)
    starts_np = np.atleast_1d(np.asarray(start))
    if np.any(deg_np[starts_np] == 0):
        bad = starts_np[deg_np[starts_np] == 0]
        raise ValueError(
            f"poll_degrees_device: start node(s) {bad.tolist()} have no "
            "neighbours — every walk would be stuck and the 1/k bias "
            "correction would divide by zero"
        )
    i64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)  # noqa: E731
    names = ("indptr", "indices", "uid", "deg", "degrees")
    if scheduled:
        # step r walks the CSR of the plan active at round r
        csr = plan.stacked_csr()
        tables = lambda r: tuple(csr[k][plan.plan_index(r)] for k in names)  # noqa: E731
    else:
        static = (i64(indptr_np), i64(indices_np), i64(uid_np), i64(np.diff(indptr_np)),
                  torch.as_tensor(graph.degrees, dtype=torch.float32, device=dev))
        tables = lambda r: static  # noqa: E731
    with_failures = plan is not None and plan.failures.active
    gen = torch.Generator().manual_seed(seed)

    v = i64(starts_np)[:, None].expand(len(starts_np), n_walks).contiguous()
    for r in range(walk_length):
        indptr, indices, uid, deg, _ = tables(r)
        u = _uniforms(gen, v.shape).to(dev)
        d = deg[v]
        idx = torch.where(d > 0, indptr[v] + (u * d).to(torch.int64), 0)
        nxt = indices[idx]
        ok = d > 0
        if with_failures:
            edge_keep, active = (t.to(dev) for t in _step_masks(plan, gen))
            ok = ok & edge_keep[uid[idx]] & active[v] & active[nxt]
        v = torch.where(ok, nxt, v)
    ks = tables(walk_length - 1)[4][v]
    if correct_bias:
        ks = torch.gather(ks, 1, _resample(gen, ks).to(dev))
    return ks[0] if np.ndim(start) == 0 else ks
