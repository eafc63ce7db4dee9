"""Deterministic fault injection beyond i.i.d. dropout (counterpart of
``repro/core/faults.py``, a numpy copy over the port's ``topology.Graph``).

``FailureModel`` covers the paper's §4.2 regime — independent per-round
Bernoulli link/node survival.  Real outages are *correlated*: a rack loses
power (crash burst), a switch partitions the network, the best-connected
nodes are exactly the ones overloaded first (2402.18606's topology-impact
result: robustness depends on **which** nodes fail), and the whole training
process gets preempted mid-scan.  ``FaultPlan`` realises those scenarios
host-side — seeded, replayable, a pure function of its arguments — into
per-round boolean masks that ride the same ``active=`` / ``edge_live=``
channel as membership (``CommPlan`` renormalises the masked operator, mass
conserved), plus a preemption schedule the executor's checkpoint layer turns
into SIGKILL-style kills.

Composition: masks AND together (``compose``), and the whole stack ANDs
with the membership schedule and the Bernoulli draws inside the operator —
deterministic outages, stochastic dropout, and elastic membership are one
orthogonal mask algebra.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .topology import Graph

__all__ = [
    "FaultPlan",
    "no_faults",
    "crash_burst",
    "partition",
    "hub_outage",
    "preemption",
    "compose",
    "scenario",
    "SCENARIOS",
]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Realised per-round outage masks (True = up) over a fixed graph.

    ``node_up``  (n_rounds, n) bool;
    ``edge_up``  (n_rounds, n_edges) bool in ``Graph.edge_list()`` order —
                 the failure-mask index order every backend shares;
    ``preempt_chunks``  chunk indices after whose checkpoint the executor
                 kills the process (``fed.executor.CheckpointPolicy``).
    """

    name: str
    n: int
    n_rounds: int
    node_up: np.ndarray
    edge_up: np.ndarray
    preempt_chunks: tuple[int, ...] = ()

    def __post_init__(self):
        if self.node_up.shape != (self.n_rounds, self.n) or self.node_up.dtype != np.bool_:
            raise ValueError(
                f"node_up must be bool ({self.n_rounds}, {self.n}), "
                f"got {self.node_up.dtype} {self.node_up.shape}"
            )
        if self.edge_up.ndim != 2 or self.edge_up.shape[0] != self.n_rounds:
            raise ValueError(f"edge_up must be (n_rounds, n_edges), got {self.edge_up.shape}")

    @property
    def trivial(self) -> bool:
        return bool(self.node_up.all() and self.edge_up.all() and not self.preempt_chunks)


def _blank(name: str, n: int, n_edges: int, n_rounds: int) -> tuple[np.ndarray, np.ndarray]:
    return np.ones((n_rounds, n), bool), np.ones((n_rounds, n_edges), bool)


def no_faults(graph: Graph, n_rounds: int) -> FaultPlan:
    node_up, edge_up = _blank("none", graph.n, len(graph.edge_list()), n_rounds)
    return FaultPlan("none", graph.n, n_rounds, node_up, edge_up)


def _window(at: int, duration: int, n_rounds: int) -> slice:
    if not 0 <= at < n_rounds:
        raise ValueError(f"fault onset round {at} outside [0, {n_rounds})")
    if duration < 1:
        raise ValueError(f"fault duration must be >= 1, got {duration}")
    return slice(at, min(at + duration, n_rounds))


def crash_burst(
    graph: Graph,
    n_rounds: int,
    *,
    at: int,
    size: int,
    duration: int,
    seed: int = 0,
    targeted: bool = False,
) -> FaultPlan:
    """``size`` nodes go down together for ``duration`` rounds — the
    correlated burst i.i.d. dropout cannot express.  ``targeted=True`` takes
    the ``size`` highest-degree nodes (the hubs whose loss 2402.18606 shows
    hurts most); otherwise a seeded uniform draw."""
    n = graph.n
    if not 0 < size <= n:
        raise ValueError(f"burst size must be in (0, {n}], got {size}")
    w = _window(at, duration, n_rounds)
    if targeted:
        victims = np.argsort(-graph.degrees, kind="stable")[:size]
    else:
        victims = np.random.default_rng(seed).choice(n, size=size, replace=False)
    node_up, edge_up = _blank("crash", n, len(graph.edge_list()), n_rounds)
    node_up[w.start : w.stop, victims] = False
    tag = "hub-crash" if targeted else "crash"
    return FaultPlan(f"{tag}@{at}x{size}", n, n_rounds, node_up, edge_up)


def partition(
    graph: Graph,
    n_rounds: int,
    *,
    at: int,
    duration: int,
    seed: int = 0,
) -> FaultPlan:
    """A temporary network split: a seeded balanced node cut, every edge
    crossing it down for ``duration`` rounds.  Nodes stay up — both halves
    keep training and mixing internally, then re-merge; the transient the
    recovery curves in ``benchmarks/fig11_elastic.py`` measure."""
    n = graph.n
    w = _window(at, duration, n_rounds)
    side = np.zeros(n, bool)
    half = np.random.default_rng(seed).choice(n, size=n // 2, replace=False)
    side[half] = True
    edges = graph.edge_list()
    cross = side[edges[:, 0]] != side[edges[:, 1]]
    node_up, edge_up = _blank("partition", n, len(edges), n_rounds)
    edge_up[w.start : w.stop, :] = np.broadcast_to(~cross, (w.stop - w.start, len(edges)))
    return FaultPlan(f"partition@{at}", n, n_rounds, node_up, edge_up)


def hub_outage(
    graph: Graph,
    n_rounds: int,
    *,
    at: int,
    duration: int,
    k: int = 1,
) -> FaultPlan:
    """The ``k`` highest-degree nodes go dark for ``duration`` rounds —
    degree-targeted outage, deterministic (no seed: the hubs are a property
    of the topology)."""
    return crash_burst(
        graph, n_rounds, at=at, size=k, duration=duration, targeted=True
    )


def preemption(graph: Graph, n_rounds: int, chunks: tuple[int, ...] | list[int]) -> FaultPlan:
    """No network faults — the *process* dies: after each listed chunk's
    checkpoint lands, the executor SIGKILLs itself, and the driver resumes
    from LATEST.  The resume-parity contract makes this invisible in the
    trajectory (bit-identical params/metrics)."""
    node_up, edge_up = _blank("preempt", graph.n, len(graph.edge_list()), n_rounds)
    return FaultPlan(
        f"preempt@{','.join(map(str, chunks))}", graph.n, n_rounds,
        node_up, edge_up, preempt_chunks=tuple(int(c) for c in chunks),
    )


def compose(*plans: FaultPlan) -> FaultPlan:
    """AND the masks, union the preemption schedule."""
    if not plans:
        raise ValueError("compose needs at least one FaultPlan")
    first = plans[0]
    for p in plans[1:]:
        if (p.n, p.n_rounds, p.edge_up.shape[1]) != (
            first.n, first.n_rounds, first.edge_up.shape[1]
        ):
            raise ValueError("composed FaultPlans must share the (n, n_rounds, n_edges) envelope")
    node_up = np.logical_and.reduce([p.node_up for p in plans])
    edge_up = np.logical_and.reduce([p.edge_up for p in plans])
    chunks = tuple(sorted({c for p in plans for c in p.preempt_chunks}))
    name = "+".join(p.name for p in plans)
    return FaultPlan(name, first.n, first.n_rounds, node_up, edge_up, preempt_chunks=chunks)


# named scenarios for the CLI / benchmarks: graph, n_rounds, seed → FaultPlan
SCENARIOS = {
    "none": lambda g, R, s: no_faults(g, R),
    "crash": lambda g, R, s: crash_burst(
        g, R, at=R // 3, size=max(g.n // 8, 1), duration=max(R // 10, 1), seed=s
    ),
    "hub": lambda g, R, s: hub_outage(
        g, R, at=R // 3, duration=max(R // 10, 1), k=max(g.n // 16, 1)
    ),
    "partition": lambda g, R, s: partition(
        g, R, at=R // 3, duration=max(R // 10, 1), seed=s
    ),
    "crash+partition": lambda g, R, s: compose(
        crash_burst(g, R, at=R // 4, size=max(g.n // 8, 1), duration=max(R // 10, 1), seed=s),
        partition(g, R, at=R // 2, duration=max(R // 10, 1), seed=s + 1),
    ),
}


def scenario(name: str, graph: Graph, n_rounds: int, seed: int = 0) -> FaultPlan:
    """Instantiate a named fault scenario (``--fault-scenario`` on the CLI)."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown fault scenario {name!r}; have {sorted(SCENARIOS)}")
    return SCENARIOS[name](graph, n_rounds, seed)
