"""Elastic membership: nodes that join and leave inside a static envelope
(counterpart of ``repro/core/membership.py``, a numpy copy).

The paper's population is fixed (§2); real decentralised deployments are not
— nodes arrive, depart, crash, and come back (ROADMAP direction 5; the
coordination-free regime of PAPERS.md 2312.04504).  This module applies the
``PlanSchedule`` padding trick to the **node axis**: the compiled plans and
the executor's scanned round body keep one static shape (the n-node
*envelope*), and membership lowers to per-round boolean masks the
``CommPlan`` operators AND into their failure draws (``active=`` /
``edge_live=``).  A node outside the membership renormalises to the identity
row — it keeps its own model and nobody receives from it — exactly like a
node the Bernoulli failure draw dropped, so all the mass-conservation and
parity machinery carries over unchanged.

Join protocol (uncoordinated, §4.4 applied mid-run):

1. At its **arrival round** a node starts gossiping (``gossip`` mask on):
   it draws fresh Exp(1) sketches and rides ``spread_min`` with the live
   population, re-deriving n̂ online via the leaderless extrema sketches —
   no leader, no barrier, no global round counter shared with anyone.
2. After ``join_warmup`` rounds of estimation the node **initialises**
   (``inits[r]`` one-shot flag): it draws fresh uncoordinated-init params
   with the gain its own n̂ implies and joins training (``active`` mask on).

Departures simply clear both masks from the departure round; a later
re-arrival of the same slot re-runs the join protocol (crash + resume with
amnesia).  Everything is realised host-side into (n_rounds, n) numpy masks:
seeded, deterministic, replayable — the port's elastic executor
(``fed.run_elastic_trajectory``) reads round r's row on the host and hands
it to the plan's operators.  Pure numpy, bitwise the JAX package's masks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "MembershipSchedule",
    "membership_schedule",
    "poisson_membership",
]


@dataclasses.dataclass(frozen=True)
class MembershipSchedule:
    """Realised per-round membership masks over the n-node envelope.

    ``active``  (n_rounds, n) bool — node trains and mixes this round.
    ``gossip``  (n_rounds, n) bool — node carries estimation traffic
                (superset of ``active``: joiners gossip during warmup
                before they train).
    ``joins``   (n_rounds, n) bool — one-shot: node (re)drew its sketches
                this round (arrival instant).
    ``inits``   (n_rounds, n) bool — one-shot: node initialises params from
                its online n̂ this round and enters training.
    """

    n: int
    n_rounds: int
    active: np.ndarray
    gossip: np.ndarray
    joins: np.ndarray
    inits: np.ndarray
    join_warmup: int = 8

    def __post_init__(self):
        shape = (self.n_rounds, self.n)
        for f in ("active", "gossip", "joins", "inits"):
            a = getattr(self, f)
            if a.shape != shape or a.dtype != np.bool_:
                raise ValueError(f"{f} must be bool {shape}, got {a.dtype} {a.shape}")
        if np.any(self.active & ~self.gossip):
            raise ValueError("active nodes must gossip (active ⊆ gossip)")

    @property
    def trivial(self) -> bool:
        """No membership dynamics at all — the static executors' regime."""
        return bool(self.active.all() and self.gossip.all()
                    and not self.joins.any() and not self.inits.any())

    def n_active(self) -> np.ndarray:
        """(n_rounds,) live training population per round."""
        return self.active.sum(axis=1).astype(np.int32)


def _check_round(r: int, n_rounds: int, what: str) -> int:
    r = int(r)
    if not 0 <= r < n_rounds:
        raise ValueError(f"{what} round {r} outside [0, {n_rounds})")
    return r


def membership_schedule(
    n: int,
    n_rounds: int,
    *,
    initial: np.ndarray | int | None = None,
    arrivals: dict[int, list[int]] | tuple = (),
    departures: dict[int, list[int]] | tuple = (),
    join_warmup: int = 8,
) -> MembershipSchedule:
    """Lower explicit arrival/departure events into per-round masks.

    ``initial``: the round-0 training membership — a bool/int mask, an int
    (the first ``initial`` node slots), or None (everyone).  ``arrivals`` /
    ``departures`` map round → node ids (dict) or are (round, node) pair
    iterables.  An arriving node gossips from its arrival round and starts
    *training* ``join_warmup`` rounds later (clipped to the horizon: a
    too-late arrival gossips but never trains).  A departure clears both
    masks; the same slot may arrive again later (crash + rejoin, with
    amnesia — it re-runs the join protocol from scratch).
    """
    if n < 1 or n_rounds < 1:
        raise ValueError(f"need n >= 1 and n_rounds >= 1, got {n}, {n_rounds}")
    if isinstance(initial, (int, np.integer)):
        base = np.zeros(n, bool)
        base[: int(initial)] = True
    elif initial is None:
        base = np.ones(n, bool)
    else:
        base = np.asarray(initial, bool)
        if base.shape != (n,):
            raise ValueError(f"initial mask must have shape ({n},), got {base.shape}")

    def _pairs(spec) -> list[tuple[int, int]]:
        if isinstance(spec, dict):
            return [(int(r), int(i)) for r, nodes in spec.items() for i in np.atleast_1d(nodes)]
        return [(int(r), int(i)) for r, i in spec]

    arr = sorted(_pairs(arrivals))
    dep = sorted(_pairs(departures))
    for r, i in arr + dep:
        _check_round(r, n_rounds, "membership event")
        if not 0 <= i < n:
            raise ValueError(f"node {i} outside the {n}-node envelope")
    for r, i in arr:
        if base[i]:
            pre = [(rd, j) for rd, j in dep if j == i and rd <= r]
            if not pre:
                raise ValueError(f"node {i} arrives at round {r} but is already a member")

    active = np.tile(base, (n_rounds, 1))
    gossip = active.copy()
    joins = np.zeros((n_rounds, n), bool)
    inits = np.zeros((n_rounds, n), bool)
    # merge-sort events by round: a departure and a later re-arrival of the
    # same slot compose left to right
    events = sorted([(r, "dep", i) for r, i in dep] + [(r, "arr", i) for r, i in arr])
    for r, kind, i in events:
        if kind == "dep":
            active[r:, i] = False
            gossip[r:, i] = False
        else:
            gossip[r:, i] = True
            joins[r, i] = True
            r_train = r + int(join_warmup)
            if r_train < n_rounds:
                inits[r_train, i] = True
                active[r_train:, i] = True
    return MembershipSchedule(
        n=n, n_rounds=n_rounds, active=active, gossip=gossip,
        joins=joins, inits=inits, join_warmup=int(join_warmup),
    )


def poisson_membership(
    n: int,
    n_rounds: int,
    *,
    initial: int,
    arrival_rate: float = 0.0,
    departure_rate: float = 0.0,
    min_active: int = 2,
    join_warmup: int = 8,
    seed: int = 0,
) -> MembershipSchedule:
    """Seeded stochastic churn: per-round Poisson arrivals fill empty slots,
    per-member Bernoulli departures drain them, floored at ``min_active``
    training members.  A pure function of ``seed`` — host-replayable, like
    ``churn_sequence`` and ``poisson_event_stream``."""
    if not 0 < initial <= n:
        raise ValueError(f"initial membership must be in (0, {n}], got {initial}")
    rng = np.random.default_rng(seed)
    member = np.zeros(n, bool)
    member[:initial] = True
    arrivals: list[tuple[int, int]] = []
    departures: list[tuple[int, int]] = []
    for r in range(n_rounds):
        if departure_rate > 0.0:
            leave = np.nonzero(member & (rng.random(n) < departure_rate))[0]
            for i in leave:
                if member.sum() <= min_active:
                    break
                member[i] = False
                departures.append((r, int(i)))
        if arrival_rate > 0.0:
            k = min(int(rng.poisson(arrival_rate)), int((~member).sum()))
            if k:
                slots = rng.choice(np.nonzero(~member)[0], size=k, replace=False)
                for i in slots:
                    member[i] = True
                    arrivals.append((r, int(i)))
    return membership_schedule(
        n, n_rounds, initial=initial, arrivals=arrivals,
        departures=departures, join_warmup=join_warmup,
    )
