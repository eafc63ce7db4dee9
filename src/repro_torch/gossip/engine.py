"""Gossip estimation engine over the port's ``CommPlan`` (counterpart of
``repro/gossip/engine.py``, paper §4.4).

The paper's *uncoordinated* initialisation has every node estimate
``‖v_steady‖`` (or the system size n and a family exponent) from nothing
but neighbour exchanges.  ``core/gossip.py`` pins the protocols down in
numpy; this module runs them over the compiled ``CommPlan`` a training run
uses, with the training round's failure draws, so estimation traffic rides
the same unreliable links as DecAvg itself.  One gossip round is
``CommPlan.spread``, the column-stochastic transpose Mᵀ of the receive
operator (for undirected unit-weight graphs the paper's Eq. 3 matrix A'):
one launch of the dense or block-sparse mixing kernel on the card.

Protocols
---------
``push_sum``               (s, w) ratio gossip → every node's estimate of the
                           uniform average of an (n,) / (n, k) payload.
``estimate_size``          n̂ from push-sum of a leader one-hot.
``estimate_size_leaderless``  n̂ from exponential-random-minimum sketches.
``estimate_mean_degree``   ⟨k⟩ from push-sum of local degrees.
``power_iteration_norm``   ‖v̂_steady‖ per node: power-iterate x ← A'x from
                           x₀ = 1 (x → n·v), then push-sum [x², 1_leader].
``estimate_all``           (n̂, ‖v̂‖, ⟨k̂⟩) with one shared push-sum phase.
``make_gain_estimator``    seed → (n,) per-node init gains, on the plan's
                           device, for ``fed.executor.run_warmup_trajectory``.
``spread_events`` / ``push_sum_events`` / ``estimate_size_leaderless_events``
                           the barrier-free renderings: pairwise exchanges
                           as an ``EventStream``'s edge clocks fire
                           (``CommPlan.event_spread`` / ``event_spread_min``),
                           no round counter at all.

Randomness
----------
The JAX package keys gossip round r as ``fold_in(key, round_offset + r)``:
one global round counter across a protocol's phases.  Here a protocol takes
an integer ``seed`` and round r draws its failure masks
(``CommPlan.round_masks``) from its own CPU generator,
``round_generator(seed, r)``, seeded by ``SeedSequence([seed, r])``.  So a
round's draws depend on (seed, r) alone: phase 2 starts its counter at the
phase-1 budget actually run, and a budget-b estimate replays the rounds of
any run that shares its first rounds.  Being CPU draws copied to the
plan's device, they are the same on every device.  Over a ``PlanSchedule``
round r also runs on the plan active at round r (``plan_index(round_offset
+ r)``), its masks drawn at the schedule's edge envelope: estimation runs
on the dynamic graph the nodes see.  ``_round_masks`` is the
one place the rounds take their masks from (the tests inject the JAX
package's draws there).  The other draws split a seed with
``split_seed``: a gain estimator's seed into (gossip, walk, sketch) seeds,
a warmup run's into (estimation, init) seeds.  A sweep budget b runs b
rounds a phase, where the JAX package masks the tail rounds of its largest
budget: the same numbers, fewer launches.  An event protocol takes a seed
too: event i's failure flag is row i of ``commplan.event_flags(plan, seed,
stream)`` (the JAX package keys it ``fold_in(key, i)``), the one hook the
tests inject the JAX draws through.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import commplan as _commplan
from repro_torch.core.commplan import CommPlan, PlanSchedule, compile_plan, compile_schedule
from repro_torch.core.shardplan import ShardedCommPlan, shard_plan
from repro_torch.core.topology import EventStream, Graph

from .walker import poll_degrees_device

__all__ = [
    "GossipEstimates",
    "as_plan",
    "estimate_all",
    "estimate_mean_degree",
    "estimate_size",
    "estimate_size_leaderless",
    "estimate_size_leaderless_events",
    "gain_from_degree_sample",
    "gains_from_estimates",
    "make_gain_estimator",
    "power_iteration_norm",
    "push_sum",
    "push_sum_events",
    "round_generator",
    "split_seed",
    "spread_events",
    "spread_rounds",
]

_EPS = 1e-30  # guards 1/z before mass from the leader one-hot arrives
# below this a node's push-sum weight of the leader one-hot is zero up to
# fp32 underflow: the budget never carried the leader's mass there
_UNREACHED = 1e-20
Plan = CommPlan | PlanSchedule | ShardedCommPlan


def split_seed(seed: int, n: int) -> list[int]:
    """``n`` independent child seeds of ``seed`` (``SeedSequence.spawn``)."""
    return [int(c.generate_state(1, np.uint64)[0]) for c in np.random.SeedSequence(seed).spawn(n)]


def round_generator(seed: int, r: int) -> torch.Generator:
    """The CPU generator gossip round ``r`` of a protocol seeded ``seed`` draws from."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence([seed, r]).generate_state(1, np.uint64)[0]))


def as_plan(
    graph_or_plan: Graph | Plan, backend: str = "auto", device: str | torch.device | None = None
) -> Plan:
    """Estimation plans are unit-data-size: Eq. 3 weights, not |D_j|-weighted.

    A ``CommPlan``, ``PlanSchedule`` or ``ShardedCommPlan`` without data
    sizes is used as it is; one with data sizes is recompiled without them
    (not ``with_options(data_sizes=None)``: there None means "keep"), a
    sharded plan re-sharded over its group.  Over a sharded plan the
    estimation's ``spread`` / ``spread_min`` rounds run through its halo
    collectives (every rank of the group makes the same calls).  A
    ``Graph`` is compiled on ``device`` (default cuda).
    """
    if isinstance(graph_or_plan, ShardedCommPlan):
        sp = graph_or_plan
        if sp.data_sizes is None:
            return sp
        base = compile_plan(sp.graph, backend=sp.backend, failures=sp.failures, device=sp.device)
        return shard_plan(base, group=sp.group)
    if isinstance(graph_or_plan, PlanSchedule):
        sched = graph_or_plan
        if sched.data_sizes is None:
            return sched
        return compile_schedule([p.graph for p in sched.plans], backend=sched.backend, failures=sched.failures,
                                round_map=sched.round_map, device=sched.device)
    if isinstance(graph_or_plan, CommPlan):
        if graph_or_plan.data_sizes is None:
            return graph_or_plan
        return compile_plan(
            graph_or_plan.graph, backend=graph_or_plan.backend, failures=graph_or_plan.failures,
            device=graph_or_plan.device,
        )
    return compile_plan(graph_or_plan, backend=backend, device=device)


def _round_masks(plan: Plan, seed: int | None, r: int):
    """Round r's (node_active, edge_keep) failure draws, or (None, None)
    when the plan draws none (a schedule's at its edge envelope)."""
    if not plan.failures.active:
        return None, None
    if seed is None:
        raise ValueError("failure model active: gossip needs a seed")
    edge_keep, node_act = plan.round_masks(round_generator(seed, r))
    return node_act, edge_keep


def _rounds(plan: Plan, op: str, x: torch.Tensor, rounds: int, seed, round_offset: int, trace: bool):
    """``rounds`` × ``plan.<op>`` (spread or spread_min), round r of the
    global counter at ``round_offset + r`` taking ``_round_masks``'s draws
    (over a schedule, on the plan active at that round)."""
    scheduled = isinstance(plan, PlanSchedule)
    states = []
    for r in range(round_offset, round_offset + rounds):
        active, edge_live = _round_masks(plan, seed, r)
        # the draws come in as masks, so the round runs on the failure-free
        # twin of the plan (its tensors shared, made once, its Mᵀ kept)
        fn = getattr((plan.select(r) if scheduled else plan)._clean, op)
        x = fn(x, active=active, edge_live=edge_live)
        if trace:
            states.append(x)
    if not trace:
        return x
    return x, (torch.stack(states) if states else x.new_zeros((0, *x.shape)))


def _payload(plan: Plan, values) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.float32, device=plan.device)


def spread_rounds(
    plan: Plan | Graph, values, rounds: int, seed: int | None = None, *, round_offset: int = 0,
    trace: bool = False,
):
    """``rounds`` applications of the send operator to an (n,) / (n, k)
    payload; with ``trace=True`` also the (rounds, n[, k]) per-round states."""
    plan = as_plan(plan)
    return _rounds(plan, "spread", _payload(plan, values), rounds, seed, round_offset, trace)


def push_sum(
    plan: Plan | Graph, values, rounds: int, seed: int | None = None, *, round_offset: int = 0,
    trace: bool = False,
):
    """Kempe push-sum: (s, w) spread together as one (n, k + 1) payload,
    one kernel launch a round; s/w is every node's running estimate of the
    uniform average.  Returns the estimates in ``values``' shape; with
    ``trace=True`` also the per-round estimates."""
    plan = as_plan(plan)
    x = _payload(plan, values)
    squeeze = x.ndim == 1
    x2 = x[:, None] if squeeze else x
    payload = torch.cat([x2, torch.ones_like(x2[:, :1])], dim=1)
    out = _rounds(plan, "spread", payload, rounds, seed, round_offset, trace)
    payload, tr = out if trace else (out, None)
    ratio = payload[:, :-1] / payload[:, -1:]
    ratio = ratio[:, 0] if squeeze else ratio
    if not trace:
        return ratio
    tr_ratio = tr[..., :-1] / tr[..., -1:]
    return ratio, (tr_ratio[..., 0] if squeeze else tr_ratio)


def _one_hot(plan: Plan, leader: int) -> torch.Tensor:
    x = torch.zeros(plan.n, dtype=torch.float32, device=plan.device)
    x[leader] = 1.0
    return x


def estimate_size(
    plan: Plan | Graph, rounds: int, seed: int | None = None, *, leader: int = 0, round_offset: int = 0
) -> torch.Tensor:
    """Every node's n̂ after ``rounds`` of push-sum of a leader one-hot."""
    plan = as_plan(plan)
    avg = push_sum(plan, _one_hot(plan, leader), rounds, seed, round_offset=round_offset)
    return 1.0 / torch.clamp_min(avg, _EPS)


def _draw_sketches(seed: int, n: int, m: int, device) -> torch.Tensor:
    """(n, m) iid Exp(1) sketches from a CPU generator seeded ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return torch.empty(n, m, dtype=torch.float32).exponential_(generator=g).to(device)


def _sketch_n_hat(plan: Plan, sketches: torch.Tensor, rounds: int, seed, round_offset: int = 0):
    """Propagate the (n, m) sketches by min-exchange and invert the summed
    minima: (n̂, mins)."""
    mins = _rounds(plan, "spread_min", sketches, rounds, seed, round_offset, False)
    m = sketches.shape[1]
    return (m - 1) / torch.clamp_min(mins.sum(dim=1), _EPS), mins


def estimate_size_leaderless(
    plan: Plan | Graph,
    rounds: int,
    seed: int,
    *,
    n_sketches: int = 32,
    round_offset: int = 0,
    return_sketches: bool = False,
):
    """Leaderless n̂ by extrema propagation: every node draws ``n_sketches``
    Exp(1) values, each round is one ``spread_min``, and once the minima
    have flooded the graph each coordinate is the min of n Exp(1) draws, so
    ``n̂ = (m − 1) / Σ min`` (relative noise ≈ 1/√(m − 2)).  A node that
    heard nothing averages its own draws to n̂ ≈ 1, gain ≈ 1.  ``seed``
    splits into (sketch seed, round seed)."""
    plan = as_plan(plan)
    if seed is None:
        raise ValueError("estimate_size_leaderless draws sketches: a seed is required")
    sketch_seed, round_seed = split_seed(seed, 2)
    sketches = _draw_sketches(sketch_seed, plan.n, n_sketches, plan.device)
    n_hat, mins = _sketch_n_hat(plan, sketches, rounds, round_seed, round_offset)
    return (n_hat, mins) if return_sketches else n_hat


# ------------------------------------------------- event-driven (barrier-free)
def _scan_events(plan: Plan | Graph, op: str, x0, stream: EventStream, seed: int | None) -> torch.Tensor:
    """``plan.event_<op>`` over the stream's live events in order (padding is
    the identity and is skipped); event i takes row i of
    ``commplan.event_flags(plan, seed, stream)`` as its failure draw.  Over
    a K > 1 ``PlanSchedule`` each event runs under the plan active in its
    unit-time window and draws from that plan's seed (``event_key``); a
    K = 1 schedule is its static plan."""
    plan = as_plan(plan)
    if isinstance(plan, PlanSchedule) and plan.k == 1:
        plan = plan.plans[0]
    if plan.failures.active and seed is None:
        raise ValueError("failure model active: event gossip needs a seed")
    flags = _commplan.event_flags(plan, seed, stream)
    fn = getattr(plan, f"event_{op}")
    x = _payload(plan, x0)
    scheduled = isinstance(plan, PlanSchedule)
    for i in np.nonzero(stream.edges >= 0)[0]:
        keep = None if flags is None else bool(flags[i])
        e = int(stream.edges[i])
        x = fn(x, e, stream.times[i], keep) if scheduled else fn(x, e, keep)
    return x


def spread_events(plan: Plan | Graph, values, stream: EventStream, seed: int | None = None) -> torch.Tensor:
    """An ``EventStream`` of pairwise push exchanges on an (n,) / (n, k)
    payload, the barrier-free ``spread_rounds``: mass is kept event by
    event and no round counter exists."""
    return _scan_events(plan, "spread", values, stream, seed)


def push_sum_events(plan: Plan | Graph, values, stream: EventStream, seed: int | None = None) -> torch.Tensor:
    """Event-driven push-sum: (s, w) ride the same pairwise exchanges and
    s/w is every node's running estimate of the average, with no barrier
    (numpy reference: ``core.gossip.push_sum_events_reference``)."""
    plan = as_plan(plan)
    x = _payload(plan, values)
    squeeze = x.ndim == 1
    x2 = x[:, None] if squeeze else x
    payload = torch.cat([x2, torch.ones_like(x2[:, :1])], dim=1)
    out = _scan_events(plan, "spread", payload, stream, seed)
    ratio = out[:, :-1] / torch.clamp_min(out[:, -1:], _EPS)
    return ratio[:, 0] if squeeze else ratio


def estimate_size_leaderless_events(
    plan: Plan | Graph,
    stream: EventStream,
    seed: int,
    *,
    n_sketches: int = 32,
    return_sketches: bool = False,
):
    """Leaderless n̂ over an event stream: no distinguished node and no
    round barrier.  Each node's Exp(1) sketches flood by pairwise min
    exchanges as the edge clocks fire; the estimator is
    ``estimate_size_leaderless``'s (an unreached node degrades to n̂ ≈ 1).
    ``seed`` splits into (sketch seed, event seed); the sketches are drawn
    as ``estimate_size_leaderless`` draws them."""
    plan = as_plan(plan)
    if seed is None:
        raise ValueError("estimate_size_leaderless_events draws sketches: a seed is required")
    sketch_seed, event_seed = split_seed(seed, 2)
    sketches = _draw_sketches(sketch_seed, plan.n, n_sketches, plan.device)
    mins = _scan_events(plan, "spread_min", sketches, stream, event_seed if plan.failures.active else None)
    n_hat = (n_sketches - 1) / torch.clamp_min(mins.sum(dim=1), _EPS)
    return (n_hat, mins) if return_sketches else n_hat


def estimate_mean_degree(
    plan: Plan | Graph, rounds: int, seed: int | None = None, *, round_offset: int = 0
) -> torch.Tensor:
    plan = as_plan(plan)
    return push_sum(plan, plan.graph.degrees.astype(np.float32), rounds, seed, round_offset=round_offset)


@dataclasses.dataclass(frozen=True)
class GossipEstimates:
    """Per-node estimates, every field (n,) on the plan's device.
    ``reached`` flags nodes the leader's mass visited within the budget;
    the estimates elsewhere are meaningless (see ``make_gain_estimator``)."""

    n_hat: torch.Tensor
    vnorm: torch.Tensor
    mean_degree: torch.Tensor
    reached: torch.Tensor


def _centrality_moments(plan: Plan, pi_rounds: int, ps_rounds: int, seed, leader: int, extra=None):
    """The two phases of the ‖v_steady‖ estimators.  Phase 1: x ← A'x from
    x₀ = 1 (A' column-stochastic: Σx = n stays, x → n·v).  Phase 2, its
    round counter starting at ``pi_rounds``: push-sum of [x², 1_leader,
    *extra].  Returns (x, avg, reached, z), z clamp-guarded."""
    x = _rounds(plan, "spread", torch.ones(plan.n, dtype=torch.float32, device=plan.device), pi_rounds, seed, 0,
                False)
    cols = [x * x, _one_hot(plan, leader)] + ([extra] if extra is not None else [])
    avg = push_sum(plan, torch.stack(cols, dim=1), ps_rounds, seed, round_offset=pi_rounds)
    reached = avg[:, 1] > _UNREACHED
    return x, avg, reached, torch.clamp_min(avg[:, 1], _EPS)


def power_iteration_norm(
    plan: Plan | Graph, pi_rounds: int, ps_rounds: int, seed: int | None = None, *, leader: int = 0
) -> dict[str, torch.Tensor]:
    """Gossip estimate of ``‖v_steady‖₂`` at every node: ``‖v̂‖ = √(m2·z)``,
    ``n̂ = 1/z``; ``reached`` is False where the budget never delivered the
    leader's mass.  Numpy reference:
    ``core.gossip.power_iteration_norm_reference``."""
    plan = as_plan(plan)
    x, avg, reached, z = _centrality_moments(plan, pi_rounds, ps_rounds, seed, leader)
    return {
        "vnorm": torch.sqrt(torch.clamp_min(avg[:, 0] * z, 0.0)),
        "n_hat": 1.0 / z,
        "x": x,
        "reached": reached,
    }


def estimate_all(
    plan: Plan | Graph, *, pi_rounds: int, ps_rounds: int, seed: int | None = None, leader: int = 0
) -> GossipEstimates:
    """The full §4.4 estimate set: the centrality moment, the leader one-hot
    and the local degrees share one push-sum phase and its draws."""
    plan = as_plan(plan)
    deg = torch.as_tensor(plan.graph.degrees, dtype=torch.float32, device=plan.device)
    _, avg, reached, z = _centrality_moments(plan, pi_rounds, ps_rounds, seed, leader, extra=deg)
    return GossipEstimates(
        n_hat=1.0 / z,
        vnorm=torch.sqrt(torch.clamp_min(avg[:, 0] * z, 0.0)),
        mean_degree=avg[:, 2],
        reached=reached,
    )


def gains_from_estimates(n_hat, vnorm=None, family_exponent: float | None = None) -> torch.Tensor:
    """Per-node mirror of ``core.initialisation.gain_from_estimates``: a
    ``vnorm`` estimate wins (gain 1/‖v̂‖); else n̂^α (α = 1/2 when omitted).
    Both at once raises, as the host function does."""
    if vnorm is not None and family_exponent is not None:
        raise ValueError(
            "give either a vnorm estimate or a family_exponent, not both — "
            "see core.initialisation.gain_from_estimates for the priority rule"
        )
    if vnorm is not None:
        return 1.0 / torch.clamp_min(torch.as_tensor(vnorm, dtype=torch.float32), _EPS)
    alpha = 0.5 if family_exponent is None else family_exponent
    return torch.as_tensor(n_hat, dtype=torch.float32) ** alpha


def gain_from_degree_sample(n_hat, degree_sample) -> torch.Tensor:
    """``‖v‖² ≈ ⟨(k+1)²⟩ / (n̂·⟨k+1⟩²)`` per node, gain = 1/‖v̂‖.  ``n_hat``
    (n,); ``degree_sample`` (m,) shared or (n, m) per node.  n̂ is rounded
    (half to even) as the host path does."""
    k1 = torch.as_tensor(degree_sample, dtype=torch.float32) + 1.0
    m2 = (k1**2).mean(dim=-1)
    m1 = k1.mean(dim=-1)
    n_r = torch.round(torch.as_tensor(n_hat, dtype=torch.float32))
    return 1.0 / torch.clamp_min(torch.sqrt(m2 / (n_r * m1**2)), _EPS)


def make_gain_estimator(
    plan: Plan | Graph,
    *,
    pi_rounds: int,
    ps_rounds: int,
    mode: str = "vnorm",
    family_exponent: float | None = None,
    leader: int = 0,
    walk_length: int = 16,
    n_walks: int = 64,
    leaderless: bool = False,
    n_sketches: int = 32,
) -> Callable[..., torch.Tensor]:
    """Build ``estimate_gains(seed, budget=None) → (n,) gains`` on the plan's device.

    Modes (the three §4.4 knowledge regimes): ``vnorm`` (power-iteration
    ‖v̂‖ per node, gain 1/‖v̂‖), ``alpha`` (push-sum n̂, gain n̂^α) and
    ``degree`` (push-sum n̂ and per-node random-walk degree polls, the
    closed-form ‖v̂‖).  ``leaderless`` replaces every leader one-hot by the
    sketches of ``estimate_size_leaderless``, riding the push-sum phase's
    round draws; ``vnorm`` then normalises the moment by the sketch n̂.

    ``budget`` (≤ ``pi_rounds`` and ``ps_rounds``) runs that many rounds a
    phase instead: the JAX package's masked sweep budget.  The seed splits
    into (gossip, walk, sketch) seeds (``split_seed``).

    A node the leader's mass never reached within the budget has no size
    estimate; it falls back to gain 1.0, the honest no-knowledge default
    (``torch.where`` on the device).  After each call
    ``estimate_gains.reached`` holds that call's (n,) mask (None for the
    leaderless estimators, which need none).
    """
    if mode not in ("vnorm", "alpha", "degree"):
        raise ValueError(f"unknown gain estimator mode {mode!r}")
    if mode == "vnorm" and family_exponent is not None:
        raise ValueError("family_exponent only applies to mode='alpha'")
    plan = as_plan(plan)

    def estimate_gains(seed: int, budget: int | None = None) -> torch.Tensor:
        pi, ps = pi_rounds, ps_rounds
        if budget is not None:
            if not 0 <= budget <= min(pi_rounds, ps_rounds):
                raise ValueError(f"budget {budget} outside 0..{min(pi_rounds, ps_rounds)}")
            pi = ps = int(budget)
        gossip_seed, walk_seed, sketch_seed = split_seed(seed, 3)

        def sketch_size(rounds, round_offset=0):
            sketches = _draw_sketches(sketch_seed, plan.n, n_sketches, plan.device)
            return _sketch_n_hat(plan, sketches, rounds, gossip_seed, round_offset)[0]

        reached = None
        if mode == "vnorm" and leaderless:
            x = _rounds(plan, "spread", torch.ones(plan.n, dtype=torch.float32, device=plan.device), pi,
                        gossip_seed, 0, False)
            m2 = push_sum(plan, (x * x)[:, None], ps, gossip_seed, round_offset=pi)[:, 0]
            n_hat = sketch_size(ps, round_offset=pi)
            vnorm = torch.sqrt(torch.clamp_min(m2 / torch.clamp_min(n_hat, 1.0), 0.0))
            gains = gains_from_estimates(n_hat, vnorm=vnorm)
        elif mode == "vnorm":
            est = power_iteration_norm(plan, pi, ps, gossip_seed, leader=leader)
            gains = gains_from_estimates(est["n_hat"], vnorm=est["vnorm"])
            reached = est["reached"]
        else:
            if leaderless:
                n_hat = sketch_size(ps)
            else:
                n_hat = estimate_size(plan, ps, gossip_seed, leader=leader)
                reached = n_hat < 1.0 / _UNREACHED
            if mode == "alpha":
                gains = gains_from_estimates(n_hat, family_exponent=family_exponent)
            else:
                sample = poll_degrees_device(
                    plan.graph, np.arange(plan.n), walk_length=walk_length, n_walks=n_walks, seed=walk_seed,
                    plan=plan,  # the walks ride the training round's failure draws
                )
                gains = gain_from_degree_sample(n_hat, sample)
        estimate_gains.reached = reached
        return gains if reached is None else torch.where(reached, gains, torch.ones_like(gains))

    estimate_gains.reached = None
    return estimate_gains
