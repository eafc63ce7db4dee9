"""Round executor over a device-resident dataset (counterpart of ``repro/fed/executor.py``).

``run_trajectory`` runs a whole DFL trajectory with the per-node datasets
and the batch schedule uploaded once: each round's minibatches are gathered
on the device from ``data.pipeline.batch_index_schedule`` (the same order
the host iterator yields), metrics are kept as device scalars at the eval
rounds and read back once at the end.  ``run_sweep`` runs several
trajectories (seeds × gains ...) over one upload.  The history dict has the
JAX executor's keys: ``round``, ``train_loss``, ``test_loss``,
``sigma_ap``, ``sigma_an`` and, for a ``round_fn`` that mixes over an
undirected ``CommPlan`` (``round_fn.plan``), the wire channels
``wire_messages`` (two a live edge) and ``wire_bytes`` (messages × one
node's row, priced at the codec's encoding when compressed).  A compressed
``round_fn`` (``make_round_fn(compression=...)``) gets zero mirrors seeded
into the state before the first round.

``run_warmup_trajectory`` is the uncoordinated init of §4.4: the gossip
estimate of every node's gain (``repro_torch.gossip.make_gain_estimator``),
``init_fl_state`` with those gains and the trajectory, the gains staying on
the device between the phases; ``run_warmup_sweep`` runs a (budget × seed)
grid of them one after another over one upload.

A ``round_fn`` over a ``PlanSchedule`` mixes with each round's active plan,
and its wire channels count that plan's edges.  The rounds run in chunks
of ``chunk_size`` (``TrajectoryConfig.chunks``); ``run_trajectory``'s
``on_chunk(r0, r1, chunk_hist)`` hook gets each chunk's history (absolute
round numbers, the wire channels included) after the device has finished
the chunk, the one synchronisation it adds.  A chunked run computes exactly
what an unchunked one does.

``run_event_trajectory`` is the event-driven (asynchronous) executor: no
round barrier, one pairwise exchange each time an edge's Poisson clock
fires (``topology.EventStream``).  The host walks the numpy stream and
runs each live event eagerly through ``_make_event_step``: the pair's local
steps, its exchange (one launch of the quantised pair round when int8 /
fp8 compressed), its optimizer re-init, its virtual clocks.  Everything the
stream and the host-drawn failure flags decide (counts, clocks,
staleness, delivered messages, bins, eval points) is kept on the host in
the JAX executor's fp32 arithmetic; the losses stay on the device, read
once a chunk.  Checkpointing and the sharded / elastic executors are not
ported yet (ROADMAP.md Queue 1 items 12, 17).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core import commplan as _commplan
from repro_torch.core.commplan import CommPlan, PlanSchedule, compile_plan
from repro_torch.core.compress import Compression, _edges, compressed_mix_with, seed_residual
from repro_torch.core.topology import EventStream, Graph
from repro_torch.device import resolve_device
from repro_torch.kernels.mix import pair_mix_ref, quant_mix_pair

from repro_torch.gossip.engine import split_seed

from .trainer import (
    HISTORY_KEYS,
    DFLState,
    _copy_generator,
    _local_steps,
    copy_state,
    finish_history,
    init_fl_state,
    record_round,
    state_device,
)

__all__ = [
    "TrajectoryConfig",
    "run_event_trajectory",
    "run_sweep",
    "run_trajectory",
    "run_warmup_sweep",
    "run_warmup_trajectory",
    "stack_states",
    "staleness_histogram",
    "unstack_states",
]

# staleness-histogram buckets of the event executor (linear over [0, horizon])
_STALE_BUCKETS = 16


@dataclasses.dataclass(frozen=True)
class TrajectoryConfig:
    """``eval_every`` as ``train_loop``: metrics at rounds
    ``r % eval_every == 0`` plus the final round; 0 disables recording.
    ``chunk_size`` is the rounds a chunk (0: the JAX executor's automatic
    size, all of them up to 1024 rounds, else 256)."""

    n_rounds: int
    eval_every: int = 0
    chunk_size: int = 0

    def eval_mask(self) -> np.ndarray:
        mask = np.zeros(self.n_rounds, dtype=bool)
        if self.eval_every:
            mask[:: self.eval_every] = True
            mask[-1] = True
        return mask

    def chunks(self) -> list[tuple[int, int]]:
        size = self.chunk_size
        if size <= 0:
            size = self.n_rounds if self.n_rounds <= 1024 else 256
        return [(r0, min(r0 + size, self.n_rounds)) for r0 in range(0, self.n_rounds, size)]


def stack_states(states: Sequence[DFLState]) -> DFLState:
    """Stack independent runs' states along a leading run axis."""
    s0 = states[0]
    return DFLState(
        params=torch.stack([s.params for s in states]),
        opt_state=type(s0.opt_state)(*(torch.stack(f) for f in zip(*(s.opt_state for s in states)))),
        layout=s0.layout,
        round=s0.round,
        generator=tuple(s.generator for s in states),
        residual=None if s0.residual is None else torch.stack([s.residual for s in states]),
    )


def unstack_states(states: DFLState) -> list[DFLState]:
    """Split a stacked state back into its runs."""
    return [
        DFLState(
            params=states.params[i],
            opt_state=type(states.opt_state)(*(f[i] for f in states.opt_state)),
            layout=states.layout,
            round=states.round,
            generator=g,
            residual=None if states.residual is None else states.residual[i],
        )
        for i, g in enumerate(states.generator)
    ]


def _as_round_schedule(
    schedule: np.ndarray, n_rounds: int, b_local: int | None = None
) -> np.ndarray:
    """(n_rounds·b, n, bs) or (n_rounds, n, b, bs) → (n_rounds, n, b, bs)."""
    s = np.asarray(schedule)
    if s.ndim == 4:
        if s.shape[0] != n_rounds:
            raise ValueError(f"schedule rounds {s.shape[0]} != n_rounds {n_rounds}")
        if b_local is not None and s.shape[2] != b_local:
            raise ValueError(f"schedule b_local {s.shape[2]} != b_local {b_local}")
        return s
    if s.ndim != 3 or s.shape[0] % n_rounds:
        raise ValueError(f"schedule shape {s.shape} incompatible with n_rounds={n_rounds}")
    b = s.shape[0] // n_rounds
    if b_local is not None and b != b_local:
        raise ValueError(
            f"schedule holds {s.shape[0]} batches = {b}/round over {n_rounds} "
            f"rounds, but b_local={b_local} was requested"
        )
    return s.reshape(n_rounds, b, s.shape[1], s.shape[2]).transpose(0, 2, 1, 3)


def run_trajectory(
    state: DFLState,
    round_fn: Callable[[DFLState, Any], tuple[DFLState, dict]],
    xs: np.ndarray | torch.Tensor,
    ys: np.ndarray | torch.Tensor,
    schedule: np.ndarray,
    *,
    n_rounds: int,
    eval_every: int = 0,
    eval_fn=None,
    eval_batch=None,
    track_sigmas: bool = False,
    chunk_size: int = 0,
    b_local: int | None = None,
    on_chunk: Callable[[int, int, dict], None] | None = None,
    device: str | torch.device | None = None,
) -> tuple[DFLState, dict[str, list]]:
    """Run ``n_rounds`` rounds of ``round_fn`` on the state's device (which
    must be ``device``, default cuda).  ``schedule`` is
    ``batch_index_schedule(...)`` output covering ``n_rounds × b_local``
    minibatches, or already round-shaped (n_rounds, n, b, bs).  The caller's
    state is left untouched.  ``on_chunk(r0, r1, chunk_hist)`` is called
    after each chunk of ``chunk_size`` rounds, once the device has finished
    it: ``chunk_hist`` holds that chunk's recorded rounds, as the history
    does."""
    return _run(state, round_fn, xs, ys, schedule, n_rounds=n_rounds, eval_every=eval_every, eval_fn=eval_fn,
                eval_batch=eval_batch, track_sigmas=track_sigmas, b_local=b_local, device=device, wire=True,
                chunk_size=chunk_size, on_chunk=on_chunk)


def _run(state, round_fn, xs, ys, schedule, *, n_rounds, eval_every, eval_fn, eval_batch, track_sigmas, b_local,
         device, wire: bool, chunk_size: int = 0, on_chunk=None):
    """``run_trajectory``; ``wire`` adds the wire channels (the JAX
    package's sweep records none)."""
    dev = state_device(state, device)
    sched = torch.as_tensor(_as_round_schedule(schedule, n_rounds, b_local), device=dev)
    xs_d, ys_d = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
    eval_d = None if eval_batch is None else tuple(torch.as_tensor(a, device=dev) for a in eval_batch)
    n_nodes = xs_d.shape[0]
    node_idx = torch.arange(n_nodes, device=dev)[:, None]

    def gather_batch(idx: torch.Tensor):
        # idx (n, b, bs) → ((n, b, bs, *feat), (n, b, bs))
        flat = idx.reshape(n_nodes, -1).long()
        bx = xs_d[node_idx, flat].reshape(*idx.shape, *xs_d.shape[2:])
        by = ys_d[node_idx, flat].reshape(*idx.shape, *ys_d.shape[2:])
        return bx, by

    comp = getattr(round_fn, "compression", None)
    state = seed_residual(copy_state(state), comp)
    plan = getattr(round_fn, "plan", None)
    wire = wire and plan is not None and not plan.graph.directed
    row_bytes = _row_bytes(state, comp) if wire else 0
    cfg = TrajectoryConfig(n_rounds, eval_every, chunk_size)
    mask = cfg.eval_mask()
    hist: dict[str, list] = {k: [] for k in HISTORY_KEYS}
    messages = []
    for r0, r1 in cfg.chunks():
        at = len(hist["round"])
        for r in range(r0, r1):
            # the failure draws this round's mix makes, replayed by the wire count
            before = _copy_generator(state.generator) if wire and mask[r] and plan.failures.active else None
            rnd = state.round  # the round the mix picks its plan by (a resumed state starts past 0)
            state, metrics = round_fn(state, gather_batch(sched[r]))
            if mask[r]:
                record_round(hist, r, state, metrics, eval_fn, eval_d, track_sigmas)
                if wire:
                    messages.append(plan.wire_messages(rnd, before) if isinstance(plan, PlanSchedule)
                                    else plan.wire_messages(before))
        if on_chunk is not None:
            # the hook's clock reads the chunk's end: the one synchronisation it adds
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            chunk = _with_wire(finish_history({k: v[at:] for k, v in hist.items()}), messages[at:], wire, row_bytes)
            on_chunk(r0, r1, chunk)
    return state, _with_wire(finish_history(hist), messages, wire, row_bytes)


def _with_wire(out: dict, messages: list, wire: bool, row_bytes: int) -> dict:
    if wire:
        out["wire_messages"] = [int(m) for m in messages]
        out["wire_bytes"] = [m * row_bytes for m in out["wire_messages"]]
    return out


def _row_bytes(state: DFLState, comp) -> int:
    """One node's row on the wire: each leaf at its itemsize, or at the
    codec's encoding (``Compression.leaf_row_bytes``); the total rounded."""
    dtype = state.params.dtype
    if comp is None:
        return int(round(sum(size * state.params.element_size() for size in state.layout.sizes)))
    return int(round(sum(float(comp.leaf_row_bytes(size, dtype)) for size in state.layout.sizes)))


def run_sweep(
    states: DFLState | Sequence[DFLState],
    round_fn: Callable[[DFLState, Any], tuple[DFLState, dict]],
    xs: np.ndarray,
    ys: np.ndarray,
    schedule: np.ndarray,
    *,
    n_rounds: int,
    eval_every: int = 0,
    eval_fn=None,
    eval_batch=None,
    track_sigmas: bool = False,
    b_local: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[DFLState, list[dict[str, list]]]:
    """Several trajectories (seeds × gains ...) sharing one dataset, one
    schedule and one upload, run one after another.  ``states`` is a list
    of per-run states or a stacked one.  Returns the stacked final state
    and one history per run, without wire channels (as the JAX package's)."""
    runs = unstack_states(states) if isinstance(states, DFLState) else list(states)
    dev = state_device(runs[0], device)
    xs_d, ys_d = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
    finals, hists = [], []
    for s in runs:
        final, hist = _run(
            s, round_fn, xs_d, ys_d, schedule, n_rounds=n_rounds, eval_every=eval_every,
            eval_fn=eval_fn, eval_batch=eval_batch, track_sigmas=track_sigmas,
            b_local=b_local, device=dev, wire=False,
        )
        finals.append(final)
        hists.append(hist)
    return stack_states(finals), hists


def run_warmup_trajectory(
    seed: int,
    round_fn: Callable[[DFLState, Any], tuple[DFLState, dict]],
    xs: np.ndarray,
    ys: np.ndarray,
    schedule: np.ndarray,
    *,
    n_nodes: int,
    init_one: Callable,
    optimizer,
    estimate_gains: Callable[..., torch.Tensor],
    n_rounds: int,
    eval_every: int = 0,
    eval_fn=None,
    eval_batch=None,
    track_sigmas: bool = False,
    b_local: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[DFLState, dict[str, list], np.ndarray]:
    """**Estimate → per-node gain → init → train** (§4.4).

    ``seed`` splits into (estimation seed, init seed) (``split_seed``):
    ``estimate_gains(estimation seed)`` (a ``make_gain_estimator``) runs the
    gossip rounds and returns the (n,) gains on the device, which
    ``init_fl_state(init seed, ..., gains=)`` draws every node's parameters
    with, and the trajectory runs as ``run_trajectory``'s, without wire
    channels (as the JAX package's warmup).  Running those three by hand with the same split gives the same result.  Returns ``(final_state,
    history, gains)``, the realised gains as numpy.
    """
    est_seed, init_seed = split_seed(seed, 2)
    gains = estimate_gains(est_seed)
    state = init_fl_state(init_seed, n_nodes, init_one, optimizer, gains=gains, device=device)
    state, hist = _run(state, round_fn, xs, ys, schedule, n_rounds=n_rounds, eval_every=eval_every, eval_fn=eval_fn,
                       eval_batch=eval_batch, track_sigmas=track_sigmas, b_local=b_local, device=device, wire=False)
    return state, hist, gains.cpu().numpy()


def run_warmup_sweep(
    seeds: Sequence[int],
    round_fn: Callable[[DFLState, Any], tuple[DFLState, dict]],
    xs: np.ndarray,
    ys: np.ndarray,
    schedule: np.ndarray,
    *,
    n_nodes: int,
    init_one: Callable,
    optimizer,
    estimate_gains: Callable[..., torch.Tensor],
    budgets: Sequence[int] | np.ndarray | None = None,
    n_rounds: int,
    eval_every: int = 0,
    eval_fn=None,
    eval_batch=None,
    track_sigmas: bool = False,
    b_local: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[DFLState, list[dict[str, list]], np.ndarray]:
    """A (budget × seed) grid of warmup trajectories over one upload, run
    one after another: run i is ``run_warmup_trajectory(seeds[i])`` with
    ``estimate_gains(estimation seed, budgets[i])`` (without ``budgets``:
    ``estimate_gains(estimation seed)``), so a budget-b cell equals a
    standalone budget-b run.  Returns ``(stacked_states, histories,
    gains)``, the gains an (n_runs, n_nodes) numpy array."""
    if budgets is not None and len(budgets) != len(seeds):
        raise ValueError(f"budgets has {len(budgets)} entries for {len(seeds)} seeds")
    dev = resolve_device(device)
    xs_d, ys_d = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
    finals, hists, gains = [], [], []
    for i, seed in enumerate(seeds):
        estimate = estimate_gains if budgets is None else (lambda s, b=int(budgets[i]): estimate_gains(s, b))
        final, hist, g = run_warmup_trajectory(
            int(seed), round_fn, xs_d, ys_d, schedule, n_nodes=n_nodes, init_one=init_one, optimizer=optimizer,
            estimate_gains=estimate, n_rounds=n_rounds, eval_every=eval_every, eval_fn=eval_fn,
            eval_batch=eval_batch, track_sigmas=track_sigmas, b_local=b_local, device=dev,
        )
        finals.append(final)
        hists.append(hist)
        gains.append(g)
    return stack_states(finals), hists, np.stack(gains)


# ------------------------------------------------------- event-driven executor
def staleness_histogram(counts, horizon: float) -> dict:
    """The event executor's staleness buckets as ``{counts, edges}`` lists:
    linear buckets over [0, horizon], the last one catching everything
    beyond; ``edges`` the bucket boundaries in units of virtual time."""
    c = np.asarray(counts, dtype=np.float64)
    edges = np.linspace(0.0, float(horizon), len(c) + 1)
    return {"counts": [float(v) for v in c], "edges": [float(e) for e in edges]}


def _make_event_step(
    loss_fn,
    optimizer,
    plan: CommPlan,
    sched_d: torch.Tensor,
    n_sched_rounds: int,
    xs_d: torch.Tensor,
    ys_d: torch.Tensor,
    *,
    layout,
    reinit_opt: bool,
    comp: Compression | None,
):
    """One gossip event as a reusable step (local phase → pairwise exchange
    → optimizer re-init → clocks), shared through ``_EventRun`` by
    ``run_event_trajectory`` and the serving executor, so that interleaved
    queries cannot change the training math.

    Returns ``step(params, opt_state, mirror, counts, clocks, e, t,
    delivered) -> (loss, staleness)`` for a live event on edge ``e`` at time
    ``t``: it updates the endpoints' rows of the flat ``params``, of every
    ``opt_state`` field and of the compression mirror (None uncompressed) in
    place, and the host arrays ``counts`` (each node's events so far, its
    cursor into the schedule) and ``clocks`` (its last event's time).  The
    endpoints always train; ``delivered`` False (the failure draw killed the
    exchange) skips the exchange and leaves their rows and mirrors as the
    local phase left them.  ``loss`` is the pair's mean loss, a device
    scalar; ``staleness`` the mean of ``t − clock`` at the two endpoints
    before the clocks move, a host float32.
    """
    uv_host = plan._event_uv_host
    quantised = comp is not None and comp.codec in ("int8", "fp8")
    table = _edges(layout.sizes, comp.chunk) if comp is not None else None

    def step(params, opt_state, mirror, counts, clocks, e, t, delivered):
        u, v = int(uv_host[e, 0]), int(uv_host[e, 1])
        # 1. local phase: each endpoint takes b_local steps from its own cursor
        iu, iv = sched_d[counts[u] % n_sched_rounds, u], sched_d[counts[v] % n_sched_rounds, v]
        batch = (torch.stack([xs_d[u][iu], xs_d[v][iv]]), torch.stack([ys_d[u][iu], ys_d[v][iv]]))
        pair = torch.stack([params[u], params[v]])
        pair_o = type(opt_state)(*(torch.stack([f[u], f[v]]) for f in opt_state))
        pair, pair_o, losses = _local_steps(loss_fn, optimizer, layout, pair, pair_o, batch)
        with torch.no_grad():
            # 2. the pairwise exchange
            if delivered:
                if comp is None:
                    pair = pair_mix_ref(pair, plan.event_w[e])
                else:
                    h_pair = torch.stack([mirror[u], mirror[v]])
                    if quantised:
                        (pair, h_pair), _ = quant_mix_pair(
                            plan.event_m2[e], pair, h_pair if comp.error_feedback else None, table,
                            codec=comp.codec, gamma=comp.gamma, error_feedback=comp.error_feedback,
                        )
                    else:
                        w = plan.event_w[e]
                        pair, h_pair = compressed_mix_with(lambda q: pair_mix_ref(q, w), pair, h_pair, comp,
                                                           layout=layout)
                    mirror[u].copy_(h_pair[0])
                    mirror[v].copy_(h_pair[1])
            # 3. the pair's optimizer re-init (Algorithm 1 line 15)
            if reinit_opt:
                pair_o = optimizer.init(pair)
            params[u].copy_(pair[0])
            params[v].copy_(pair[1])
            for f, nf in zip(opt_state, pair_o):
                f[u].copy_(nf[0])
                f[v].copy_(nf[1])
        # 4. virtual clocks: staleness before they move
        stale = ((t - clocks[u]) + (t - clocks[v])) / np.float32(2.0)
        clocks[u] = clocks[v] = t
        counts[u] += 1
        counts[v] += 1
        return losses.mean(), np.float32(stale)

    return step


def run_event_trajectory(
    state: DFLState,
    loss_fn,
    optimizer,
    plan: CommPlan | Graph,
    stream: EventStream,
    xs: np.ndarray | torch.Tensor,
    ys: np.ndarray | torch.Tensor,
    schedule: np.ndarray,
    *,
    b_local: int,
    n_bins: int = 20,
    eval_fn=None,
    eval_batch=None,
    reinit_opt: bool = True,
    chunk_events: int = 0,
    checkpoint=None,
    resume_from: str | None = None,
    on_chunk: Callable | None = None,
    compression: Compression | None = None,
    device: str | torch.device | None = None,
) -> tuple[DFLState, dict[str, list], dict]:
    """Event-driven (asynchronous) DFL trajectory: no global round barrier.

    For every live event of ``stream`` (its per-edge Poisson clocks replace
    the synchronous barrier), in time order:

      1. a **local phase**: each endpoint takes ``b_local`` minibatch steps
         from its own cursor into ``schedule`` (its events so far, modulo
         the schedule's rounds), through ``trainer._local_steps`` on the
         gathered (2, d) rows;
      2. the **pairwise DecAvg exchange** with the plan's weights
         ``M[u, v]`` / ``M[v, u]``; a failed draw moves no model and
         spends no messages, but the endpoints did train;
      3. the pair's optimizer states re-initialise (``reinit_opt``);
      4. the endpoints' **virtual clocks** move to the event's time; the
         event's staleness is ``t − clock`` averaged over the pair, taken
         before.

    Padding events (edge −1) are skipped: the identity.  Failure draws: a
    seed is drawn from ``state.generator`` (which advances, as the JAX
    state's key does) and event i's flag is row i of
    ``commplan.event_flags(plan, seed, stream)``, so chunking or a longer
    envelope cannot change it.

    Metrics go into ``n_bins`` equal bins of virtual time over
    ``stream.horizon``: per-bin mean train loss and staleness, event and
    delivered-message counts, and the mean test loss (``eval_fn``) after
    each bin's last live event.  Returns ``(final_state, history, aux)``:
    the history keys ``bin``, ``time``, ``train_loss``, ``test_loss``,
    ``staleness``, ``events``, ``messages``, ``wire_bytes``; ``aux`` the
    per-node ``node_clock`` and ``node_events`` and the 16-bucket
    ``staleness_hist``.  The state's ``round`` advances by the live events.

    ``chunk_events`` cuts the stream into chunks (0: one); ``on_chunk(ci,
    i0, i1, acc)`` is called after chunk ci (events i0 … i1 − 1) once the
    device has finished it, with the per-bin accumulators so far as numpy
    (``loss_sum``, ``cnt``, ``stale_sum``, ``msg_cnt``, ``test_bin``,
    ``stale_hist``): the one synchronisation a chunk adds.  A chunked run
    computes exactly what an unchunked one does.

    ``compression`` compresses the pairwise exchange: the endpoints
    transmit ``C(x − h)``, update their mirrors and blend the mirrors; an
    int8 / fp8 exchange is one launch of the quantised pair round
    (``kernels.mix.quant_mix_pair``), topk / qtopk the plain codec on the
    two rows.  Rows of other nodes, and an exchange the draw killed, keep
    their mirrors.  ``checkpoint`` / ``resume_from`` are not ported yet.
    """
    if checkpoint is not None or resume_from is not None:
        raise NotImplementedError(
            "checkpointing the event executor is not ported yet; see ROADMAP.md Queue 1 item 12"
        )
    comp = compression if (compression is not None and compression.active) else None
    run = _EventRun(state, loss_fn, optimizer, plan, stream, xs, ys, schedule, b_local=b_local, n_bins=n_bins,
                    eval_fn=eval_fn, eval_batch=eval_batch, reinit_opt=reinit_opt, comp=comp, device=device,
                    name="run_event_trajectory")
    env = stream.envelope
    size = env if chunk_events <= 0 else int(chunk_events)
    for ci, i0 in enumerate(range(0, env, size)):
        i1 = min(i0 + size, env)
        for i in np.nonzero(run.live[i0:i1])[0] + i0:
            run.gossip(int(i))
        if on_chunk is not None:
            # one synchronisation a chunk: the hook reads the chunk's end
            on_chunk(ci, i0, i1, run.acc())
    return run.final(), run.history(), run.aux()


class _EventRun:
    """One event-driven run's carry and bookkeeping, shared by
    ``run_event_trajectory`` and the serving executor
    (``fed.serve.run_serve_trajectory``), so that interleaved queries cannot
    change the training math: the copied state, the one seed drawn from its
    generator, the stream's failure flags, the event step, the host counts
    and clocks, and the per-bin accumulators (the losses on the device, the
    rest host float32, the JAX executor's arithmetic)."""

    def __init__(self, state, loss_fn, optimizer, plan, stream, xs, ys, schedule, *, b_local, n_bins, eval_fn,
                 eval_batch, reinit_opt, comp, device, name):
        dev = state_device(state, device)
        plan = compile_plan(plan, device=dev) if isinstance(plan, Graph) else plan
        if not isinstance(plan, CommPlan) or plan.event_uv is None:
            raise ValueError(f"{name} needs an undirected, statically compiled plan")
        n_nodes = xs.shape[0]
        if plan.n != n_nodes:
            raise ValueError(f"plan has {plan.n} nodes but xs carries {n_nodes}")
        s = np.asarray(schedule)
        n_sched_rounds = (s.shape[0] // b_local) if s.ndim == 3 else s.shape[0]
        sched_d = torch.as_tensor(_as_round_schedule(s, n_sched_rounds, b_local), dtype=torch.int64, device=dev)
        xs_d, ys_d = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
        self.eval_fn = eval_fn
        self.eval_d = None if eval_batch is None else tuple(torch.as_tensor(a, device=dev) for a in eval_batch)
        self.dev, self.plan, self.stream, self.comp, self.n_bins = dev, plan, stream, comp, n_bins

        # the stream's metric structure, known on the host
        self.live = stream.edges >= 0
        self.bins = np.clip((stream.times / stream.horizon * n_bins).astype(np.int64), 0, n_bins - 1)
        self.do_eval = np.zeros(stream.envelope, dtype=bool)
        if eval_fn is not None:
            for b in range(n_bins):
                hits = np.nonzero(self.live & (self.bins == b))[0]
                if len(hits):
                    self.do_eval[hits[-1]] = True

        self.state = seed_residual(copy_state(state), comp)
        gen = self.state.generator
        if gen is None and plan.failures.active:
            raise ValueError("failure model active: the state needs a generator")
        # the run's one draw from the state's generator
        self.seed = None if gen is None else int(torch.randint(0, 2**62, (1,), generator=gen))
        flags = _commplan.event_flags(plan, self.seed, stream)
        self.delivered = self.live if flags is None else self.live & np.asarray(flags, dtype=bool)
        self.step = _make_event_step(loss_fn, optimizer, plan, sched_d, n_sched_rounds, xs_d, ys_d,
                                     layout=self.state.layout, reinit_opt=reinit_opt, comp=comp)

        self.counts = np.zeros(n_nodes, dtype=np.int32)
        self.clocks = np.zeros(n_nodes, dtype=np.float32)
        self.loss_sum = torch.zeros(n_bins, dtype=torch.float32, device=dev)
        self.test_bin = torch.full((n_bins,), float("nan"), dtype=torch.float32, device=dev)
        self.cnt, self.stale_sum, self.msg_cnt = (np.zeros(n_bins, dtype=np.float32) for _ in range(3))
        self.stale_hist = np.zeros(_STALE_BUCKETS, dtype=np.float32)
        self.horizon = np.float32(stream.horizon)

    def gossip(self, i: int) -> None:
        """Live event i of the stream: the step, then its bins."""
        st = self.state
        b = int(self.bins[i])
        delivered = bool(self.delivered[i])
        loss, stale = self.step(st.params, st.opt_state, st.residual, self.counts, self.clocks,
                                int(self.stream.edges[i]), np.float32(self.stream.times[i]), delivered)
        self.loss_sum[b : b + 1].add_(loss)
        self.cnt[b] += np.float32(1.0)
        self.stale_sum[b] += stale
        self.msg_cnt[b] += np.float32(2.0 * delivered)
        bucket = int(stale / self.horizon * np.float32(_STALE_BUCKETS))
        self.stale_hist[min(max(bucket, 0), _STALE_BUCKETS - 1)] += np.float32(1.0)
        if self.do_eval[i]:
            self.test_bin[b : b + 1].copy_(self.eval_fn(st.layout.views(st.params), self.eval_d).mean())

    def acc(self) -> dict:
        """The per-bin accumulators so far, as numpy (reading them waits for the card)."""
        return dict(loss_sum=self.loss_sum.cpu().numpy(), cnt=self.cnt.copy(), stale_sum=self.stale_sum.copy(),
                    msg_cnt=self.msg_cnt.copy(), test_bin=self.test_bin.cpu().numpy(),
                    stale_hist=self.stale_hist.copy())

    def history(self) -> dict[str, list]:
        safe = np.maximum(self.cnt, np.float32(1.0))
        width = self.stream.horizon / self.n_bins
        row_bytes = _row_bytes(self.state, self.comp)
        messages = [int(v) for v in self.msg_cnt]
        return {
            "bin": list(range(self.n_bins)),
            "time": [float((b + 1) * width) for b in range(self.n_bins)],
            "train_loss": [float(v) for v in self.loss_sum.cpu().numpy() / safe],
            "test_loss": [float(v) for v in self.test_bin.cpu().numpy()],
            "staleness": [float(v) for v in self.stale_sum / safe],
            "events": [int(v) for v in self.cnt],
            # delivered messages only: an exchange the draw killed moved no model
            "messages": messages,
            "wire_bytes": [m * row_bytes for m in messages],
        }

    def final(self) -> DFLState:
        """The state after the run; its ``round`` advanced by the live events."""
        return dataclasses.replace(self.state, round=self.state.round + self.stream.n_events)

    def aux(self) -> dict:
        return {"node_clock": self.clocks, "node_events": self.counts,
                "staleness_hist": staleness_histogram(self.stale_hist, self.stream.horizon)}
