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
once a chunk.

``run_sharded_trajectory`` is the node-sharded executor over a
``ShardedCommPlan`` (DESIGN.md §15): SPMD, one rank a shard, each rank
moving only its rows to its device, mixing through the plan's collectives.
"""
from __future__ import annotations

import dataclasses
import os
import signal
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.io import restore_train_state, save_train_state
from repro_torch.core import commplan as _commplan
from repro_torch.core.commplan import CommPlan, PlanSchedule, compile_plan
from repro_torch.core.compress import (
    Compression, _edges, compressed_mix, compressed_mix_with, init_residuals, seed_residual,
)
from repro_torch.core.shardplan import ShardedCommPlan, all_gather_rows
from repro_torch.core.topology import EventStream, Graph
from repro_torch.device import resolve_device
from repro_torch.kernels.mix import pair_mix_ref, quant_mix_pair
from repro_torch.obs import (
    BinChannel, BinSpec, Channel, MetricsSpec, Recorder, make_wire_fn, param_row_bytes, sharded_wire_per_round,
)
from repro_torch.obs.export import scope
from repro_torch.obs.health import staleness_histogram
from repro_torch.obs.spec import host_values

from repro_torch.gossip.engine import round_generator, split_seed

from .trainer import (
    DFLState,
    _copy_generator,
    _local_steps,
    copy_state,
    eval_metrics,
    init_fl_state,
    make_round_fn,
    state_device,
)

__all__ = [
    "CheckpointPolicy",
    "TrajectoryConfig",
    "elastic_draws",
    "run_elastic_trajectory",
    "run_event_trajectory",
    "run_sharded_trajectory",
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


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Chunk-boundary checkpointing of a trajectory.

    After every ``every``-th chunk (and after the last) the executor saves
    its whole carry (params, optimizer state, the failure generator's
    state, the executor's own accumulators) and the history so far into
    ``dir`` through ``checkpoint.save_train_state`` (one
    ``step_{chunk:08d}.ckpt`` a saving chunk, LATEST repointed, the newest
    ``keep_last`` kept).  A later call with ``resume_from=dir`` and the same
    initial state and arguments skips the saved chunks and runs the rest:
    its result is bit-identical to the uninterrupted run's.

    ``kill_after`` is the fault-injection hook (``core.faults.preemption``):
    the chunk after whose checkpoint the process sends itself ``SIGKILL``,
    which no handler can catch.  -1 disables it.
    """

    dir: str
    every: int = 1
    keep_last: int = 3
    kill_after: int = -1


def _save_chunk_ckpt(policy: CheckpointPolicy, chunk_idx: int, is_last: bool, payload: Callable[[], dict],
                     meta: dict) -> None:
    """Save ``payload()`` if chunk ``chunk_idx`` is a saving chunk (every
    ``every``-th, the last, or ``kill_after``), then die if it is
    ``kill_after``.  ``payload`` is called only on a saving chunk: reading
    the carry back from the device is the checkpoint's cost."""
    due = policy.every <= 1 or (chunk_idx + 1) % policy.every == 0
    if due or is_last or policy.kill_after == chunk_idx:
        save_train_state(policy.dir, chunk_idx, payload(), meta={**meta, "chunk": chunk_idx},
                         keep_last=policy.keep_last)
    if policy.kill_after == chunk_idx:
        os.kill(os.getpid(), signal.SIGKILL)


def _load_resume(resume_from: str, meta_id: dict):
    """``(payload, start_chunk)`` from a checkpoint directory, or None to
    start fresh (no LATEST there).  Every identity field recorded at save
    time must match the caller's: resuming under other knobs would not be a
    replay."""
    restored = restore_train_state(resume_from)
    if restored is None:
        return None
    payload, meta = restored
    for k, v in meta_id.items():
        if meta.get(k) != v:
            raise ValueError(
                f"checkpoint at {resume_from!r} was written with {k}={meta.get(k)!r}, "
                f"but this run has {k}={v!r} — resume must replay the same trajectory"
            )
    return payload, int(meta["chunk"]) + 1


def _state_carry(state: DFLState, **extra) -> dict:
    """The state's part of a checkpoint's carry: params, every optimizer
    field, the mirror, the round and the failure generator's state, and
    ``extra`` tensors or arrays of the executor's own."""
    carry = {"params": state.params, "round": torch.tensor(int(state.round), dtype=torch.int64), **extra}
    carry.update({f"opt_state.{name}": f for name, f in zip(state.opt_state._fields, state.opt_state)})
    if state.residual is not None:
        carry["residual"] = state.residual
    if state.generator is not None:
        carry["generator"] = state.generator.get_state()
    return carry


def _restore_state(state: DFLState, carry: dict, **extra) -> DFLState:
    """``state`` (the executor's own copy) with the checkpoint's carry
    written into it, leaf by leaf; ``extra`` are the executor's own live
    buffers, named as they were saved.  A leaf comes back as the kind it was
    saved as (a tensor or a numpy array), so shapes and dtypes compare
    directly."""
    live = _state_carry(state, **extra)
    if set(live) != set(carry):
        raise ValueError(f"checkpoint carries {sorted(carry)}, the live run holds {sorted(live)}")
    for k, t in live.items():
        if k in ("round", "generator"):
            continue
        got = carry[k]
        if tuple(got.shape) != tuple(t.shape) or got.dtype != t.dtype:
            raise ValueError(f"checkpoint's {k} is {got.dtype} {tuple(got.shape)}, the live run's {t.dtype} "
                             f"{tuple(t.shape)}")
        if isinstance(t, torch.Tensor):
            t.copy_(got)
        else:
            t[...] = got
    if state.generator is not None:
        state.generator.set_state(carry["generator"])
    return dataclasses.replace(state, round=int(carry["round"]))


def _cols_outs(rec: Recorder, cols: list) -> dict:
    """The recorder's per-round columns so far as float64 host tensors (read
    back here, the sync a saving chunk pays); a column's float32 and int
    values are exact in float64."""
    return {c.name: torch.tensor(host_values(col), dtype=torch.float64) for c, col in zip(rec.spec.channels, cols)}


def _cols_restore(rec: Recorder, outs: dict) -> list[list]:
    """``_cols_outs`` back: per-round host numbers, which assemble as the live run's values do."""
    if set(outs) != set(rec.spec.names):
        raise ValueError(f"checkpoint records channels {sorted(outs)}, the live run {sorted(rec.spec.names)}")
    return [outs[name].tolist() for name in rec.spec.names]


def _assemble(rec: Recorder, mask: np.ndarray, cols: list, r0: int, r1: int, row_bytes: int) -> dict:
    """Rounds r0 … r1 − 1 of the columns as a history, absolute round
    numbers, ``wire_bytes`` priced from the message counts."""
    hist = rec.assemble(mask[r0:r1], [col[r0:r1] for col in cols])
    hist["round"] = [r + r0 for r in hist["round"]]
    if "wire_messages" in hist:
        hist["wire_bytes"] = [m * row_bytes for m in hist["wire_messages"]]
    return hist


def _row_bytes(state: DFLState, comp) -> int:
    """One node's row on the wire (``obs.param_row_bytes`` of the state's
    tree): each leaf at its itemsize, or at the codec's encoding."""
    return param_row_bytes(state.tree, codec_bytes=None if comp is None else comp.leaf_row_bytes)


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
    checkpoint: CheckpointPolicy | None = None,
    resume_from: str | None = None,
    plan: CommPlan | PlanSchedule | None = None,
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
    does.

    ``checkpoint`` saves the carry (params, every optimizer field, the
    mirror, the round, the failure generator's state) and the history so
    far at chunk boundaries (``CheckpointPolicy``); ``resume_from``, a
    checkpoint directory, restores the newest snapshot there and runs the
    remaining chunks.  Given the same initial ``state`` and arguments, the
    resumed run's final state and history are bit-identical to the
    uninterrupted run's; with no LATEST in the directory the run starts
    fresh.

    Wire cost: the plan the round mixes over, ``plan`` or else
    ``round_fn.plan`` (``make_round_fn`` attaches it), adds the
    ``wire_messages`` / ``wire_bytes`` channels (an undirected plan only),
    every count from ``obs.make_wire_fn``: a clean round's static count, or
    under an active failure model the round's draw replayed from a copy of
    the state's generator taken before the round (so a hand-rolled
    ``round_fn`` given ``plan=`` must draw its masks from
    ``state.generator`` first, as ``make_round_fn``'s round does).  A
    ``round_fn`` without a plan records no wire channels."""
    return _run(state, round_fn, xs, ys, schedule, n_rounds=n_rounds, eval_every=eval_every, eval_fn=eval_fn,
                eval_batch=eval_batch, track_sigmas=track_sigmas, b_local=b_local, device=device, wire=True,
                plan=plan, chunk_size=chunk_size, on_chunk=on_chunk, checkpoint=checkpoint, resume_from=resume_from)


def _run(state, round_fn, xs, ys, schedule, *, n_rounds, eval_every, eval_fn, eval_batch, track_sigmas, b_local,
         device, wire: bool, plan=None, chunk_size: int = 0, on_chunk=None, checkpoint=None, resume_from=None):
    """``run_trajectory``; ``wire`` adds the wire channels (the JAX
    package's sweep records none).  Every round's values go through the
    ``obs.Recorder`` (the legacy channels, the gated ones at the recorded
    rounds only) and the history is assembled once at the end."""
    dev = state_device(state, device)
    sched = torch.as_tensor(_as_round_schedule(schedule, n_rounds, b_local), device=dev)
    xs_d, ys_d = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
    eval_d = None if eval_batch is None else tuple(torch.as_tensor(a, device=dev) for a in eval_batch)
    gather_batch = _batch_gather(xs_d, ys_d)

    comp = getattr(round_fn, "compression", None)
    state = seed_residual(copy_state(state), comp)
    eff_plan = plan if plan is not None else getattr(round_fn, "plan", None)
    wire_fn = make_wire_fn(eff_plan) if wire and eff_plan is not None else None
    replay = wire_fn is not None and eff_plan.failures.active
    row_bytes = _row_bytes(state, comp) if wire_fn is not None else 0
    rec = Recorder(MetricsSpec.legacy(eval_fn is not None, track_sigmas, wire=wire_fn is not None))
    gated = eval_metrics(eval_fn, eval_d, track_sigmas)
    cfg = TrajectoryConfig(n_rounds, eval_every, chunk_size)
    mask = cfg.eval_mask()
    chunks = cfg.chunks()
    cols: list[list] = [[] for _ in rec.spec.channels]
    meta_id = {"kind": "trajectory", "n_rounds": n_rounds, "eval_every": eval_every, "track_sigmas": track_sigmas,
               "chunk_size": chunk_size, "compressed": comp is not None}
    skip = 0
    if resume_from is not None and (resumed := _load_resume(resume_from, meta_id)) is not None:
        payload, skip = resumed
        state = _restore_state(state, payload["carry"])
        cols = _cols_restore(rec, payload["outs"])
    for ci in range(skip, len(chunks)):
        r0, r1 = chunks[ci]
        for r in range(r0, r1):
            values = {}
            if wire_fn is not None:
                # the failure draws this round's mix makes, replayed from a
                # copy of the generator; the plan is picked by the state's
                # round (a resumed state starts past 0)
                values["wire_messages"] = wire_fn(_copy_generator(state.generator) if replay else None, state.round)
            state, metrics = round_fn(state, gather_batch(sched[r]))
            values["train_loss"] = metrics["train_loss"]
            for col, v in zip(cols, rec.step(values, gate=bool(mask[r]), gated_fn=gated, operand=state)):
                col.append(v)
        if on_chunk is not None:
            # the hook's clock reads the chunk's end: the one synchronisation it adds
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            on_chunk(r0, r1, _assemble(rec, mask, cols, r0, r1, row_bytes))
        if checkpoint is not None:
            _save_chunk_ckpt(checkpoint, ci, ci == len(chunks) - 1,
                             lambda: {"carry": _state_carry(state), "outs": _cols_outs(rec, cols)}, meta_id)
    return state, _assemble(rec, mask, cols, 0, n_rounds, row_bytes)


def run_sharded_trajectory(
    state: DFLState,
    loss_fn,
    optimizer,
    plan: ShardedCommPlan,
    xs: np.ndarray | torch.Tensor,
    ys: np.ndarray | torch.Tensor,
    schedule: np.ndarray,
    *,
    n_rounds: int,
    eval_every: int = 0,
    eval_fn=None,
    eval_batch=None,
    track_sigmas: bool = False,
    reinit_opt: bool = True,
    b_local: int | None = None,
    compression: Compression | None = None,
) -> tuple[DFLState, dict[str, list]]:
    """Node-sharded trajectory over ``plan``'s process group (DESIGN.md §15).

    SPMD: every rank of the group calls it with the same arguments, the
    globally shaped ``state``, ``xs``, ``ys`` and ``schedule`` (as
    ``run_trajectory`` takes them), and moves only its ``nps`` rows of them
    to its device (``plan.device``).  A round follows ``make_round_fn``'s
    discipline on those rows: the local steps, the mix through the plan's
    collectives (``local_mix``; with an active ``compression`` codec the
    error-feedback delta form around it, ``compressed_mix_with``: the mirror
    is rank-local and the plain codec runs per row), the optimizer re-init
    (unless ``reinit_opt`` is False).  The failure draws come from a copy of
    ``state.generator``, in the same state on every rank, so the masks are
    the unsharded plan's.

    Metrics: each rank's per-node values (losses, the eval at eval rounds,
    σ_ap's per-node stds) are all-gathered in rank order, i.e. node order,
    and reduced as ``run_trajectory`` reduces them, so every rank holds the
    same bits and reruns are bitwise; no all-reduce whose order the backend
    picks.  σ_an takes the JAX executor's two-phase moments (per-parameter
    sums, then centred sums, each gathered and added in rank order).  The
    history is ``Recorder``'s, with ``obs.sharded_wire_per_round``'s
    constants (``wire_bytes``, ``wire_rows``, ``wire_collectives``).  No
    round holds the (n, d) stack on one device: the returned state is
    globally shaped, gathered once after the last round, on every rank.

    At one shard the final params and the losses are bitwise those of
    ``run_trajectory`` over the unsharded plan with the same inputs; at
    more, within fp32 rounding (``core/shardplan.py``).  A ``PlanSchedule``
    is not sharded: it raises, as in the JAX package.
    """
    if not isinstance(plan, ShardedCommPlan):
        raise TypeError(f"run_sharded_trajectory needs a ShardedCommPlan (CommPlan.shard()), got "
                        f"{type(plan).__name__}; schedules are not sharded")
    n = plan.n
    if xs.shape[0] != n:
        raise ValueError(f"plan has {n} nodes but xs carries {xs.shape[0]}")
    dev, rows, group = plan.device, plan.rows, plan.group
    comp = compression if compression is not None and compression.active else None
    sched = torch.as_tensor(_as_round_schedule(schedule, n_rounds, b_local)[:, rows], device=dev)
    gather_batch = _batch_gather(torch.as_tensor(xs[rows], device=dev), torch.as_tensor(ys[rows], device=dev))
    eval_d = None if eval_batch is None else tuple(torch.as_tensor(a, device=dev) for a in eval_batch)
    local = lambda t: t[rows].to(dev, copy=True)  # noqa: E731
    params = local(state.params)
    opt_state = type(state.opt_state)(*(local(f) for f in state.opt_state))
    residual = None
    if comp is not None:
        residual = init_residuals(params) if state.residual is None else local(state.residual)
    generator = _copy_generator(state.generator) if plan.failures.active else None
    layout = state.layout
    mask = TrajectoryConfig(n_rounds, eval_every).eval_mask()

    def rank_sum(x: torch.Tensor) -> torch.Tensor:
        """Σ over ranks of a per-rank tensor, added in rank order."""
        every = all_gather_rows(x[None], group)
        out = every[0].clone()
        for q in range(1, every.shape[0]):
            out += every[q]
        return out

    def sigmas(x: torch.Tensor):
        """(per-node σ of this rank's rows, σ_an), σ_an from two phases."""
        x = x.detach().to(torch.float32)
        d = x.shape[-1]
        mean_n = x.sum(dim=-1) / d
        var_n = ((x - mean_n[:, None]) ** 2).sum(dim=-1) / d
        mean_p = rank_sum(x.sum(dim=0)) / n
        var_p = rank_sum(((x - mean_p[None, :]) ** 2).sum(dim=0)) / n
        return torch.sqrt(var_n), torch.sqrt(var_p).sum() / d

    losses_r, evals, sig = [], {}, {}
    for r in range(n_rounds):
        with scope("dfl_local"):
            params, opt_state, losses = _local_steps(loss_fn, optimizer, layout, params, opt_state,
                                                     gather_batch(sched[r]))
        with scope("dfl_mix"):
            if comp is not None:
                params, residual = compressed_mix_with(lambda h: plan.local_mix(h, generator), params, residual,
                                                       comp, layout=layout)
            else:
                params = plan.local_mix(params, generator)
        if reinit_opt:  # Algorithm 1 line 15
            opt_state = optimizer.init(params)
        losses_r.append(losses)
        if mask[r] and eval_fn is not None:
            with scope("dfl_eval"):
                evals[r] = eval_fn(layout.views(params), eval_d)
        if mask[r] and track_sigmas:
            sig[r] = sigmas(params)

    # every rank's per-node values in node order: one gather a kind
    per_node = lambda cols: all_gather_rows(torch.stack(cols, dim=1).contiguous(), group)  # noqa: E731
    train = per_node(losses_r) if losses_r else None
    rounds = sorted(evals) if eval_fn is not None else sorted(sig)
    test = per_node([evals[r] for r in rounds]) if evals else None
    ap = per_node([sig[r][0] for r in rounds]) if sig else None
    nan = float("nan")
    cols = [[train[:, r].contiguous().mean() for r in range(n_rounds)]]
    if eval_fn is not None:
        cols.append([nan] * n_rounds)
        for j, r in enumerate(rounds):
            cols[-1][r] = test[:, j].contiguous().mean()
    if track_sigmas:
        cols += [[nan] * n_rounds, [nan] * n_rounds]
        for j, r in enumerate(rounds):
            cols[-2][r], cols[-1][r] = ap[:, j].contiguous().mean(), sig[r][1]
    rec = Recorder(MetricsSpec.legacy(eval_fn is not None, track_sigmas))
    hist = rec.assemble(mask, cols, constants=sharded_wire_per_round(
        plan, state.tree, codec_bytes=comp.leaf_row_bytes if comp is not None else None))
    final = DFLState(
        params=all_gather_rows(params, group),
        opt_state=type(opt_state)(*(all_gather_rows(f, group) for f in opt_state)),
        layout=layout,
        round=state.round + n_rounds,
        generator=generator if generator is not None else _copy_generator(state.generator),
        residual=None if residual is None else all_gather_rows(residual, group),
    )
    return final, hist


def _batch_gather(xs_d: torch.Tensor, ys_d: torch.Tensor):
    """``gather(idx)``: a round's (n, b, bs) schedule indices → ((n, b, bs,
    *feat), (n, b, bs)), each node's rows of its own dataset."""
    n_nodes = xs_d.shape[0]
    node_idx = torch.arange(n_nodes, device=xs_d.device)[:, None]

    def gather(idx: torch.Tensor):
        flat = idx.reshape(n_nodes, -1).long()
        bx = xs_d[node_idx, flat].reshape(*idx.shape, *xs_d.shape[2:])
        by = ys_d[node_idx, flat].reshape(*idx.shape, *ys_d.shape[2:])
        return bx, by

    return gather


def _run_schedules(schedule, n_runs: int, schedule_per_run: bool) -> list:
    """Each run's schedule: the shared one, or with ``schedule_per_run``
    run i's slice of the leading run axis."""
    if not schedule_per_run:
        return [schedule] * n_runs
    s = np.asarray(schedule)
    if s.shape[0] != n_runs:
        raise ValueError(f"schedule_per_run: the schedule's leading axis holds {s.shape[0]} runs, not {n_runs}")
    return list(s)


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
    chunk_size: int = 0,
    schedule_per_run: bool = False,
    b_local: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[DFLState, list[dict[str, list]]]:
    """Several trajectories (seeds × gains ...) sharing one dataset, one
    schedule and one upload, run one after another.  ``states`` is a list
    of per-run states or a stacked one; ``schedule_per_run=True`` gives
    each run its own batch order, the schedule then carrying a leading run
    axis.  ``chunk_size`` is ``run_trajectory``'s (it changes nothing a run
    computes).  Returns the stacked final state and one history per run,
    without wire channels (as the JAX package's)."""
    runs = unstack_states(states) if isinstance(states, DFLState) else list(states)
    dev = state_device(runs[0], device)
    xs_d, ys_d = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
    finals, hists = [], []
    for s, sched in zip(runs, _run_schedules(schedule, len(runs), schedule_per_run)):
        final, hist = _run(
            s, round_fn, xs_d, ys_d, sched, n_rounds=n_rounds, eval_every=eval_every,
            eval_fn=eval_fn, eval_batch=eval_batch, track_sigmas=track_sigmas,
            b_local=b_local, device=dev, wire=False, chunk_size=chunk_size,
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
    chunk_size: int = 0,
    b_local: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[DFLState, dict[str, list], np.ndarray]:
    """**Estimate → per-node gain → init → train** (§4.4).

    ``seed`` splits into (estimation seed, init seed) (``split_seed``):
    ``estimate_gains(estimation seed)`` (a ``make_gain_estimator``) runs the
    gossip rounds and returns the (n,) gains on the device, which
    ``init_fl_state(init seed, ..., gains=)`` draws every node's parameters
    with, and the trajectory runs as ``run_trajectory``'s (``chunk_size``
    its chunks), without wire channels (as the JAX package's warmup).
    Running those three by hand with the same split gives the same result.
    Returns ``(final_state, history, gains)``, the realised gains as numpy.
    """
    est_seed, init_seed = split_seed(seed, 2)
    gains = estimate_gains(est_seed)
    state = init_fl_state(init_seed, n_nodes, init_one, optimizer, gains=gains, device=device)
    state, hist = _run(state, round_fn, xs, ys, schedule, n_rounds=n_rounds, eval_every=eval_every, eval_fn=eval_fn,
                       eval_batch=eval_batch, track_sigmas=track_sigmas, b_local=b_local, device=device, wire=False,
                       chunk_size=chunk_size)
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
    chunk_size: int = 0,
    schedule_per_run: bool = False,
    b_local: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[DFLState, list[dict[str, list]], np.ndarray]:
    """A (budget × seed) grid of warmup trajectories over one upload, run
    one after another: run i is ``run_warmup_trajectory(seeds[i])`` with
    ``estimate_gains(estimation seed, budgets[i])`` (without ``budgets``:
    ``estimate_gains(estimation seed)``), so a budget-b cell equals a
    standalone budget-b run.  ``schedule_per_run`` and ``chunk_size`` are
    ``run_sweep``'s.  Returns ``(stacked_states, histories, gains)``, the
    gains an (n_runs, n_nodes) numpy array."""
    if budgets is not None and len(budgets) != len(seeds):
        raise ValueError(f"budgets has {len(budgets)} entries for {len(seeds)} seeds")
    dev = resolve_device(device)
    xs_d, ys_d = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
    finals, hists, gains = [], [], []
    for i, (seed, sched) in enumerate(zip(seeds, _run_schedules(schedule, len(seeds), schedule_per_run))):
        estimate = estimate_gains if budgets is None else (lambda s, b=int(budgets[i]): estimate_gains(s, b))
        final, hist, g = run_warmup_trajectory(
            int(seed), round_fn, xs_d, ys_d, sched, n_nodes=n_nodes, init_one=init_one, optimizer=optimizer,
            estimate_gains=estimate, n_rounds=n_rounds, eval_every=eval_every, eval_fn=eval_fn,
            eval_batch=eval_batch, track_sigmas=track_sigmas, chunk_size=chunk_size, b_local=b_local, device=dev,
        )
        finals.append(final)
        hists.append(hist)
        gains.append(g)
    return stack_states(finals), hists, np.stack(gains)


# ------------------------------------------------------- event-driven executor
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
        with scope("dfl_local"):
            iu, iv = sched_d[counts[u] % n_sched_rounds, u], sched_d[counts[v] % n_sched_rounds, v]
            batch = (torch.stack([xs_d[u][iu], xs_d[v][iv]]), torch.stack([ys_d[u][iu], ys_d[v][iv]]))
            pair = torch.stack([params[u], params[v]])
            pair_o = type(opt_state)(*(torch.stack([f[u], f[v]]) for f in opt_state))
            pair, pair_o, losses = _local_steps(loss_fn, optimizer, layout, pair, pair_o, batch)
        with torch.no_grad(), scope("dfl_mix"):
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
        with torch.no_grad():
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
    their mirrors.

    ``checkpoint`` (a ``CheckpointPolicy``) saves the whole carry at chunk
    ends: params, optimizer state and mirror, the host counts and clocks,
    the per-bin accumulators.  ``resume_from`` restores the newest one and
    runs the remaining chunks; the run's one seed is drawn again from the
    same initial state, so each event keeps its flag and the result is
    bit-identical to the uninterrupted run's.
    """
    comp = compression if (compression is not None and compression.active) else None
    run = _EventRun(state, loss_fn, optimizer, plan, stream, xs, ys, schedule, b_local=b_local, n_bins=n_bins,
                    eval_fn=eval_fn, eval_batch=eval_batch, reinit_opt=reinit_opt, comp=comp, device=device,
                    name="run_event_trajectory")
    env = stream.envelope
    size = env if chunk_events <= 0 else int(chunk_events)
    bounds = [(i0, min(i0 + size, env)) for i0 in range(0, env, size)]
    meta_id = {"kind": "event", "env": env, "n_bins": n_bins, "chunk_events": size,
               "reinit_opt": bool(reinit_opt), "compressed": comp is not None}
    skip = 0
    if resume_from is not None and (resumed := _load_resume(resume_from, meta_id)) is not None:
        payload, skip = resumed
        run.restore(payload["carry"])
    for ci in range(skip, len(bounds)):
        i0, i1 = bounds[ci]
        for i in np.nonzero(run.live[i0:i1])[0] + i0:
            run.gossip(int(i))
        if on_chunk is not None:
            # one synchronisation a chunk: the hook reads the chunk's end
            on_chunk(ci, i0, i1, run.acc())
        if checkpoint is not None:
            _save_chunk_ckpt(checkpoint, ci, ci == len(bounds) - 1, lambda: {"carry": run.carry()}, meta_id)
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
        # the per-bin accumulators (obs.BinSpec): the losses on the device,
        # the counts, staleness sums and histogram on the host (numpy views
        # of CPU tensors, the JAX executor's fp32 arithmetic)
        dev_bins = BinSpec(n_bins, (BinChannel("loss_sum"), BinChannel("test_bin", fill=float("nan")))).init(dev)
        host_bins = BinSpec(n_bins, (BinChannel("cnt"), BinChannel("stale_sum"), BinChannel("msg_cnt"),
                                     BinChannel("stale_hist", width=_STALE_BUCKETS))).init("cpu")
        self.loss_sum, self.test_bin = dev_bins["loss_sum"], dev_bins["test_bin"]
        self.cnt, self.stale_sum, self.msg_cnt, self.stale_hist = (
            host_bins[k].numpy() for k in ("cnt", "stale_sum", "msg_cnt", "stale_hist"))
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
            with scope("dfl_eval"):
                self.test_bin[b : b + 1].copy_(self.eval_fn(st.layout.views(st.params), self.eval_d).mean())

    def acc(self) -> dict:
        """The per-bin accumulators so far, as numpy (reading them waits for the card)."""
        return dict(loss_sum=self.loss_sum.cpu().numpy(), cnt=self.cnt.copy(), stale_sum=self.stale_sum.copy(),
                    msg_cnt=self.msg_cnt.copy(), test_bin=self.test_bin.cpu().numpy(),
                    stale_hist=self.stale_hist.copy())

    def _buffers(self) -> dict:
        return dict(counts=self.counts, clocks=self.clocks, loss_sum=self.loss_sum, test_bin=self.test_bin,
                    cnt=self.cnt, stale_sum=self.stale_sum, msg_cnt=self.msg_cnt, stale_hist=self.stale_hist)

    def carry(self) -> dict:
        """The whole carry for a checkpoint: the state's buffers and the
        run's counts, clocks and per-bin accumulators (the generator's state
        too, as the one seed left it)."""
        return _state_carry(self.state, **self._buffers())

    def restore(self, carry: dict) -> None:
        """Write a checkpoint's carry into this run, in place."""
        self.state = _restore_state(self.state, carry, **self._buffers())

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


# ------------------------------------------------------- elastic membership
def elastic_draws(kind: str, seed: int, r: int, *, n: int, device, n_sketches: int = 0, init_one=None,
                  gains=None):
    """Round ``r``'s forked draws of the elastic executor, the one place it
    takes them from (the tests inject the JAX package's here).

    ``seed`` is the child seed ``run_elastic_trajectory`` derives from a
    copy of the state's generator; it splits into (sketch, init) seeds
    (``split_seed``).  ``kind="sketches"``: round r's fresh (n,
    ``n_sketches``) Exp(1) sketches (r = n_rounds: the initial ones), from
    ``round_generator(sketch seed, r)``.  ``kind="init"``: ``init_one(g,
    gains)``, the node-stacked tree drawn on a generator on ``device``
    seeded from (init seed, r); the executor takes the rows of the nodes
    that initialise at round r.  The JAX package draws
    ``exponential(fold_in(k_fresh, r))`` and ``vmap(init_one)(fold_in(
    fold_in(k_init, r), i), gains)``.
    """
    sketch_seed, init_seed = split_seed(seed, 2)
    if kind == "sketches":
        g = round_generator(sketch_seed, r)
        return torch.empty(n, n_sketches, dtype=torch.float32).exponential_(generator=g).to(device)
    if kind == "init":
        s = int(np.random.SeedSequence([init_seed, r]).generate_state(1, np.uint64)[0])
        return init_one(torch.Generator(device=device).manual_seed(s), gains)
    raise ValueError(f"unknown elastic draw {kind!r}")


def _rows_where(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Row i from ``new`` where ``mask[i]``, else from ``old`` (exact)."""
    return torch.where(mask.reshape(-1, *([1] * (new.ndim - 1))), new, old)


def run_elastic_trajectory(
    state: DFLState,
    loss_fn,
    optimizer,
    plan: CommPlan | PlanSchedule | Graph,
    membership,
    xs: np.ndarray | torch.Tensor,
    ys: np.ndarray | torch.Tensor,
    schedule: np.ndarray,
    *,
    n_rounds: int,
    eval_every: int = 0,
    eval_fn=None,
    eval_batch=None,
    reinit_opt: bool = True,
    b_local: int | None = None,
    chunk_size: int = 0,
    init_one: Callable | None = None,
    n_sketches: int = 32,
    faults=None,
    checkpoint: CheckpointPolicy | None = None,
    resume_from: str | None = None,
    on_chunk: Callable[[int, int, dict], None] | None = None,
    compression: Compression | None = None,
    device: str | torch.device | None = None,
) -> tuple[DFLState, dict[str, list], dict[str, np.ndarray]]:
    """Elastic-membership trajectory: nodes join, leave and crash inside the
    static n-node envelope (counterpart of the JAX ``run_elastic_trajectory``).

    Every round runs the whole envelope.  A ``core.membership``
    ``MembershipSchedule`` and a ``core.faults.FaultPlan`` give round r's
    masks on the host: the training members ``active & node_up``, the
    gossip population ``gossip & node_up``, the arrivals ``joins`` and the
    nodes that initialise ``inits``, and the live edges ``edge_up``.  A
    round, in the JAX executor's order:

      1. the nodes flagged in ``inits[r]`` draw fresh parameters
         uncoordinated, ``init_one(generator, gains)`` at the size-only gain
         ``sqrt(max((m − 1) / Σ sketches, 1))`` of their own carried
         sketches, and their optimizer rows re-initialise;
      2. the local phase of every node, the rows of non-members (params and
         optimizer state) put back exactly as they were;
      3. arrivals redraw their sketches, then one min-exchange
         (``spread_min``) over the gossip population;
      4. the masked, renormalised mix over the training members (a member's
         row over its live neighbourhood, a non-member's the identity), or
         the compressed one with only the members' mirrors advancing;
      5. the members' optimizer rows re-initialise (``reinit_opt``);
      6. at the eval mask's rounds the members' mean train loss, their mean
         test loss (``eval_fn``), ``n_active`` and the wire count.

    **One failure draw a round.**  Under an active failure model the round
    draws its masks once (``round_masks`` of the plan active at r, the draw
    ``make_round_fn``'s round makes), ANDs them into the membership and
    fault masks, and runs the mix, the min-exchange and the wire count on
    the plan's failure-free twin (``CommPlan._clean``) with those masks:
    estimation rides training's links and the generator moves as in
    ``run_trajectory``.

    **Forked draws.**  The sketches and the joiners' parameters come from a
    child seed drawn from a *copy* of the state's generator, so the training
    stream is left as the static executor's; round r's draws are
    ``elastic_draws(kind, seed, r)``.  The state needs a generator, and a
    membership with joiners needs ``init_one``.

    A membership with no dynamics (``membership.trivial``) and no faults is
    ``make_round_fn`` + ``run_trajectory``, bit for bit, with ``n_active``
    added to the history and ``aux["n_hat"]`` the true n.  ``checkpoint`` /
    ``resume_from`` save and restore the carry (params, optimizer state, the
    failure generator's state, the sketches and the mirror) and the history
    so far at chunk boundaries, as ``run_trajectory``'s.  Returns
    ``(final_state, history, aux)``: the history keys of ``run_trajectory``
    plus ``n_active`` (the wire channels on an undirected plan), ``aux``
    ``{"n_hat": the final per-node estimate from the carried sketches}``.
    """
    dev = state_device(state, device)
    plan = compile_plan(plan, device=dev) if isinstance(plan, Graph) else plan
    n_nodes = xs.shape[0]
    if plan.n != n_nodes:
        raise ValueError(f"plan has {plan.n} nodes but xs carries {n_nodes}")
    if membership.n != n_nodes or membership.n_rounds != n_rounds:
        raise ValueError(f"membership is ({membership.n_rounds}, {membership.n}) but the run wants "
                         f"({n_rounds}, {n_nodes})")
    trivial_faults = faults is None or faults.trivial
    if faults is not None and (faults.n != n_nodes or faults.n_rounds != n_rounds):
        raise ValueError(f"fault plan is ({faults.n_rounds}, {faults.n}) but the run wants ({n_rounds}, {n_nodes})")
    if membership.trivial and trivial_faults:
        round_fn = make_round_fn(loss_fn, optimizer, plan, reinit_opt=reinit_opt, compression=compression)
        state, hist = run_trajectory(
            state, round_fn, xs, ys, schedule, n_rounds=n_rounds, eval_every=eval_every, eval_fn=eval_fn,
            eval_batch=eval_batch, chunk_size=chunk_size, b_local=b_local, checkpoint=checkpoint,
            resume_from=resume_from, on_chunk=on_chunk, device=dev,
        )
        hist["n_active"] = [n_nodes] * len(hist["round"])
        return state, hist, {"n_hat": np.full(n_nodes, float(n_nodes))}
    if membership.inits.any() and init_one is None:
        raise ValueError("membership has joining nodes: init_one(generator, gains) is required")
    if state.generator is None:
        raise ValueError("the elastic executor forks its sketch and init draws off the state's generator: "
                         "the state needs one")

    scheduled = isinstance(plan, PlanSchedule)
    comp = compression if (compression is not None and compression.active) else None
    cfg = TrajectoryConfig(n_rounds, eval_every, chunk_size)
    mask = cfg.eval_mask()
    chunks = cfg.chunks()
    sched = torch.as_tensor(_as_round_schedule(schedule, n_rounds, b_local), device=dev)
    gather_batch = _batch_gather(torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev))
    eval_d = None if eval_batch is None else tuple(torch.as_tensor(a, device=dev) for a in eval_batch)
    n_edges = plan.n_edges_env if scheduled else plan.n_edges
    if trivial_faults:
        node_up = np.ones((n_rounds, n_nodes), bool)
        edge_up = np.ones((n_rounds, max(n_edges, 1)), bool)
    else:
        node_up, edge_up = faults.node_up, faults.edge_up
    # the wire accountant counts the masks the mix takes (the round's draw
    # already ANDed in), so it is called without a generator
    wire_fn = make_wire_fn(plan)

    state = seed_residual(copy_state(state), comp)
    layout = state.layout
    row_bytes = _row_bytes(state, comp) if wire_fn is not None else 0
    channels = [Channel("train_loss")]
    if eval_fn is not None:
        channels.append(Channel("test_loss", gated=True))
    channels.append(Channel("n_active", ints=True))
    if wire_fn is not None:
        channels.append(Channel("wire_messages", ints=True))
    rec = Recorder(MetricsSpec(tuple(channels)))
    cols: list[list] = [[] for _ in channels]
    # the forked streams: a child seed drawn from a copy of the generator,
    # so the training stream (one draw a round) is the static executor's
    seed = int(torch.randint(0, 2**62, (1,), generator=_copy_generator(state.generator)))
    sketches = elastic_draws("sketches", seed, n_rounds, n=n_nodes, n_sketches=n_sketches, device=dev)
    meta_id = {"kind": "elastic", "n_rounds": n_rounds, "eval_every": eval_every, "chunk_size": chunk_size,
               "n_sketches": n_sketches, "compressed": comp is not None}
    skip = 0
    if resume_from is not None and (resumed := _load_resume(resume_from, meta_id)) is not None:
        payload, skip = resumed
        state = _restore_state(state, payload["carry"], sketches=sketches)
        cols = _cols_restore(rec, payload["outs"])

    def as_dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.bool, device=dev)

    for ci in range(skip, len(chunks)):
        r0, r1 = chunks[ci]
        for r in range(r0, r1):
            view = plan.select(r) if scheduled else plan
            tr_np = membership.active[r] & node_up[r]
            gs_np = membership.gossip[r] & node_up[r]
            tr, gs = as_dev(tr_np), as_dev(gs_np)
            # the round's one failure draw, ANDed into the deterministic masks
            live = as_dev(np.concatenate([edge_up[r], np.ones(max(view.draw_width - len(edge_up[r]), 0), bool)])
                          [: max(view.draw_width, 1)])
            tr_mix, gs_mix = tr, gs
            if view.failures.active:
                edge_keep, node_act = (m.to(dev) for m in view.round_masks(state.generator))
                live, tr_mix, gs_mix = live & edge_keep, tr & node_act, gs & node_act
            clean = view._clean
            params, opt_state = state.params, state.opt_state

            # 1. joiners whose warmup just ended initialise from their own sketches
            if membership.inits[r].any():
                ini = as_dev(membership.inits[r])
                gains = torch.sqrt(torch.clamp_min((n_sketches - 1) / torch.clamp_min(sketches.sum(dim=1), 1e-30),
                                                   1.0))
                drawn = layout.flatten(elastic_draws("init", seed, r, n=n_nodes, device=dev, init_one=init_one,
                                                     gains=gains))
                params = _rows_where(ini, drawn.to(params.dtype), params)
                fresh_o = optimizer.init(params)
                opt_state = type(opt_state)(*(_rows_where(ini, f, o) for f, o in zip(fresh_o, opt_state)))

            # 2. the local phase at the full envelope; non-members' rows are put back
            frozen = np.nonzero(~tr_np)[0]
            idx = torch.as_tensor(frozen, device=dev)
            kept = params[idx].clone() if len(frozen) else None
            with scope("dfl_local"):
                params, new_o, losses = _local_steps(loss_fn, optimizer, layout, params, opt_state,
                                                     gather_batch(sched[r]))
            with torch.no_grad():
                if kept is not None:
                    params[idx] = kept
                opt_state = type(opt_state)(*(_rows_where(tr, f, o) for f, o in zip(new_o, opt_state)))

                # 3. arrivals redraw their sketches; one min-exchange over the gossip population
                if membership.joins[r].any():
                    fresh = elastic_draws("sketches", seed, r, n=n_nodes, n_sketches=n_sketches, device=dev)
                    sketches = torch.where(as_dev(membership.joins[r])[:, None], fresh, sketches)
                sketches = clean.spread_min(sketches, active=gs_mix, edge_live=live)

                # 4. the masked mix over the training members
                residual = state.residual
                with scope("dfl_mix"):
                    if comp is not None:
                        params, residual = compressed_mix(clean, params, residual, compression=comp, layout=layout,
                                                          active=tr_mix, edge_live=live, update_mask=tr)
                    else:
                        params = clean.mix(params, active=tr_mix, edge_live=live)
                # 5. Algorithm 1 line 15, members only
                if reinit_opt:
                    opt_state = type(opt_state)(*(_rows_where(tr, f, o)
                                                  for f, o in zip(optimizer.init(params), opt_state)))
            state = dataclasses.replace(state, params=params, opt_state=opt_state, residual=residual,
                                        round=state.round + 1)

            # 6. metrics over the live training population (the test loss at
            # the recorded rounds), the delivered messages of the masked mix
            n_act = int(tr_np.sum())
            safe = float(max(n_act, 1))
            trf = tr.to(torch.float32)
            values = {"train_loss": (losses * trf).sum() / safe, "n_active": n_act}
            if wire_fn is not None:
                values["wire_messages"] = wire_fn(None, r, active=tr_mix, edge_live=live)

            def gated(p, trf=trf, safe=safe):
                with scope("dfl_eval"):
                    return {"test_loss": (eval_fn(layout.views(p), eval_d) * trf).sum() / safe}

            for col, v in zip(cols, rec.step(values, gate=bool(mask[r]), gated_fn=gated, operand=params)):
                col.append(v)
        if on_chunk is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            on_chunk(r0, r1, _assemble(rec, mask, cols, r0, r1, row_bytes))
        if checkpoint is not None:
            _save_chunk_ckpt(checkpoint, ci, ci == len(chunks) - 1,
                             lambda: {"carry": _state_carry(state, sketches=sketches),
                                      "outs": _cols_outs(rec, cols)}, meta_id)
    hist = _assemble(rec, mask, cols, 0, n_rounds, row_bytes)
    s_np = sketches.cpu().numpy()
    n_hat = (n_sketches - 1) / np.maximum(s_np.sum(axis=1), np.float32(1e-30))
    return state, hist, {"n_hat": n_hat}

