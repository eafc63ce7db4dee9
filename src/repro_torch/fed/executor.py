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
what an unchunked one does.  Checkpointing and the sharded / event /
elastic executors are not ported yet (ROADMAP.md Queue 1 items 12, 17, 11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.commplan import PlanSchedule
from repro_torch.core.compress import seed_residual
from repro_torch.device import resolve_device

from repro_torch.gossip.engine import split_seed

from .trainer import (
    HISTORY_KEYS,
    DFLState,
    _copy_generator,
    copy_state,
    finish_history,
    init_fl_state,
    record_round,
    state_device,
)

__all__ = [
    "TrajectoryConfig",
    "run_sweep",
    "run_trajectory",
    "run_warmup_sweep",
    "run_warmup_trajectory",
    "stack_states",
    "unstack_states",
]


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
