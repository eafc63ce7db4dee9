"""Round executor over a device-resident dataset (counterpart of ``repro/fed/executor.py``).

``run_trajectory`` runs a whole DFL trajectory with the per-node datasets
and the batch schedule uploaded once: each round's minibatches are gathered
on the device from ``data.pipeline.batch_index_schedule`` (the same order
the host iterator yields), metrics are kept as device scalars at the eval
rounds and read back once at the end.  ``run_sweep`` runs several
trajectories (seeds × gains ...) over one upload.  The history dict has the
JAX executor's keys: ``round``, ``train_loss``, ``test_loss``,
``sigma_ap``, ``sigma_an``.  Checkpointing, wire accounting and the
sharded / event / elastic / warmup executors are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .trainer import (
    HISTORY_KEYS,
    DFLState,
    copy_state,
    finish_history,
    record_round,
    state_device,
)

__all__ = ["TrajectoryConfig", "run_trajectory", "run_sweep", "stack_states", "unstack_states"]


@dataclasses.dataclass(frozen=True)
class TrajectoryConfig:
    """``eval_every`` as ``train_loop``: metrics at rounds
    ``r % eval_every == 0`` plus the final round; 0 disables recording."""

    n_rounds: int
    eval_every: int = 0

    def eval_mask(self) -> np.ndarray:
        mask = np.zeros(self.n_rounds, dtype=bool)
        if self.eval_every:
            mask[:: self.eval_every] = True
            mask[-1] = True
        return mask


def stack_states(states: Sequence[DFLState]) -> DFLState:
    """Stack independent runs' states along a leading run axis."""
    s0 = states[0]
    return DFLState(
        params=torch.stack([s.params for s in states]),
        opt_state=type(s0.opt_state)(*(torch.stack(f) for f in zip(*(s.opt_state for s in states)))),
        layout=s0.layout,
        round=s0.round,
        generator=tuple(s.generator for s in states),
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
    b_local: int | None = None,
    device: str | torch.device | None = None,
) -> tuple[DFLState, dict[str, list]]:
    """Run ``n_rounds`` rounds of ``round_fn`` on the state's device (which
    must be ``device``, default cuda).  ``schedule`` is
    ``batch_index_schedule(...)`` output covering ``n_rounds × b_local``
    minibatches, or already round-shaped (n_rounds, n, b, bs).  The caller's
    state is left untouched."""
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

    state = copy_state(state)
    mask = TrajectoryConfig(n_rounds, eval_every).eval_mask()
    hist: dict[str, list] = {k: [] for k in HISTORY_KEYS}
    for r in range(n_rounds):
        state, metrics = round_fn(state, gather_batch(sched[r]))
        if mask[r]:
            record_round(hist, r, state, metrics, eval_fn, eval_d, track_sigmas)
    return state, finish_history(hist)


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
    and one history per run."""
    runs = unstack_states(states) if isinstance(states, DFLState) else list(states)
    dev = state_device(runs[0], device)
    xs_d, ys_d = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
    finals, hists = [], []
    for s in runs:
        final, hist = run_trajectory(
            s, round_fn, xs_d, ys_d, schedule, n_rounds=n_rounds, eval_every=eval_every,
            eval_fn=eval_fn, eval_batch=eval_batch, track_sigmas=track_sigmas,
            b_local=b_local, device=dev,
        )
        finals.append(final)
        hists.append(hist)
    return stack_states(finals), hists
