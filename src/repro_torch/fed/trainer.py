"""Decentralised federated training loop, paper Algorithm 1 (counterpart of ``repro/fed/trainer.py``).

The node ensemble lives in one flat ``(n, d)`` buffer (``repro_torch.flat``)
and all nodes step together.  One communication round =

    1. ``b`` local minibatch steps per node        (Algorithm 1 lines 8–10)
    2. DecAvg aggregation over the graph           (line 14, Eq. 2)
    3. optimizer-state re-initialisation           (line 15)

A local step sums the per-node mean losses and calls one backward: node i's
loss depends only on node i's row of the buffer, so each row of the flat
gradient is exactly that node's own gradient.

With ``make_round_fn(compression=...)`` step 2 is a compressed gossip round
(``core/compress.py``) whose per-node fp32 mirrors ride ``DFLState.residual``.
Over a ``PlanSchedule`` step 2 mixes with the plan active at ``state.round``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core.commplan import CommPlan, FailureModel, PlanSchedule, compile_plan
from repro_torch.core.compress import Compression, compressed_mix, init_residuals
from repro_torch.core.topology import Graph
from repro_torch.device import resolve_device
from repro_torch.flat import FlatLayout
from repro_torch.optim import Optimizer

Tree = dict[str, Any]
LossFn = Callable[[Tree, Any], torch.Tensor]  # (node-stacked params, batch) -> (n,) losses

__all__ = [
    "DFLState",
    "init_fl_state",
    "make_round_fn",
    "make_eval_fn",
    "sigma_metrics",
    "train_loop",
]


@dataclasses.dataclass
class DFLState:
    """The ensemble's state.  ``params`` is the flat (n, d) buffer (``(R, n, d)``
    and a tuple of generators after ``stack_states``); ``tree`` views it as
    the model's parameter dict.  ``generator`` is the CPU generator the
    failure draws consume.  ``residual`` is the compressed-gossip carry, each
    node's transmitted mirror as a flat fp32 buffer shaped as ``params``, or
    None (uncompressed)."""

    params: torch.Tensor
    opt_state: Any
    layout: FlatLayout
    round: int = 0
    generator: torch.Generator | tuple[torch.Generator, ...] | None = None
    residual: torch.Tensor | None = None

    @property
    def tree(self) -> Tree:
        return self.layout.views(self.params)


def _map_state(fn, opt_state):
    return type(opt_state)(*(fn(t) for t in opt_state))


def _copy_generator(g: torch.Generator | None) -> torch.Generator | None:
    if g is None:
        return None
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def copy_state(state: DFLState) -> DFLState:
    """A deep copy: the executors update their carry in place and must not
    touch the caller's state."""
    return DFLState(
        params=state.params.clone(),
        opt_state=_map_state(torch.clone, state.opt_state),
        layout=state.layout,
        round=state.round,
        generator=_copy_generator(state.generator),
        residual=None if state.residual is None else state.residual.clone(),
    )


def init_fl_state(
    seed: int,
    n_nodes: int,
    init_one: Callable[[torch.Generator, torch.Tensor], Tree],
    optimizer: Optimizer,
    gains: float | np.ndarray | torch.Tensor | None = None,
    device: str | torch.device | None = None,
) -> DFLState:
    """Uncoordinated init: every node draws independently (paper §3).

    ``init_one(generator, gains)`` draws the whole node-stacked tree on the
    generator's device, node i scaled by ``gains[i]`` (e.g.
    ``lambda g, gains: init_mlp(InitConfig("he_normal", gains), g)``).
    ``gains`` is an (n,) vector of per-node gains or a scalar (default 1).
    The failure-draw generator is a CPU generator seeded with ``seed``.
    """
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    gain_vec = torch.as_tensor(1.0 if gains is None else gains, dtype=torch.float32, device=dev)
    tree = init_one(g, gain_vec.broadcast_to((n_nodes,)).contiguous())
    layout = FlatLayout.of(tree)
    params = layout.flatten(tree)
    if params.shape[0] != n_nodes:
        raise ValueError(f"init_one drew {params.shape[0]} nodes, expected {n_nodes}")
    return DFLState(
        params=params,
        opt_state=optimizer.init(params),
        layout=layout,
        round=0,
        generator=torch.Generator().manual_seed(seed),
    )


def _local_steps(
    loss_fn: LossFn, optimizer: Optimizer, layout: FlatLayout, params: torch.Tensor, opt_state, batches
) -> tuple[torch.Tensor, Any, torch.Tensor]:
    """b sequential minibatch steps for every node; batches (x (n, b, bs, ...),
    y (n, b, bs)).  Updates ``params`` IN PLACE (the flat buffer is owned by
    the round); returns it with the new optimizer state and the per-node
    mean loss over the b steps."""
    bx, by = batches
    losses = []
    for k in range(bx.shape[1]):
        p = params.detach().requires_grad_(True)
        per_node = loss_fn(layout.views(p), (bx[:, k], by[:, k]))
        (grads,) = torch.autograd.grad(per_node.sum(), p)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params.add_(updates)  # in place: p + u
        losses.append(per_node.detach())
    return params, opt_state, torch.stack(losses, dim=1).mean(dim=1)


def make_round_fn(
    loss_fn: LossFn,
    optimizer: Optimizer,
    plan: CommPlan | PlanSchedule | Graph,
    data_sizes: np.ndarray | None = None,
    link_p: float = 1.0,
    node_p: float = 1.0,
    device: str | torch.device | None = None,
    compression: Compression | None = None,
):
    """Build ``round_fn(state, node_batches) -> (state, metrics)``.

    ``plan`` is a compiled ``CommPlan``, a time-varying ``PlanSchedule``
    (each round then mixes with the plan active at ``state.round``), or a
    ``Graph``, compiled here with the "auto" backend from
    ``data_sizes``/``link_p``/``node_p`` on ``device``.  On a compiled plan
    or schedule, ``data_sizes`` / ``link_p`` / ``node_p`` override the
    plan's own when given: it is recompiled (``with_options``) with only
    those knobs replaced, so data sizes alone keep its failure model.  A
    ``device`` other than the plan's raises.  ``node_batches`` is (x (n, b,
    bs, ...), y (n, b, bs)) on the state's device.  The round consumes
    ``state``: its params buffer is updated in place by the local steps.

    An active ``compression`` codec makes the aggregation the error-feedback
    delta form over the same operator; the mirrors ride ``state.residual``
    (zeros when the state has none: ``run_trajectory`` seeds them first).
    ``compression=None`` or codec ``"none"`` leaves the round unchanged.
    ``round_fn.plan`` is the effective plan (overrides applied) and
    ``round_fn.compression`` the active codec or None.
    """
    failures = FailureModel(link_p=link_p, node_p=node_p)
    if isinstance(plan, Graph):
        plan = compile_plan(plan, backend="auto", data_sizes=data_sizes, failures=failures, device=device)
    else:
        want = None if device is None else resolve_device(device)
        if want is not None and (want.type != plan.device.type or want.index not in (None, plan.device.index)):
            raise ValueError(f"the plan lies on {plan.device}, the round was asked for {want}")
        if failures.active or data_sizes is not None:
            plan = plan.with_options(data_sizes=data_sizes, failures=failures if failures.active else None)
    scheduled = isinstance(plan, PlanSchedule)
    comp = compression if compression is not None and compression.active else None

    def round_fn(state: DFLState, node_batches) -> tuple[DFLState, dict]:
        params, opt_state, losses = _local_steps(
            loss_fn, optimizer, state.layout, state.params, state.opt_state, node_batches
        )
        # double buffer: the kernel writes the mixed ensemble into a new
        # buffer that is swapped in; the old one goes back to the caching
        # allocator and becomes the next round's output
        generator = state.generator if plan.failures.active else None
        residual = state.residual
        if comp is not None:
            if residual is None:
                residual = init_residuals(params)
            params, residual = compressed_mix(
                plan, params, residual, generator, compression=comp, layout=state.layout,
                round_index=state.round if scheduled else None,
            )
        elif scheduled:
            params = plan.mix(params, state.round, generator)
        else:
            params = plan.mix(params, generator)
        new_state = dataclasses.replace(
            state,
            params=params,
            opt_state=optimizer.init(params),  # Algorithm 1 line 15
            round=state.round + 1,
            residual=residual,
        )
        return new_state, {"train_loss": losses.mean(), "train_loss_per_node": losses}

    round_fn.plan = plan
    round_fn.compression = comp
    return round_fn


def make_eval_fn(loss_fn: LossFn):
    """Every node's test loss on the shared test batch: ``(n,)``."""

    def eval_fn(params: Tree, test_batch) -> torch.Tensor:
        with torch.no_grad():
            return loss_fn(params, test_batch)

    return eval_fn


def sigma_metrics(params: torch.Tensor) -> dict[str, torch.Tensor]:
    """σ_ap / σ_an over the flat (n, d) ensemble (§3).

    σ_ap: mean over nodes of the std across that node's parameters;
    σ_an: mean over parameters of the std across nodes.  Both are
    population stds, as ``jnp.std``.
    """
    x = params.detach().to(torch.float32)
    d = x.shape[-1]
    mean_n = x.sum(dim=-1) / d
    var_n = ((x - mean_n[..., None]) ** 2).sum(dim=-1) / d
    return {
        "sigma_ap": torch.sqrt(var_n).mean(dim=-1),
        "sigma_an": x.std(dim=-2, correction=0).sum(dim=-1) / d,
    }


HISTORY_KEYS = ("round", "train_loss", "test_loss", "sigma_ap", "sigma_an")


def record_round(hist: dict, r: int, state: DFLState, metrics: dict, eval_fn, eval_batch, track_sigmas) -> None:
    """Append round r's metrics as device scalars (read back once, at the end)."""
    hist["round"].append(r)
    hist["train_loss"].append(metrics["train_loss"])
    if eval_fn is not None:
        hist["test_loss"].append(eval_fn(state.tree, eval_batch).mean())
    if track_sigmas:
        s = sigma_metrics(state.params)
        hist["sigma_ap"].append(s["sigma_ap"])
        hist["sigma_an"].append(s["sigma_an"])


def finish_history(hist: dict) -> dict[str, list]:
    """One device→host transfer per channel."""
    out = {"round": list(hist["round"])}
    for k in HISTORY_KEYS[1:]:
        out[k] = torch.stack(hist[k]).tolist() if hist[k] else []
    return out


def state_device(state: DFLState, device: str | torch.device | None) -> torch.device:
    """The state's device, checked against the caller's (default cuda)."""
    want = resolve_device(device)
    have = state.params.device
    if have.type != want.type or (want.index is not None and want.index != have.index):
        raise ValueError(f"the state lies on {have} but the run was asked for {want}")
    return have


def train_loop(
    state: DFLState,
    round_fn,
    batches: Iterable[Any],
    n_rounds: int,
    eval_every: int = 0,
    eval_fn=None,
    eval_batch=None,
    track_sigmas: bool = False,
    device: str | torch.device | None = None,
) -> tuple[DFLState, dict[str, list]]:
    """Host-fed loop: ``batches`` yields each round's numpy (x, y) of
    shapes (n, b, bs, ...) and (n, b, bs).  ``run_trajectory`` is the
    schedule-gathering equivalent (same results for the same batches).
    Metrics are recorded at rounds ``r % eval_every == 0`` and the last."""
    dev = state_device(state, device)
    state = copy_state(state)
    eval_d = None if eval_batch is None else tuple(torch.as_tensor(a, device=dev) for a in eval_batch)
    hist: dict[str, list] = {k: [] for k in HISTORY_KEYS}
    for r in range(n_rounds):
        bx, by = next(batches)
        node_batches = (torch.as_tensor(bx, device=dev), torch.as_tensor(by, device=dev))
        state, metrics = round_fn(state, node_batches)
        if eval_every and (r % eval_every == 0 or r == n_rounds - 1):
            record_round(hist, r, state, metrics, eval_fn, eval_d, track_sigmas)
    return state, finish_history(hist)
