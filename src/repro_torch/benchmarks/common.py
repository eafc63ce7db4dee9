"""Shared DFL experiment runner for the figure drivers (counterpart of ``benchmarks/common.py``).

The drivers reproduce each figure's claim at small scale (n ≤ 64, the
paper's MLP on MNIST-like synthetic data, a few hundred rounds) and print
``name,us_per_call,derived`` CSV rows through ``emit``.  Runs go on ``cuda``
unless the caller passes ``device="cpu"``.

``run_dfl_mlp_uncoordinated(_sweep)`` run the §4.4 warmup (gossip
estimate → per-node init → train) through ``run_warmup_trajectory`` /
``run_warmup_sweep``.  ``plan`` may be a compiled ``CommPlan`` or a
time-varying ``PlanSchedule`` (fig8's churned runs).
``run_dfl_mlp(timing=True)`` splits a run's time with ``ChunkTimer`` on the
executor's chunk hook: the first chunk's warm-up against the steady
per-round cost.  ``run_dfl_mlp_async`` is one event-driven run
(``run_event_trajectory``, fig9), split the same way per event.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import topology as T
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.data import batch_index_schedule, mnist_like, node_batch_iterator, node_datasets
from repro_torch.device import resolve_device
from repro_torch.core.commplan import FailureModel, compile_plan
from repro_torch.fed import (
    init_fl_state,
    make_eval_fn,
    make_round_fn,
    run_event_trajectory,
    run_sweep,
    run_trajectory,
    run_warmup_sweep,
    run_warmup_trajectory,
    train_loop,
)
from repro_torch.fed.trainer import _local_steps
from repro_torch.gossip import make_gain_estimator
from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
from repro_torch.optim import adamw, sgd

__all__ = [
    "ROWS",
    "ChunkTimer",
    "driver_main",
    "emit",
    "rounds_to_loss",
    "run_dfl_mlp",
    "run_dfl_mlp_async",
    "run_dfl_mlp_sweep",
    "run_dfl_mlp_uncoordinated",
    "run_dfl_mlp_uncoordinated_sweep",
]

ROWS: list[str] = []


def emit(name: str, us_per_call: float, derived: str) -> None:
    row = f"{name},{us_per_call:.1f},{derived}"
    ROWS.append(row)
    print(row, flush=True)


class ChunkTimer:
    """Wall clock per executor chunk, through ``run_trajectory``'s
    ``on_chunk`` hook, which fires after the device has finished the chunk.

    It separates the first chunk's warm-up from the steady per-round cost:
    on the card that warm-up is the first use of everything the run
    touches, a first-use kernel build (nvcc, when the libraries are not
    built yet) and the caching allocator's first allocations included,
    where the JAX package's is its jit compile.  ``split()`` returns
    ``(compile_seconds, steady_sec_per_item)``: compile is the first
    chunk's wall minus its steady prediction, clamped at 0; a one-chunk run
    cannot separate them and reports compile 0.
    """

    def __init__(self):
        self.t0 = time.perf_counter()
        self.walls: list[float] = []
        self.sizes: list[int] = []

    def __call__(self, r0: int, r1: int, chunk_hist: dict):
        now = time.perf_counter()
        self.walls.append(now - self.t0)
        self.sizes.append(int(r1) - int(r0))
        self.t0 = now

    def split(self) -> tuple[float, float]:
        if not self.walls:
            return 0.0, 0.0
        full = self.sizes[0]
        # a trailing short chunk is left out (the JAX executor recompiles it)
        steady_samples = [w / s for w, s in zip(self.walls[1:], self.sizes[1:]) if s == full]
        if not steady_samples:
            return 0.0, self.walls[0] / max(full, 1)
        steady = float(np.median(steady_samples))
        return max(self.walls[0] - steady * full, 0.0), steady


def _mlp_setup(n_nodes, graph, per_node, hidden, optimizer, seed, test_size):
    """Shared dataset/model/optimizer setup for the MLP runs."""
    graph = graph if graph is not None else T.complete(n_nodes)
    ds = mnist_like(n_nodes * per_node + test_size, seed=seed)
    parts = [np.arange(i * per_node, (i + 1) * per_node) for i in range(n_nodes)]
    xs, ys = node_datasets(ds, parts)
    test = (ds.x[-test_size:], ds.y[-test_size:])

    def loss_fn(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    opt = sgd(1e-3, 0.5) if optimizer == "sgd" else adamw(1e-3)

    def init_one(g, gains):
        return init_mlp(InitConfig("he_normal", gains), g, hidden=hidden)

    return graph, xs, ys, test, loss_fn, opt, make_eval_fn(loss_fn), init_one


def _isolated_round_fn(loss_fn, optimizer):
    """The JAX ``make_round_fn(aggregate=False)`` at n = 1: local steps only.
    With no aggregation there is no optimizer re-initialisation either
    (Algorithm 1 line 15 follows an aggregation), so momentum carries over
    from round to round, as in the JAX package."""

    def round_fn(state, node_batches):
        params, opt_state, losses = _local_steps(
            loss_fn, optimizer, state.layout, state.params, state.opt_state, node_batches
        )
        new_state = dataclasses.replace(state, params=params, opt_state=opt_state, round=state.round + 1)
        return new_state, {"train_loss": losses.mean(), "train_loss_per_node": losses}

    round_fn.compression = None
    return round_fn


def _host_batches(xs, ys, batch_size, b_local, seed):
    """The per-round (x (n, b, bs, ...), y (n, b, bs)) the host iterator yields."""
    it = node_batch_iterator(xs, ys, batch_size, seed=seed)
    while True:
        bs = [next(it) for _ in range(b_local)]
        yield np.stack([b.x for b in bs], axis=1), np.stack([b.y for b in bs], axis=1)


def run_dfl_mlp(
    *,
    n_nodes: int,
    graph=None,
    plan=None,
    gain: float | None = None,
    rounds: int = 60,
    per_node: int = 128,
    batch_size: int = 16,
    b_local: int = 2,
    hidden=(128, 64),
    optimizer="sgd",
    link_p: float = 1.0,
    node_p: float = 1.0,
    eval_every: int = 5,
    seed: int = 0,
    track_sigmas: bool = False,
    aggregate: bool = True,
    test_size: int = 512,
    executor: bool = True,
    timing: bool = False,
    compression=None,
    device: str | torch.device | None = None,
):
    """One DFL run of the paper's MLP config on MNIST-like data; returns
    (history, seconds_per_round).

    Runs through ``run_trajectory`` by default; ``executor=False`` takes the
    host-fed ``train_loop``.  ``plan`` overrides the mixing operator (a
    compiled ``CommPlan`` or a ``PlanSchedule``; ``link_p`` / ``node_p``
    override its failure model when given) while ``graph`` keeps describing
    the gain anchor.  ``aggregate=False`` (an isolated node, Fig. 7's
    centralised reference) is accepted at ``n_nodes == 1`` only.  With
    ``timing=True`` (the executor only) the run goes in 8 chunks and the
    second element is a dict: ``sec_per_round`` and ``ChunkTimer``'s
    ``compile_seconds`` and ``us_per_round_steady``.
    """
    if timing and not executor:
        raise ValueError("the timing split needs the executor's chunk hook (executor=True)")
    if not aggregate and n_nodes != 1:
        raise ValueError(f"aggregate=False runs an isolated node: n_nodes must be 1, got {n_nodes}")
    dev = resolve_device(device)
    graph, xs, ys, test, loss_fn, opt, eval_fn, init_one = _mlp_setup(
        n_nodes, graph, per_node, hidden, optimizer, seed, test_size
    )
    gain = gain if gain is not None else gain_from_graph(graph)
    state = init_fl_state(seed, n_nodes, init_one, opt, gains=gain, device=dev)
    if not aggregate:
        rf = _isolated_round_fn(loss_fn, opt)
    elif plan is not None:
        rf = make_round_fn(loss_fn, opt, plan, link_p=link_p, node_p=node_p, compression=compression)
    else:
        rf = make_round_fn(loss_fn, opt, graph, link_p=link_p, node_p=node_p, device=dev, compression=compression)

    common = dict(eval_every=eval_every, eval_fn=eval_fn, eval_batch=test, track_sigmas=track_sigmas, device=dev)
    t0 = time.perf_counter()
    timer = ChunkTimer() if timing else None
    if executor:
        sched = batch_index_schedule(per_node, n_nodes, batch_size, rounds * b_local, seed=seed)
        state, hist = run_trajectory(state, rf, xs, ys, sched, n_rounds=rounds, b_local=b_local,
                                     chunk_size=max(rounds // 8, 1) if timing else 0, on_chunk=timer, **common)
    else:
        state, hist = train_loop(state, rf, _host_batches(xs, ys, batch_size, b_local, seed), n_rounds=rounds, **common)
    # the history is read back from the device at the end: the clock stops after the run
    sec_per_round = (time.perf_counter() - t0) / rounds
    if timing:
        compile_s, steady = timer.split()
        return hist, {"sec_per_round": sec_per_round, "compile_seconds": compile_s,
                      "us_per_round_steady": steady * 1e6}
    return hist, sec_per_round


def run_dfl_mlp_async(
    *,
    n_nodes: int,
    horizon: float,
    rate: float = 1.0,
    graph=None,
    gain: float | None = None,
    per_node: int = 128,
    batch_size: int = 16,
    b_local: int = 2,
    hidden=(128, 64),
    optimizer="sgd",
    n_bins: int = 10,
    link_p: float = 1.0,
    node_p: float = 1.0,
    seed: int = 0,
    test_size: int = 512,
    timing: bool = False,
    device: str | torch.device | None = None,
):
    """One event-driven DFL run of the paper's MLP config: per-edge Poisson
    clocks at ``rate`` over ``horizon`` units of virtual time, through
    ``run_event_trajectory``.  Rate 1 over ``horizon = R`` is the
    message-budget-matched peer of R synchronous rounds.  Returns (history,
    seconds_per_event, stream); with ``timing=True`` the run goes in 8
    chunks and the middle element is a dict: ``sec_per_event`` and
    ``ChunkTimer``'s ``compile_seconds`` and ``us_per_event_steady``."""
    dev = resolve_device(device)
    graph, xs, ys, test, loss_fn, opt, eval_fn, init_one = _mlp_setup(
        n_nodes, graph, per_node, hidden, optimizer, seed, test_size
    )
    gain = gain if gain is not None else gain_from_graph(graph)
    state = init_fl_state(seed, n_nodes, init_one, opt, gains=gain, device=dev)
    plan = compile_plan(graph, failures=FailureModel(link_p=link_p, node_p=node_p), device=dev)
    stream = T.poisson_event_stream(graph, horizon=horizon, rate=rate, seed=seed + 1)
    sched = batch_index_schedule(per_node, n_nodes, batch_size, max(int(horizon), 1) * b_local, seed=seed)
    t0 = time.perf_counter()
    timer = ChunkTimer() if timing else None
    _, hist, _ = run_event_trajectory(
        state, loss_fn, opt, plan, stream, xs, ys, sched, b_local=b_local, n_bins=n_bins, eval_fn=eval_fn,
        eval_batch=test, chunk_events=max(stream.n_events // 8, 1) if timing else 0,
        on_chunk=(lambda ci, i0, i1, acc: timer(i0, i1, acc)) if timing else None, device=dev,
    )
    # the history is read back from the device at the end: the clock stops after the run
    sec_per_event = (time.perf_counter() - t0) / max(stream.n_events, 1)
    if timing:
        compile_s, steady = timer.split()
        return hist, {"sec_per_event": sec_per_event, "compile_seconds": compile_s,
                      "us_per_event_steady": steady * 1e6}, stream
    return hist, sec_per_event, stream


def run_dfl_mlp_sweep(
    *,
    n_nodes: int,
    gains,
    seeds=(0,),
    graph=None,
    rounds: int = 60,
    per_node: int = 128,
    batch_size: int = 16,
    b_local: int = 2,
    hidden=(128, 64),
    optimizer="sgd",
    eval_every: int = 5,
    data_seed: int = 0,
    track_sigmas: bool = False,
    test_size: int = 512,
    device: str | torch.device | None = None,
):
    """The (gain × seed) grid of MLP trajectories over one dataset, topology
    and batch order, through ``run_sweep`` (one upload, the runs one after
    another).  Returns (histories, seconds_per_run) with ``histories[i][j]``
    the run of gains[i] × seeds[j]."""
    dev = resolve_device(device)
    graph, xs, ys, test, loss_fn, opt, eval_fn, init_one = _mlp_setup(
        n_nodes, graph, per_node, hidden, optimizer, data_seed, test_size
    )
    states = [init_fl_state(s, n_nodes, init_one, opt, gains=g, device=dev) for g in gains for s in seeds]
    rf = make_round_fn(loss_fn, opt, graph, device=dev)
    sched = batch_index_schedule(per_node, n_nodes, batch_size, rounds * b_local, seed=data_seed)
    t0 = time.perf_counter()
    _, hists = run_sweep(
        states, rf, xs, ys, sched, n_rounds=rounds, eval_every=eval_every, eval_fn=eval_fn,
        eval_batch=test, track_sigmas=track_sigmas, b_local=b_local, device=dev,
    )
    sec_per_run = (time.perf_counter() - t0) / len(states)
    grid = [[hists[i * len(seeds) + j] for j in range(len(seeds))] for i in range(len(gains))]
    return grid, sec_per_run


def run_dfl_mlp_uncoordinated(
    *,
    n_nodes: int,
    est_rounds: int,
    graph=None,
    plan=None,
    rounds: int = 60,
    per_node: int = 128,
    batch_size: int = 16,
    b_local: int = 2,
    hidden=(128, 64),
    optimizer="sgd",
    mode: str = "vnorm",
    leaderless: bool = False,
    eval_every: int = 5,
    seed: int = 0,
    test_size: int = 512,
    device: str | torch.device | None = None,
):
    """One uncoordinated DFL run: per-node gains from the gossip engine,
    ``est_rounds`` rounds each for the power-iteration and push-sum phases,
    then init and training through ``run_warmup_trajectory``.  ``plan`` (a
    compiled ``CommPlan`` or a ``PlanSchedule``, fig8's churned path)
    overrides the operator both phases ride.

    Returns (history, seconds_per_round, gains), ``gains`` the realised
    (n,) per-node vector.
    """
    dev = resolve_device(device)
    graph, xs, ys, test, loss_fn, opt, eval_fn, init_one = _mlp_setup(
        n_nodes, graph, per_node, hidden, optimizer, seed, test_size
    )
    estimate_fn = make_gain_estimator(
        plan if plan is not None else compile_plan(graph, device=dev),
        pi_rounds=est_rounds, ps_rounds=est_rounds, mode=mode, leaderless=leaderless,
    )
    rf = make_round_fn(loss_fn, opt, plan) if plan is not None else make_round_fn(loss_fn, opt, graph, device=dev)
    sched = batch_index_schedule(per_node, n_nodes, batch_size, rounds * b_local, seed=seed)
    t0 = time.perf_counter()
    _, hist, gains = run_warmup_trajectory(
        seed, rf, xs, ys, sched, n_nodes=n_nodes, init_one=init_one, optimizer=opt, estimate_gains=estimate_fn,
        n_rounds=rounds, eval_every=eval_every, eval_fn=eval_fn, eval_batch=test, b_local=b_local, device=dev,
    )
    return hist, (time.perf_counter() - t0) / rounds, gains


def run_dfl_mlp_uncoordinated_sweep(
    *,
    n_nodes: int,
    budgets,
    seeds=(0,),
    graph=None,
    plan=None,
    rounds: int = 60,
    per_node: int = 128,
    batch_size: int = 16,
    b_local: int = 2,
    hidden=(128, 64),
    optimizer="sgd",
    mode: str = "vnorm",
    leaderless: bool = False,
    eval_every: int = 5,
    data_seed: int = 0,
    test_size: int = 512,
    device: str | torch.device | None = None,
):
    """The (gossip budget × seed) grid of uncoordinated runs over one upload
    (fig4's sweep): one estimator built at the largest budget, each run
    ``budget`` rounds a phase (``run_warmup_sweep``).  Returns (grid,
    seconds_per_run), ``grid[i][j] = (history, gains)`` of budgets[i] ×
    seeds[j]."""
    dev = resolve_device(device)
    graph, xs, ys, test, loss_fn, opt, eval_fn, init_one = _mlp_setup(
        n_nodes, graph, per_node, hidden, optimizer, data_seed, test_size
    )
    max_b = int(max(budgets))
    estimate_fn = make_gain_estimator(
        plan if plan is not None else compile_plan(graph, device=dev),
        pi_rounds=max_b, ps_rounds=max_b, mode=mode, leaderless=leaderless,
    )
    rf = make_round_fn(loss_fn, opt, plan) if plan is not None else make_round_fn(loss_fn, opt, graph, device=dev)
    sched = batch_index_schedule(per_node, n_nodes, batch_size, rounds * b_local, seed=data_seed)
    run_seeds = [s for _b in budgets for s in seeds]
    t0 = time.perf_counter()
    _, hists, gains = run_warmup_sweep(
        run_seeds, rf, xs, ys, sched, n_nodes=n_nodes, init_one=init_one, optimizer=opt,
        estimate_gains=estimate_fn, budgets=[b for b in budgets for _s in seeds], n_rounds=rounds,
        eval_every=eval_every, eval_fn=eval_fn, eval_batch=test, b_local=b_local, device=dev,
    )
    sec_per_run = (time.perf_counter() - t0) / len(run_seeds)
    grid = [[(hists[i * len(seeds) + j], gains[i * len(seeds) + j]) for j in range(len(seeds))]
            for i in range(len(budgets))]
    return grid, sec_per_run


def rounds_to_loss(hist: dict, threshold: float) -> float:
    """First recorded round where mean test loss drops below threshold."""
    for r, l in zip(hist["round"], hist["test_loss"]):
        if l < threshold:
            return r
    return float("inf")


def driver_main(run: Callable[..., None], doc: str | None) -> Callable[[list[str] | None], None]:
    """The command line of a figure driver: its quick sizes, as the JAX
    driver's, on ``--device`` (default cuda)."""

    def main(argv: list[str] | None = None) -> None:
        p = argparse.ArgumentParser(description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        run(quick=True, device=p.parse_args(argv).device)

    return main
