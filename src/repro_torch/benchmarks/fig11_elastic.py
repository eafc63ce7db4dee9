"""Figure 11: elastic membership and fault injection, recovery curves and
the cost of preemption safety (counterpart of ``benchmarks/fig11_elastic.py``).

Membership is a per-round mask over a static node envelope (nodes join,
leave, crash and come back), seeded fault scenarios (``core.faults``) AND
into the same masks, and chunk-boundary checkpoints make a trajectory
survive a kill.  Three measurements:

* **recovery curves**: for a correlated crash burst, a degree-targeted hub
  outage and a mid-run cohort join, the test loss and the live population
  a recorded round against the uninterrupted run:
  ``delta_vs_uninterrupted`` at the horizon and ``rounds_to_recover``
  (the first post-fault round whose test loss is back within 10% of the
  baseline's);
* **checkpoint overhead**: a durable save and a restore of a trajectory's
  carry at n = 64 against the wall of one 48-round chunk
  (``overhead_ratio``, budgeted at ≤ 10%);
* **resume parity**: a checkpointed elastic run and one given
  ``resume_from`` must end bit-identically (``parity_bitexact``).

Quick sizes as the JAX driver's: n = 32 (kreg8, 40 rounds, 64 items a
node, hidden (64, 32)); the overhead record at n = 64, 96 rounds in chunks
of 48; the parity record at n = 16, 12 rounds.  Writes ``{device,
cpu_count, quick, records: [...]}`` with ``BENCH_elastic.json``'s record
keys to ``out_path``, by default ``build/fig11_elastic.json``, and prints
its rows through ``emit``.

Run:  python -m repro_torch.benchmarks.fig11_elastic [--device cpu]
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import restore_train_state, save_train_state
from repro_torch.core import topology as T
from repro_torch.core.commplan import compile_plan
from repro_torch.core.faults import crash_burst, hub_outage
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.core.membership import membership_schedule
from repro_torch.data import batch_index_schedule, mnist_like, node_datasets
from repro_torch.device import resolve_device
from repro_torch.fed import (
    CheckpointPolicy,
    init_fl_state,
    make_eval_fn,
    make_round_fn,
    run_elastic_trajectory,
    run_trajectory,
)
from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
from repro_torch.optim import sgd

from .common import driver_main, emit

BS, B_LOCAL = 16, 2


def _setup(n, per_node, hidden, seed=0):
    graph = T.random_k_regular(n, 8, seed=seed)
    ds = mnist_like(n * per_node + 512, seed=seed)
    parts = [np.arange(i * per_node, (i + 1) * per_node) for i in range(n)]
    xs, ys = node_datasets(ds, parts)
    test = (ds.x[-512:], ds.y[-512:])

    def loss_fn(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    def init_one(g, gains):
        return init_mlp(InitConfig("he_normal", gains), g, hidden=hidden)

    return graph, xs, ys, test, loss_fn, sgd(1e-3, 0.5), gain_from_graph(graph), init_one


def _elastic(graph, setup, mem, faults, rounds, eval_every, dev):
    _, xs, ys, test, loss_fn, opt, gain, init_one = setup
    sched = batch_index_schedule(xs.shape[1], graph.n, BS, rounds * B_LOCAL, seed=0)
    state = init_fl_state(0, graph.n, init_one, opt, gains=gain, device=dev)
    t0 = time.perf_counter()
    _, hist, _ = run_elastic_trajectory(
        state, loss_fn, opt, compile_plan(graph, device=dev), mem, xs, ys, sched,
        n_rounds=rounds, eval_every=eval_every, eval_fn=make_eval_fn(loss_fn), eval_batch=test, b_local=B_LOCAL,
        init_one=init_one, faults=faults, device=dev,
    )
    # the history is read back from the device at the end: the clock stops after the run
    return hist, (time.perf_counter() - t0) / rounds


def _recovery(hist, base_hist, fault_end):
    """First recorded post-fault round whose test loss is back within 10%
    of the uninterrupted baseline's at the same round; -1.0 if never."""
    for r, loss, ref in zip(hist["round"], hist["test_loss"], base_hist["test_loss"]):
        if r >= fault_end and loss <= ref * 1.10:
            return float(r - fault_end)
    return -1.0


def _scenario_records(n, rounds, per_node, hidden, dev):
    setup = _setup(n, per_node, hidden)
    graph = setup[0]
    eval_every = max(rounds // 20, 1)
    trivial = membership_schedule(n, rounds)
    at, dur = rounds // 3, max(rounds // 10, 1)

    cohort = list(range(n - n // 8, n))
    scenarios = {
        "none": (trivial, None),
        "crash": (trivial, crash_burst(graph, rounds, at=at, size=n // 8, duration=dur, seed=0)),
        "hub": (trivial, hub_outage(graph, rounds, at=at, duration=dur, k=max(n // 16, 1))),
        "join": (membership_schedule(n, rounds, initial=n - n // 8, arrivals={at: cohort}, join_warmup=8), None),
    }
    records, base_hist = [], None
    for name, (mem, faults) in scenarios.items():
        hist, spr = _elastic(graph, setup, mem, faults, rounds, eval_every, dev)
        if name == "none":
            base_hist = hist
        fault_end = at + dur if faults is not None else at + mem.join_warmup
        rec = {
            "scenario": name,
            "n": n,
            "rounds": rounds,
            "final_test_loss": hist["test_loss"][-1],
            "delta_vs_uninterrupted": hist["test_loss"][-1] - base_hist["test_loss"][-1],
            "rounds_to_recover": 0.0 if name == "none" else _recovery(hist, base_hist, fault_end),
            "sec_per_round": spr,
            "curve_round": hist["round"],
            "curve_test_loss": hist["test_loss"],
            "curve_n_active": hist["n_active"],
        }
        records.append(rec)
        emit(
            f"fig11.{name}.n{n}",
            spr * 1e6,
            f"final={rec['final_test_loss']:.3f};delta={rec['delta_vs_uninterrupted']:+.3f};"
            f"recover={rec['rounds_to_recover']:.0f};min_active={min(hist['n_active'])}",
        )
    return records


def _ckpt_overhead_record(n, rounds, per_node, hidden, chunk_size, dev):
    """A durable save and a restore of a trajectory's carry against the
    wall of one chunk."""
    setup = _setup(n, per_node, hidden)
    graph, xs, ys, test, loss_fn, opt, gain, init_one = setup
    sched = batch_index_schedule(per_node, n, BS, rounds * B_LOCAL, seed=0)
    rf = make_round_fn(loss_fn, opt, compile_plan(graph, device=dev))
    kw = dict(n_rounds=rounds, eval_every=max(rounds // 4, 1), eval_fn=make_eval_fn(loss_fn), eval_batch=test,
              chunk_size=chunk_size, b_local=B_LOCAL, device=dev)
    state = init_fl_state(0, n, init_one, opt, gains=gain, device=dev)
    run_trajectory(state, rf, xs, ys, sched, **kw)  # first use: the JAX driver's compile run
    t0 = time.perf_counter()
    final, _ = run_trajectory(state, rf, xs, ys, sched, **kw)
    n_chunks = -(-rounds // chunk_size)
    sec_per_chunk = (time.perf_counter() - t0) / n_chunks

    # the carry the executor saves: params, optimizer state, round, generator state
    payload = {
        "carry": {"params": final.params, "opt_state": tuple(final.opt_state),
                  "round": torch.tensor(final.round), "generator": final.generator.get_state()},
        "outs": [],
    }
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        for s in range(3):
            save_train_state(d, s, payload, meta={"chunk": s}, keep_last=2)
        save_s = (time.perf_counter() - t0) / 3
        t0 = time.perf_counter()
        for _ in range(3):
            restore_train_state(d)
        restore_s = (time.perf_counter() - t0) / 3
    ckpt_bytes = sum(t.numel() * t.element_size() for t in (final.params, *final.opt_state, payload["carry"]["round"],
                                                             payload["carry"]["generator"]))
    rec = {
        "scenario": "ckpt-overhead",
        "n": n,
        "rounds": rounds,
        "chunk_rounds": chunk_size,
        "ckpt_bytes": ckpt_bytes,
        "save_ms": save_s * 1e3,
        "restore_ms": restore_s * 1e3,
        "sec_per_chunk": sec_per_chunk,
        "overhead_ratio": save_s / sec_per_chunk,
    }
    emit(
        f"fig11.ckpt.n{n}",
        save_s * 1e6,
        f"save={rec['save_ms']:.1f}ms;restore={rec['restore_ms']:.1f}ms;chunk={sec_per_chunk:.2f}s;"
        f"overhead={rec['overhead_ratio'] * 100:.1f}%",
    )
    return rec


def _resume_parity_record(n, rounds, per_node, hidden, dev):
    """A checkpointed elastic run, then one given ``resume_from``, against
    the uninterrupted run, bitwise."""
    setup = _setup(n, per_node, hidden)
    graph, xs, ys, _, loss_fn, opt, gain, init_one = setup
    sched = batch_index_schedule(per_node, n, BS, rounds * B_LOCAL, seed=0)
    plan = compile_plan(graph, device=dev)
    mem = membership_schedule(n, rounds, initial=n - 2, arrivals={1: [n - 2, n - 1]}, join_warmup=3)
    kw = dict(n_rounds=rounds, eval_every=2, chunk_size=max(rounds // 3, 1), b_local=B_LOCAL, init_one=init_one,
              device=dev)

    s0 = init_fl_state(1, n, init_one, opt, gains=gain, device=dev)
    ref, h_ref, _ = run_elastic_trajectory(s0, loss_fn, opt, plan, mem, xs, ys, sched, **kw)
    with tempfile.TemporaryDirectory() as d:
        s1 = init_fl_state(1, n, init_one, opt, gains=gain, device=dev)
        run_elastic_trajectory(s1, loss_fn, opt, plan, mem, xs, ys, sched, checkpoint=CheckpointPolicy(d, every=1),
                               **kw)
        s2 = init_fl_state(1, n, init_one, opt, gains=gain, device=dev)
        # the JAX driver passes the step *file*: a path with no LATEST, so
        # this run starts fresh and the record compares two whole runs (the
        # resume from the directory is held by the port's tests)
        got, h_got, _ = run_elastic_trajectory(
            s2, loss_fn, opt, plan, mem, xs, ys, sched,
            resume_from=str(pathlib.Path(d) / "step_00000000.ckpt"), **kw,
        )
    bit = (torch.equal(ref.params, got.params) and all(torch.equal(a, b) for a, b in zip(ref.opt_state, got.opt_state))
           and h_ref == h_got)
    rec = {"scenario": "resume-parity", "n": n, "rounds": rounds, "parity_bitexact": bool(bit)}
    emit(f"fig11.resume.n{n}", 0.0, f"bitexact={bit}")
    return rec


def run(quick: bool = True, device=None, out_path: str | pathlib.Path = "build/fig11_elastic.json") -> dict:
    dev = resolve_device(device)
    n = 32 if quick else 64
    rounds = 40 if quick else 120
    per_node = 64 if quick else 128
    hidden = (64, 32) if quick else (128, 64)

    records = _scenario_records(n, rounds, per_node, hidden, dev)
    # overhead is save cost over a chunk's wall, so the chunking matters as
    # much as the model: one durable write a 48-round chunk
    records.append(_ckpt_overhead_record(64, 96, 64, (128, 64), chunk_size=48, dev=dev))
    records.append(_resume_parity_record(16, 12, 32, (32,), dev))

    result = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "cpu_count": os.cpu_count(),
        "quick": quick,
        "records": records,
    }
    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"# wrote {out}", flush=True)
    return result


main = driver_main(run, __doc__)

if __name__ == "__main__":
    main()
