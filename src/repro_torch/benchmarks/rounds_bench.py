"""Round-loop benchmark: the host-fed loop against the executor
(counterpart of ``benchmarks/rounds_bench.py``).

Whole training trajectories of the fig1 quick configuration, three
renderings a system size:

* ``legacy``   — ``train_loop``: batches assembled on the host each round.
* ``executor`` — ``run_trajectory``: the dataset and the batch schedule
                 uploaded once, each round's batches gathered on the device.
* ``sweep``    — fig1's workload, the {He, corrected} pair through
                 ``run_sweep`` over one upload, against the two sequential
                 legacy runs.

and the sparse backend at n = 128 (quick; 256 in full), kreg8, through the
executor.  Each time is the best of 2 runs, from the runner's own clock
(data synthesis and state init left out).

Writes ``{device, cpu_count, quick, records: [{config, n_nodes, rounds,
sec_legacy, sec_executor, speedup, ...}]}`` (the JAX driver's schema) to
``out_path``, by default ``build/rounds_bench.json``, and prints its rows
through ``emit``.

Run:  python -m repro_torch.benchmarks.rounds_bench [--device cpu]
(``run(rounds=)`` shortens every trajectory, as a smoke check does.)
"""
from __future__ import annotations

import json
import os
import pathlib

import torch

from repro_torch.core import topology as T
from repro_torch.core.initialisation import gain_from_graph
from repro_torch.device import resolve_device

from .common import driver_main, emit, run_dfl_mlp, run_dfl_mlp_sweep


def _best_of(fn, reps: int):
    """(best trajectory seconds, last history) of a runner returning
    (history, trajectory seconds)."""
    best, hist = float("inf"), None
    for _ in range(reps):
        hist, sec = fn()
        best = min(best, sec)
    return best, hist


def run(quick: bool = True, device=None, out_path: str | pathlib.Path = "build/rounds_bench.json",
        rounds: int | None = None) -> dict:
    """``rounds``: the trajectories' length (default 400 quick, 1000 full;
    the kreg8 run takes half)."""
    dev = resolve_device(device)
    rounds = rounds or (400 if quick else 1000)
    reps = 2
    records = []

    for n in ([8, 16, 32] if quick else [8, 16, 32, 64]):
        cfg = dict(n_nodes=n, rounds=rounds, eval_every=4, device=dev)

        def one(executor, gain=None):
            hist, spr = run_dfl_mlp(executor=executor, gain=gain, **cfg)
            return hist, spr * rounds

        s_ex, hist_ex = _best_of(lambda: one(True), reps)
        s_lg, hist_lg = _best_of(lambda: one(False), reps)  # the corrected gain
        s_lg_he, _ = _best_of(lambda: one(False, gain=1.0), reps)

        # fig1's per-n workload: both inits; legacy = the two runs timed
        # above, one after the other; executor = the pair through one sweep
        gains = [1.0, gain_from_graph(T.complete(n))]

        def pair_sweep():
            _, sec_per_run = run_dfl_mlp_sweep(n_nodes=n, gains=gains, rounds=rounds, eval_every=4, device=dev)
            return None, sec_per_run * len(gains)

        s_pair_lg = s_lg + s_lg_he
        s_pair_ex, _ = _best_of(pair_sweep, reps)
        rec = {
            "config": f"fig1_quick_n{n}",
            "n_nodes": n,
            "rounds": rounds,
            "sec_legacy": s_lg,
            "sec_executor": s_ex,
            "speedup": s_lg / s_ex,
            "sec_fig1_pair_legacy": s_pair_lg,
            "sec_fig1_pair_sweep": s_pair_ex,
            "speedup_fig1_pair": s_pair_lg / s_pair_ex,
            "final_test_loss_legacy": hist_lg["test_loss"][-1],
            "final_test_loss_executor": hist_ex["test_loss"][-1],
        }
        records.append(rec)
        emit(
            f"rounds.fig1_n{n}",
            s_ex / rounds * 1e6,
            f"speedup={rec['speedup']:.1f}x;pair_speedup={rec['speedup_fig1_pair']:.1f}x;"
            f"sec_legacy={s_lg:.1f};sec_executor={s_ex:.1f}",
        )

    # the sparse backend at scale
    n_big = 128 if quick else 256
    big_rounds = rounds // 2
    g = T.random_k_regular(n_big, 8, seed=0)

    def big():
        hist, spr = run_dfl_mlp(executor=True, n_nodes=n_big, graph=g, rounds=big_rounds, eval_every=8,
                                track_sigmas=True, device=dev)
        return hist, spr * big_rounds

    s_big, hist_big = _best_of(big, 1)
    records.append({
        "config": f"kreg8_n{n_big}",
        "n_nodes": n_big,
        "rounds": big_rounds,
        "sec_executor": s_big,
        "sec_per_round": s_big / big_rounds,
        "final_test_loss_executor": hist_big["test_loss"][-1],
    })
    emit(f"rounds.kreg8_n{n_big}", s_big / big_rounds * 1e6,
         f"sec_total={s_big:.1f};final={hist_big['test_loss'][-1]:.3f}")
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
