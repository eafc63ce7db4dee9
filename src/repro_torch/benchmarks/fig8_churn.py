"""Figure 8: DFL under topology churn, the ``PlanSchedule`` path end to end
(counterpart of ``benchmarks/fig8_churn.py``).

* **churn sweep** (family × churn rate): a Markov chain of edge up/down
  snapshots (``topology.churn_sequence``) compiled into one
  ``PlanSchedule`` and driven end to end: leaderless gossip estimation →
  per-node gains → init → training, the operator switching every
  ``PERIOD`` rounds.  The static run of the same family (a K = 1
  schedule) anchors the comparison.
* **envelope row**: the steady per-round cost of a K = 8 schedule against
  the static plan at n = 128 (quick; 256 in full) on the sparse backend,
  read through ``ChunkTimer``.  A schedule round picks its plan on the host
  and runs that plan's kernels, so the ratio should sit near 1; the JAX
  package's mark for its gathered envelope is ≤ 1.3×.

Writes ``{device, cpu_count, quick, records: [{family, n, k_plans, churn_rate,
rounds, sec_per_round_static, sec_per_round_schedule, overhead_vs_static,
...}]}`` (the JAX driver's schema) to ``out_path``, by default
``build/fig8_churn.json``, and prints its rows through ``emit``.

Run:  python -m repro_torch.benchmarks.fig8_churn [--device cpu]
"""
from __future__ import annotations

import json
import os
import pathlib

import torch

from repro_torch.core import topology as T
from repro_torch.core.commplan import compile_schedule, cyclic_map
from repro_torch.device import resolve_device

from .common import driver_main, emit, run_dfl_mlp, run_dfl_mlp_uncoordinated

FAMILIES = {
    "kreg": lambda n, seed: T.random_k_regular(n, 8, seed=seed),
    "ba": lambda n, seed: T.barabasi_albert(n, 4, seed=seed),
}

PERIOD = 2  # rounds each snapshot stays active


def _schedule(base, k_plans, rate, device, backend="sparse"):
    graphs = T.churn_sequence(base, k_plans, rate, seed=1)
    return compile_schedule(graphs, backend=backend, round_map=cyclic_map(PERIOD), device=device)


def run(quick: bool = True, device=None, out_path: str | pathlib.Path = "build/fig8_churn.json") -> dict:
    dev = resolve_device(device)
    n = 32 if quick else 64
    rounds = 40 if quick else 150
    k_plans = 4 if quick else 8
    est_rounds = 16 if quick else 32
    records = []

    for family, build in FAMILIES.items():
        base = build(n, 0)
        # static anchor: the same family through the same warmup path, K = 1
        hist_st, spr_st, gains_st = run_dfl_mlp_uncoordinated(
            n_nodes=n, graph=base, plan=_schedule(base, 1, 0.0, dev),
            est_rounds=est_rounds, rounds=rounds, leaderless=True, device=dev,
        )
        for rate in (0.05, 0.2):
            sched = _schedule(base, k_plans, rate, dev)
            hist, spr, gains = run_dfl_mlp_uncoordinated(
                n_nodes=n, graph=base, plan=sched,
                est_rounds=est_rounds, rounds=rounds, leaderless=True, device=dev,
            )
            rec = {
                "family": family,
                "n": n,
                "k_plans": k_plans,
                "churn_rate": rate,
                "rounds": rounds,
                "sec_per_round_static": spr_st,
                "sec_per_round_schedule": spr,
                "overhead_vs_static": spr / spr_st,
                "final_test_loss_static": hist_st["test_loss"][-1],
                "final_test_loss_schedule": hist["test_loss"][-1],
                "gain_mean": float(gains.mean()),
                "gain_spread": float(gains.max() - gains.min()),
            }
            records.append(rec)
            emit(
                f"fig8.{family}.churn{rate:g}",
                spr * 1e6,
                f"final={rec['final_test_loss_schedule']:.3f};"
                f"static={rec['final_test_loss_static']:.3f};"
                f"overhead={rec['overhead_vs_static']:.2f}x;"
                f"gain_mean={rec['gain_mean']:.2f}",
            )

    # ---- envelope row: what the schedule adds to a round, at scale
    n_big = 128 if quick else 256
    big_rounds = 20 if quick else 40
    base = T.random_k_regular(n_big, 8, seed=0)
    sched = _schedule(base, 8, 0.1, dev)

    def timed(plan):
        best = None
        for _ in range(2):
            _, t = run_dfl_mlp(
                n_nodes=n_big, graph=base, plan=plan, rounds=big_rounds,
                eval_every=0, per_node=64, timing=True, device=dev,
            )
            if best is None or t["us_per_round_steady"] < best["us_per_round_steady"]:
                best = t
        return best

    t_st = timed(None)  # the graph → the auto backend, sparse at this n
    t_sc = timed(sched)
    rec = {
        "family": "kreg",
        "n": n_big,
        "k_plans": 8,
        "churn_rate": 0.1,
        "rounds": big_rounds,
        "sec_per_round_static": t_st["sec_per_round"],
        "sec_per_round_schedule": t_sc["sec_per_round"],
        "us_per_round_steady_static": t_st["us_per_round_steady"],
        "us_per_round_steady_schedule": t_sc["us_per_round_steady"],
        "compile_seconds_static": t_st["compile_seconds"],
        "compile_seconds_schedule": t_sc["compile_seconds"],
        # the ratio of steady throughput: the walls fold the first chunk's
        # warm-up in
        "overhead_vs_static": t_sc["us_per_round_steady"] / t_st["us_per_round_steady"],
        "config": "envelope_sparse",
    }
    records.append(rec)
    emit(
        f"fig8.envelope_n{n_big}_k8",
        rec["us_per_round_steady_schedule"],
        f"overhead={rec['overhead_vs_static']:.2f}x;"
        f"static_us={rec['us_per_round_steady_static']:.0f};"
        f"schedule_us={rec['us_per_round_steady_schedule']:.0f};"
        f"compile_s={rec['compile_seconds_schedule']:.1f}",
    )
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
