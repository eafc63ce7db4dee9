"""Figure 13: live serving under gossip, the latency / staleness surface by
router (counterpart of ``benchmarks/fig13_serve.py``).

DFL never converges to one artifact: every node holds its own parameters.
Serving therefore routes each query to a *node*, and the router trades the
staleness of the answering parameters against locality and queueing.  For
each topology family and size, an interleaved train + serve run
(``fed.serve.run_serve_trajectory``: gossip and query events merged into
one envelope, no barrier) is swept over qps × router policy:

* ``uniform`` — any node, ignores both staleness and distance (baseline),
* ``local``   — always the home node (zero hops, whatever its clock says),
* ``consensus`` — argmin of staleness + weighted hops + weighted queue wait.

Per cell: served-query latency quantiles (virtual time, open-loop queueing
model), mean served staleness, mean hop distance, final train / test loss
(training is bitwise that of the plain event executor whatever the load)
and the per-event cost split by ``ChunkTimer`` into the first chunk's
warm-up and the steady part.

The run aborts unless the consensus router beats uniform on mean served
staleness at comparable (≤ 1.05×) p50 latency on at least one family.
Writes ``{device, cpu_count, quick, consensus_wins, records: [...]}`` (the
JAX package's fig13 schema, ``BENCH_serve.json``'s keys) to ``out_path``,
by default ``build/fig13_serve.json``, and prints its rows through ``emit``.

Run:  python -m repro_torch.benchmarks.fig13_serve [--device cpu]
"""
from __future__ import annotations

import json
import os
import pathlib
import time

import torch

from repro_torch.core import topology as T
from repro_torch.core.commplan import compile_plan
from repro_torch.core.initialisation import gain_from_graph
from repro_torch.data import batch_index_schedule
from repro_torch.device import resolve_device
from repro_torch.fed import init_fl_state
from repro_torch.fed.router import ROUTER_POLICIES, make_router, poisson_query_stream
from repro_torch.fed.serve import run_serve_trajectory, serve_summary

from .common import ChunkTimer, _mlp_setup, driver_main, emit

FAMILIES = {
    "ring": lambda n, seed: T.ring(n),
    "kreg": lambda n, seed: T.random_k_regular(n, 8, seed=seed),
}

SERVICE_TIME = 0.2
HOP_LATENCY = 0.05


def run(quick: bool = True, device=None, out_path: str | pathlib.Path = "build/fig13_serve.json") -> dict:
    dev = resolve_device(device)
    sizes = (16,) if quick else (16, 64)
    horizon = 30.0 if quick else 60.0
    qps_grid = (2.0, 8.0) if quick else (2.0, 8.0, 32.0)
    per_node = 64 if quick else 128
    b_local, batch_size, n_bins, seed = 2, 16, 10, 0
    records = []

    for family, build in FAMILIES.items():
        for n in sizes:
            graph, xs, ys, test, loss_fn, opt, eval_fn, init_one = _mlp_setup(
                n, build(n, 0), per_node, (128, 64), "sgd", seed, 512
            )
            state = init_fl_state(seed, n, init_one, opt, gains=gain_from_graph(graph), device=dev)
            plan = compile_plan(graph, device=dev)
            stream = T.poisson_event_stream(graph, horizon=horizon, rate=1.0, seed=seed + 1)
            sched = batch_index_schedule(per_node, n, batch_size, max(int(horizon), 1) * b_local, seed=seed)
            for qps in qps_grid:
                queries = poisson_query_stream(n, horizon, qps, seed=seed + 2)
                for router_name in ROUTER_POLICIES:
                    router = make_router(graph, router_name)
                    env = stream.envelope + queries.envelope
                    timer = ChunkTimer()
                    t0 = time.perf_counter()
                    _, hist, serve, _ = run_serve_trajectory(
                        state, loss_fn, opt, plan, stream, queries, router, xs, ys, sched, b_local=b_local,
                        n_bins=n_bins, eval_fn=eval_fn, eval_batch=test, service_time=SERVICE_TIME,
                        hop_latency=HOP_LATENCY, chunk_events=max(env // 8, 1),
                        on_chunk=lambda ci, i0, i1, acc, timer=timer: timer(i0, i1, acc), device=dev,
                    )
                    wall = time.perf_counter() - t0
                    compile_s, steady = timer.split()
                    summ = serve_summary(serve)
                    rec = {
                        "family": family,
                        "n": n,
                        "router": router_name,
                        "qps": qps,
                        "horizon": int(horizon),
                        "n_events": stream.n_events,
                        "n_queries": queries.n_queries,
                        "served": summ["served"],
                        "p50_latency": summ["p50_latency"],
                        "p95_latency": summ["p95_latency"],
                        "mean_latency": summ["mean_latency"],
                        "mean_staleness_served": summ["mean_staleness"],
                        "mean_hops": summ["mean_hops"],
                        "final_train_loss": float(hist["train_loss"][-1]),
                        "final_test_loss": float(hist["test_loss"][-1]),
                        "queries_per_wall_second": summ["served"] / max(wall, 1e-9),
                        "us_per_event_steady": steady * 1e6,
                        "compile_seconds": compile_s,
                    }
                    records.append(rec)
                    emit(
                        f"fig13.{family}.n{n}.{router_name}.qps{qps:g}",
                        rec["us_per_event_steady"],
                        f"p50={rec['p50_latency']:.3f};"
                        f"stale={rec['mean_staleness_served']:.3f};"
                        f"hops={rec['mean_hops']:.2f};"
                        f"test={rec['final_test_loss']:.3f}",
                    )

    # acceptance: the consensus router must dominate uniform on served-model
    # staleness at comparable p50 latency for at least one topology family
    cells: dict = {}
    for r in records:
        cells.setdefault((r["family"], r["n"]), {}).setdefault(r["qps"], {})[r["router"]] = r
    wins = []
    for (family, n), by_qps in cells.items():
        ok = all(
            c["consensus"]["mean_staleness_served"] < c["uniform"]["mean_staleness_served"]
            and c["consensus"]["p50_latency"] <= 1.05 * c["uniform"]["p50_latency"]
            for c in by_qps.values()
        )
        if ok:
            wins.append(f"{family}.n{n}")
    if not wins:
        raise AssertionError(
            "consensus router failed to beat uniform on staleness at equal p50 "
            "latency on every family — the router is not using the virtual clocks"
        )

    result = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "cpu_count": os.cpu_count(),
        "quick": quick,
        "consensus_wins": wins,
        "records": records,
    }
    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2))
    print(f"# wrote {out} (consensus wins on: {', '.join(wins)})", flush=True)
    return result


main = driver_main(run, __doc__)

if __name__ == "__main__":
    main()
