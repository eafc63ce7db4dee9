"""Figure 9: synchronous against event-driven gossip, convergence per
message (counterpart of ``benchmarks/fig9_async.py``).

The uncoordinated setting has no global round barrier: per-edge Poisson
clocks, realised on the host into an ``EventStream``, replace it, and the
event executor (``run_event_trajectory``) runs one pairwise exchange each
time a clock fires.  At an equal transmitted-message budget, does the
barrier matter?

* Per family (ring / k-regular / BA) and size, R synchronous rounds
  (2·|E| messages a round) against rate-1 clocks over horizon R: the same
  expected message budget, from the same gain-corrected init.
* ``final_test_loss_*`` at the matched budget, the event executor's cost
  (``us_per_event``, its steady part through ``ChunkTimer``) and the mean
  staleness the virtual clocks measure.

Quick sizes n ∈ {16, 32} (30 rounds, 64 items a node), full n ∈ {64, 256}
(60 rounds, 128 items).  Writes ``{device, cpu_count, quick, records:
[{family, n, horizon, messages_sync, messages_event, final_test_loss_sync,
final_test_loss_event, us_per_event, sec_per_round_sync, ...}]}`` (the JAX
package's fig9 schema, ``BENCH_async.json``'s keys) to ``out_path``, by default
``build/fig9_async.json``, and prints its rows through ``emit``.

Run:  python -m repro_torch.benchmarks.fig9_async [--device cpu]
"""
from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import torch

from repro_torch.core import topology as T
from repro_torch.device import resolve_device

from .common import driver_main, emit, run_dfl_mlp, run_dfl_mlp_async

FAMILIES = {
    "ring": lambda n, seed: T.ring(n),
    "kreg": lambda n, seed: T.random_k_regular(n, 8, seed=seed),
    "ba": lambda n, seed: T.barabasi_albert(n, 4, seed=seed),
}


def run(quick: bool = True, device=None, out_path: str | pathlib.Path = "build/fig9_async.json") -> dict:
    dev = resolve_device(device)
    sizes = (16, 32) if quick else (64, 256)
    rounds = 30 if quick else 60
    per_node = 64 if quick else 128
    records = []

    for family, build in FAMILIES.items():
        for n in sizes:
            graph = build(n, 0)
            m = graph.n_edges
            hist_sync, t_sync = run_dfl_mlp(
                n_nodes=n, graph=graph, rounds=rounds, per_node=per_node,
                eval_every=max(rounds // 10, 1), timing=True, device=dev,
            )
            hist_ev, t_ev, stream = run_dfl_mlp_async(
                n_nodes=n, graph=graph, horizon=float(rounds), rate=1.0,
                per_node=per_node, n_bins=10, timing=True, device=dev,
            )
            rec = {
                "family": family,
                "n": n,
                "horizon": rounds,
                "n_edges": m,
                "n_events": stream.n_events,
                "messages_sync": 2 * m * rounds,
                "messages_event": 2 * stream.n_events,
                "final_test_loss_sync": hist_sync["test_loss"][-1],
                "final_test_loss_event": hist_ev["test_loss"][-1],
                "mean_staleness": float(np.mean(hist_ev["staleness"])),
                "us_per_event": t_ev["sec_per_event"] * 1e6,
                "us_per_event_steady": t_ev["us_per_event_steady"],
                "compile_seconds_event": t_ev["compile_seconds"],
                "sec_per_round_sync": t_sync["sec_per_round"],
                "us_per_round_steady_sync": t_sync["us_per_round_steady"],
                "compile_seconds_sync": t_sync["compile_seconds"],
                # bytes on the wire: a clean synchronous plan's are the same
                # every round; the event total sums the delivered exchanges
                "wire_bytes_per_round_sync": hist_sync["wire_bytes"][0],
                "wire_bytes_event_total": int(sum(hist_ev["wire_bytes"])),
            }
            records.append(rec)
            emit(
                f"fig9.{family}.n{n}",
                rec["us_per_event"],
                f"event={rec['final_test_loss_event']:.3f};"
                f"sync={rec['final_test_loss_sync']:.3f};"
                f"msgs={rec['messages_event']};"
                f"stale={rec['mean_staleness']:.2f}",
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
