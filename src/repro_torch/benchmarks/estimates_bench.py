"""Gossip estimation throughput (counterpart of ``benchmarks/estimates_bench.py``).

Times the two warmup protocols of ``repro_torch.gossip``, push-sum and the
power-iteration ‖v_steady‖ estimator, as blocks of 64 rounds over family ×
n on the dense and sparse ``CommPlan`` backends: on the card one mixing
kernel launch a round, at a payload of 2 columns (push-sum of the degrees
and its weight) and 3 (the moments, the one-hot, the weight).  The
estimation phase precedes every uncoordinated training run, so its time a
round is what a user pays before the first training round.  Best of 3
blocks, host clock after a device sync.

Writes ``{device, quick, rounds_block, records: [{family, n, n_edges,
us_dense, us_sparse, us_pi_dense, us_pi_sparse, sparse_speedup_vs_dense}]}``
(µs per gossip round) to ``out_path``, by default
``build/estimates_bench.json``, and prints its rows through ``emit``.

Run:  python -m repro_torch.benchmarks.estimates_bench [--device cpu]
"""
from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.core import topology as T
from repro_torch.core.commplan import compile_plan
from repro_torch.device import resolve_device
from repro_torch.gossip import power_iteration_norm, push_sum

from .common import driver_main, emit

FAMILIES = {
    "ring": lambda n: T.ring(n),
    "kreg": lambda n: T.random_k_regular(n, 4, seed=0),
    "ba": lambda n: T.barabasi_albert(n, 4, seed=0),
    "heavytail": lambda n: T.configuration_heavy_tail(n, 2.2, seed=0),
}

BLOCK = 64  # rounds a timed block


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_of(fn, dev: torch.device, iters: int = 3) -> float:
    fn()  # warm: kernel libraries, allocator
    _sync(dev)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def run(
    quick: bool = True,
    ns=None,
    out_path: str | pathlib.Path = "build/estimates_bench.json",
    device=None,
) -> dict:
    dev = resolve_device(device)
    ns = ns if ns is not None else ((16, 64, 256) if quick else (16, 64, 256, 1024))
    records = []
    for family, build in FAMILIES.items():
        for n in ns:
            g = build(n)
            vals = np.asarray(g.degrees, np.float32)
            row: dict = {"family": family, "n": n, "n_edges": g.n_edges, "rounds_block": BLOCK}
            for backend in ("dense", "sparse"):
                plan = compile_plan(g, backend, device=dev)
                sec = _best_of(lambda: push_sum(plan, vals, BLOCK), dev)
                row[f"us_{backend}"] = sec / BLOCK * 1e6
                emit(f"estimates.push_sum.{backend}", sec / BLOCK * 1e6,
                     f"family={family};n={n};rounds_per_sec={BLOCK / sec:.0f}")
                sec_pi = _best_of(lambda: power_iteration_norm(plan, BLOCK // 2, BLOCK // 2), dev)
                row[f"us_pi_{backend}"] = sec_pi / BLOCK * 1e6
                emit(f"estimates.power_iter.{backend}", sec_pi / BLOCK * 1e6,
                     f"family={family};n={n};rounds_per_sec={BLOCK / sec_pi:.0f}")
            row["sparse_speedup_vs_dense"] = row["us_dense"] / row["us_sparse"]
            records.append(row)
    result = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "quick": quick,
        "rounds_block": BLOCK,
        "records": records,
    }
    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return result


main = driver_main(run, __doc__)

if __name__ == "__main__":
    main()
