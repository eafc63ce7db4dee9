"""Figure 10: weak scaling of the node-sharded DecAvg rendering
(counterpart of ``benchmarks/fig10_scaling.py``).

The sharded rendering (``core.shardplan``, DESIGN.md §15) partitions the FL
node axis contiguously over the ranks of a process group: a rank's rows of
the operator run through the row-list kernel over its ``[local | halo]``
buffer, the remote rows arriving by ONE padded ``all_to_all_single`` a
round (and, on a graph with hub rows, the hubs over one all-gather of the
payload).  The question this benchmark asks: **does the
per-round time stay flat as nodes and shards grow together?**

* Weak scaling: nodes per shard fixed (64 quick, 256 full), shards
  S ∈ {1, 2, 4, 8}, n = nps·S, for the ring, 4-regular and BA(m = 3)
  families, the sparse backend, a d-column fp32 payload (256 quick).
* Per point: the round's wall time (the slowest rank's), the static traffic
  between ranks (``cross_shard_bytes_per_round``), the collectives a round,
  and the sharded mix against the unsharded plan's on the same payload,
  to ``PARITY_RTOL`` of the payload's largest magnitude (the sharded row sums
  in the ``[local | halo]`` order; at S = 1 it must be bitwise).

Ranks: one process group per S, started once with all three families
inside it.  S = 1 runs in the calling process (its world-size-1 group); a
larger S is spawned by ``launch.mesh.spawn_ranks``.  A document holds one
device: on the card every S runs NCCL, one rank a card, and an S above the
host's card count raises (by default the sweep stops at the card count and
says which S it left to a ``--device cpu`` run); on the CPU every S runs
gloo.  Each record names its collective backend and device.

Timing model.  The serialised wall of S > 1 gloo ranks on one host's CPU
measures the host, not the rendering, so ``us_per_round`` models the
parallel round as

    us_per_round(S) = us_compute + n_collectives·LAT + bytes_per_shard/BW

with ``us_compute`` the measured per-round wall of the family's S = 1
point (one shard's workload, what weak scaling holds fixed), the
rendering's own static counts, and BW, LAT the model's constants:
``MODEL_BW_GBPS`` is NVLink 4's published 450 GB/s a direction for an H100
SXM (900 GB/s both ways, NVIDIA's data sheet), ``MODEL_LAT_US`` an assumed
per-collective cost; neither is measured here.  The raw wall stays beside it
as ``us_per_round_serialized``.  ``modelled_growth`` (S = 8 over S = 1) is
reported per family, not gated: it rests on an assumed LAT.

Writes ``{device, cpu_count, quick, model_bw_gbps, model_collective_lat_us,
model_source, modelled_growth, records: [{family, n, n_shards,
nodes_per_shard, d, rounds, backend, collective_backend, rank_device,
us_per_round, us_per_round_serialized, us_compute_per_round,
collectives_per_round, cross_shard_bytes_per_round, parity_bitexact,
parity_max_abs_err}]}`` to ``out_path``, by default
``build/fig10_scaling.json``, and prints its rows through ``emit``.

Run:  python -m repro_torch.benchmarks.fig10_scaling [--device cpu]
"""
from __future__ import annotations

import json
import os
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import topology as T
from repro_torch.core.commplan import compile_plan
from repro_torch.core.shardplan import all_gather_rows, shard_plan
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import backend_for, node_group, rank_device, spawn_ranks

from .common import driver_main, emit

__all__ = ["MODEL_BW_GBPS", "MODEL_LAT_US", "PARITY_RTOL", "SHARDS", "run"]

SHARDS = (1, 2, 4, 8)
MODEL_BW_GBPS = 450.0  # NVLink 4 on an H100 SXM, one direction (published)
MODEL_LAT_US = 10.0  # per-collective launch and sync cost (assumed)
MODEL_SOURCE = ("BW: NVLink 4, 900 GB/s per H100 SXM both directions (NVIDIA data sheet), half a direction; "
                "LAT: assumed, not measured")
PARITY_RTOL = 1e-6  # sharded vs unsharded mix, relative to max|payload|
FAMILIES = {
    "ring": lambda n: T.ring(n),
    "kreg": lambda n: T.random_k_regular(n, 4, seed=0),
    "ba": lambda n: T.barabasi_albert(n, 3, seed=0),
}


def _sizes(quick: bool) -> dict:
    return dict(nps=64, d=256, rounds=10, reps=3) if quick else dict(nps=256, d=512, rounds=50, reps=5)


def _measure(rank: int, n_shards: int, sizes: dict, device: str) -> list[dict]:
    """Every family's point at ``n_shards`` on this rank (all ranks of the
    group call it); returns the records, each rank the same."""
    dev = rank_device(device)
    group = node_group(n_shards, device=dev)
    nps, d, rounds, reps = sizes["nps"], sizes["d"], sizes["rounds"], sizes["reps"]
    n = nps * n_shards
    records = []
    for family, build in FAMILIES.items():
        plan = compile_plan(build(n), backend="sparse", device=dev)
        sp = shard_plan(plan, group=group)
        x = torch.as_tensor(np.random.default_rng(0).normal(size=(n, d)).astype(np.float32), device=dev)
        ref, got = plan.mix(x), sp.mix(x)
        err = float((ref - got).abs().max())
        bit = bool(torch.equal(ref, got))
        tol = PARITY_RTOL * float(x.abs().max())
        if err > tol or (n_shards == 1 and not bit):
            raise AssertionError(f"sharded mix off the unsharded one: {family} S={n_shards} err={err} tol={tol}")
        x_l = x[sp.rows].contiguous()

        def rounds_once():
            y = x_l
            for _ in range(rounds):
                y = sp.local_mix(y)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        rounds_once()  # warm-up: first use of the kernels and the collectives
        best = float("inf")
        for _ in range(reps):
            dist.barrier(group)
            t0 = time.perf_counter()
            rounds_once()
            best = min(best, time.perf_counter() - t0)
        # the slowest rank's round
        walls = all_gather_rows(torch.tensor([best], dtype=torch.float64, device=dev), group)
        records.append({
            "family": family, "n": n, "n_shards": n_shards, "nodes_per_shard": nps, "d": d, "rounds": rounds,
            "backend": "sparse", "collective_backend": backend_for(dev),
            "rank_device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "us_per_round_serialized": float(walls.max()) / rounds * 1e6,
            "collectives_per_round": sp.collectives_per_round("mix"),
            "cross_shard_bytes_per_round": sp.cross_shard_bytes_per_round(d * 4),
            "parity_bitexact": bit, "parity_max_abs_err": err,
        })
    return records


def run(quick: bool = True, device=None, out_path: str | pathlib.Path = "build/fig10_scaling.json",
        shards=None) -> dict:
    """Every point of the sweep (``shards``, by default ``SHARDS``: on the
    card those the host's cards cover); writes and returns the JSON document.
    Every point runs on ``device``: on the card an S above the host's card
    count raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if shards is None:
            shards = tuple(s for s in SHARDS if s <= cards)
            if len(shards) < len(SHARDS):
                print(f"# fig10: {cards} card(s): S = {', '.join(str(s) for s in SHARDS if s > cards)} "
                      "left to a --device cpu run", flush=True)
        elif max(shards) > cards:
            raise ValueError(f"S = {max(shards)} NCCL ranks need {max(shards)} cards, this host has {cards}: "
                             "run those points with --device cpu")
    shards = SHARDS if shards is None else shards
    sizes = _sizes(quick)
    records = []
    for n_shards in shards:
        if n_shards == 1:
            records += _measure(0, 1, sizes, str(dev))
        else:
            records += spawn_ranks(_measure, n_shards, n_shards, sizes, dev.type, device=dev.type)[0]
    out = {
        "device": str(dev), "cpu_count": os.cpu_count(), "quick": quick, "model_bw_gbps": MODEL_BW_GBPS,
        "model_collective_lat_us": MODEL_LAT_US, "model_source": MODEL_SOURCE, "modelled_growth": {},
        "records": records,
    }
    for family in FAMILIES:
        fam = [r for r in records if r["family"] == family]
        base = next((r for r in fam if r["n_shards"] == 1), None)
        us_compute = None if base is None else base["us_per_round_serialized"]
        for r in fam:
            r["us_compute_per_round"] = us_compute
            r["us_per_round"] = None if us_compute is None else (
                us_compute + r["collectives_per_round"] * MODEL_LAT_US
                + r["cross_shard_bytes_per_round"] / r["n_shards"] / (MODEL_BW_GBPS * 1e3))
            emit(f"fig10.{family}.S{r['n_shards']}", r["us_per_round"] or 0.0,
                 f"n={r['n']};serial={r['us_per_round_serialized']:.1f};xbytes={r['cross_shard_bytes_per_round']};"
                 f"{r['collective_backend']};bit={r['parity_bitexact']}")
        top = max(fam, key=lambda r: r["n_shards"])
        if base is not None and top is not base:
            out["modelled_growth"][family] = top["us_per_round"] / base["us_per_round"]
            print(f"# fig10.{family}: 1→{top['n_shards']} shards modelled growth "
                  f"{out['modelled_growth'][family]:.2f}x", flush=True)
    path = pathlib.Path(out_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2))
    print(f"# wrote {path}", flush=True)
    return out


main = driver_main(run, __doc__)

if __name__ == "__main__":
    main()
