#!/usr/bin/env python3
"""Time the row-list kernel's two routes in turns at the shapes that decide
``kernels.mix.hyb_route``, on one NVIDIA GPU, and hold the rule's pick to
the faster route.

    python3 tools/hyb_route_sweep.py [--out PATH] [--sets phase3,rows,widths]

Shapes: the ten of ``chip_smoke.py`` phase 3 row 2y at the main path's
widths (fp32 and bf16 ring-1024, kreg4-1024, BA-1024 m 3 and the CLI's
m 8, heavy-tail-1024, the churn CLI's kreg4-256, circulant-16 (1, 2) at the
launch layer's d = 361,600, rank 0 of kreg4-256 and BA-256 at S = 4,
d = 256); the crossing in output rows: circulant (1, 2), kreg4 and BA
(m 3) at 16 to 128 rows, and rings, at d = 361,600 in fp32 (some in
bf16); the crossing in the row's width: 16 and 64 rows and the S = 4
ranks from d = 256 to 65,536.  At each: the
slab route bitwise the rows route and ``mix_hyb_ref``; then slab, rows,
rows, slab, each the median of 7 CUDA-event timings with L2 flushed, each
route's time the smaller of its two; ``torch.sparse.mm`` on M's CSR beside
them in fp32.  It prints each shape's times, the route ``route_of`` picks
and whether that route is within 3% of the faster, and writes them all as
JSON to ``--out`` (default ``build/hyb_route_sweep.json``).  Exits 1 on a
bitwise miss; a pick more than 3% slower is printed, not failed, so that
one run gives the whole table.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
D_MAIN = 567_434  # the paper MLP's flat row
D_LAUNCH = 361_600  # the launch layer's reduced qwen2.5-3b row (chip_smoke.py phase 6c)
SLACK = 1.03


def time_ms(fn, flush, reps: int = 7) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def shard_case(g, rank: int, d: int, dev, gen):
    """Rank ``rank``'s HYB at S = 4 over its [local | halo] buffer, the hubs
    over the whole W (as chip_smoke.py phase 3 builds it), and its rows of M."""
    import numpy as np
    import torch

    from repro_torch.core.commplan import compile_plan
    from repro_torch.core.mixing import receive_matrix
    from repro_torch.core.shardplan import _build_hyb_tables, _layouts
    from repro_torch.kernels.mix import hyb_from_tables

    plan = compile_plan(g, "sparse", device=dev)
    recv, _ = _layouts(plan, 4)
    tabs = _build_hyb_tables(plan, recv, 4)
    real = tabs["hub_loc"][rank] < recv.nps
    op = hyb_from_tables(tabs["slot_pos"][rank], tabs["slot_w"][rank], tabs["hyb_self"][rank],
                         tabs["hub_loc"][rank][real], tabs["hub_m"][rank][real], dev)
    x = torch.randn(g.n, d, generator=gen, device=dev)
    lo = rank * recv.nps
    halo = recv.send[:, rank, : recv.h_max] + np.arange(4)[:, None] * recv.nps
    buf = torch.cat([x[lo: lo + recv.nps], x[torch.as_tensor(halo.reshape(-1), dtype=torch.int64, device=dev)]])
    m_rows = torch.as_tensor(receive_matrix(g)[lo: lo + recv.nps], dtype=torch.float32, device=dev)
    return op, buf, x, m_rows.to_sparse_csr(), x


def main() -> int:
    import torch

    from repro_torch.core import topology as T
    from repro_torch.core.commplan import compile_plan
    from repro_torch.core.mixing import receive_matrix
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.mix import hyb as H
    from repro_torch.launch import train as cli

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "hyb_route_sweep.json"))
    ap.add_argument("--sets", default="phase3,rows,widths",
                    help="comma-separated: phase3 (the ten shapes), rows (the crossing in output rows at "
                         "d = 361,600), widths (the crossing in d at 16 and 64 rows)")
    args = ap.parse_args()
    sets = set(args.sets.split(","))
    if not torch.cuda.is_available():
        print("hyb_route_sweep: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    kbuild.build(["mix_hyb"])
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def plan_case(g, d, dtype):
        op = compile_plan(g, "sparse", device=dev).hyb
        w = torch.randn(g.n, d, generator=gen, device=dev).to(dtype)
        csr = torch.as_tensor(receive_matrix(g), dtype=torch.float32, device=dev).to_sparse_csr()
        return op, w, None, csr, w

    cases = []
    if "phase3" in sets:
        cases += [
            ("ring-1024", lambda: plan_case(T.ring(1024), D_MAIN, torch.float32)),
            ("ring-1024 bf16", lambda: plan_case(T.ring(1024), D_MAIN, torch.bfloat16)),
            ("kreg4-1024", lambda: plan_case(T.random_k_regular(1024, 4, seed=0), D_MAIN, torch.float32)),
            ("ba-1024 (m 3, seed 2)", lambda: plan_case(T.barabasi_albert(1024, 3, seed=2), D_MAIN, torch.float32)),
            ("heavytail-1024", lambda: plan_case(T.configuration_heavy_tail(1024, 2.2, seed=0), D_MAIN,
                                                 torch.float32)),
            ("ba-1024 (the CLI's: m 8, seed 0)", lambda: plan_case(cli.build_graph("ba", 1024, 0), D_MAIN,
                                                                  torch.float32)),
            ("kreg4-256 (the churn CLI's)", lambda: plan_case(cli.build_graph("kregular", 256, 0), D_MAIN,
                                                             torch.float32)),
            ("circulant-16 (1, 2)", lambda: plan_case(T.circulant(16, (1, 2)), D_LAUNCH, torch.float32)),
            ("kreg4-256 S=4 rank 0", lambda: shard_case(T.random_k_regular(256, 4, seed=0), 0, 256, dev, gen)),
            ("ba-256 S=4 rank 0", lambda: shard_case(T.barabasi_albert(256, 3, seed=2), 0, 256, dev, gen)),
        ]
    for n in (16, 24, 32, 48, 64, 96, 128) if "rows" in sets else ():
        cases += [
            (f"circulant-{n} (1, 2)", lambda n=n: plan_case(T.circulant(n, (1, 2)), D_LAUNCH, torch.float32)),
            (f"kreg4-{n}", lambda n=n: plan_case(T.random_k_regular(n, 4, seed=0), D_LAUNCH, torch.float32)),
            (f"ba-{n} (m 3)", lambda n=n: plan_case(T.barabasi_albert(n, 3, seed=2), D_LAUNCH, torch.float32)),
        ]
    for n in (16, 32, 48, 64) if "rows" in sets else ():
        cases.append((f"circulant-{n} (1, 2) bf16", lambda n=n: plan_case(T.circulant(n, (1, 2)), D_LAUNCH,
                                                                         torch.bfloat16)))
        cases.append((f"kreg4-{n} bf16", lambda n=n: plan_case(T.random_k_regular(n, 4, seed=0), D_LAUNCH,
                                                              torch.bfloat16)))
    for n in (64, 256) if "rows" in sets else ():
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((f"ring-{n} {str(dtype).removeprefix('torch.')}",
                          lambda n=n, dtype=dtype: plan_case(T.ring(n), D_LAUNCH, dtype)))
    # the crossing in the row's width: few output rows (16 and 64, and a
    # shard's 64 at S = 4) from d = 256 to 65,536
    for d in (256, 1024, 4096, 16_384, 65_536) if "widths" in sets else ():
        cases += [
            (f"circulant-16 (1, 2) d={d}", lambda d=d: plan_case(T.circulant(16, (1, 2)), d, torch.float32)),
            (f"kreg4-64 d={d}", lambda d=d: plan_case(T.random_k_regular(64, 4, seed=0), d, torch.float32)),
            (f"ba-64 (m 3) d={d}", lambda d=d: plan_case(T.barabasi_albert(64, 3, seed=2), d, torch.float32)),
            (f"kreg4-256 S=4 rank 0 d={d}", lambda d=d: shard_case(T.random_k_regular(256, 4, seed=0), 0, d, dev,
                                                                    gen)),
            (f"ba-256 S=4 rank 0 d={d}", lambda d=d: shard_case(T.barabasi_albert(256, 3, seed=2), 0, d, dev, gen)),
        ]

    rows, bad = [], 0
    for label, make in cases:
        op, w, w_hub, csr, x_full = make()
        y = H.mix_hyb_ref(op, w, w_hub)
        same = {r: bool(torch.equal(H._launch(op, w, w_hub, r), y)) for r in H.ROUTES}
        if not all(same.values()):
            print(f"hyb_route_sweep: {label}: a route differs from mix_hyb_ref {same}", file=sys.stderr)
            bad += 1
        turns = {r: [] for r in H.ROUTES}
        for r in ("slab", "rows", "rows", "slab"):
            turns[r].append(time_ms(lambda r=r: H._launch(op, w, w_hub, r), flush))
        t = {r: min(v) for r, v in turns.items()}
        pick = H.route_of(op, w, w_hub)
        fast = min(t, key=t.get)
        lib_ms = time_ms(lambda: torch.sparse.mm(csr, x_full), flush) if w.dtype == torch.float32 else None
        ok = t[pick] <= SLACK * t[fast]
        row = dict(shape=label, n_rows=op.n_rows, n_slots=op.slot_idx.shape[0], n_hubs=op.n_hubs,
                   n_src=w.shape[0], d=w.shape[1], dtype=str(w.dtype).removeprefix("torch."), slab_ms=t["slab"],
                   rows_ms=t["rows"], turns_ms=turns, sparse_mm_ms=lib_ms, pick=pick, faster=fast,
                   pick_within_3pct=ok)
        rows.append(row)
        print(f"  {label:36s} rows {op.n_rows:5d} slots {op.slot_idx.shape[0]:3d} hubs {op.n_hubs:4d} "
              f"{row['dtype']:8s} d={w.shape[1]:7d}: slab {t['slab']:.4f} rows {t['rows']:.4f} ms "
              f"(slab/rows {t['slab'] / t['rows']:.3f}), torch.sparse.mm {lib_ms}; pick {pick}, faster {fast}"
              + ("" if ok else "  <-- the pick is more than 3% slower"), flush=True)
        del op, w, w_hub, csr, x_full, y
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "shapes": rows}, indent=1))
    n_ok = sum(r["pick_within_3pct"] for r in rows)
    print(f"hyb_route_sweep: {n_ok} of {len(rows)} picks within 3% of the faster route; wrote {out}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
