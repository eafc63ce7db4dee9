#!/usr/bin/env python3
"""Time an asynchronous event's compressed exchange on its two routes in
turns, on one NVIDIA GPU: ``quant_mix_pair`` (route ``pair``, the kernel of
its own) against the dense round ``quant_mix_dense`` on the same (2, d)
rows and 2 × 2 operator (route ``staged``, or ``wide`` for chunks wider
than a cluster stages).

    python3 tools/pair_exchange_ab.py [--out PATH]

At the paper MLP's row (d = 567,434, its per-leaf chunk table) and BA-16's
first edge (data sizes 1 to 2, as ``chip_smoke.py`` phase 3 row 3e): int8
and fp8, fp32 and bf16 X, error feedback on and off, chunks of 2,048 (the
default), 512 and 65,536 (two passes).  At each: the two routes' scales,
H' and X' bitwise each other and ``ref.pair_round_ref``; then pair, dense,
dense, pair, each the median of 7 CUDA-event timings, L2 flushed, the
stream held first (device time only), each route's time the smaller of
its two; the byte bound (X and H read once, X' and H' written once, at
3.35 TB/s) beside them.  Writes the rows as JSON to ``--out`` (default
``build/pair_exchange_ab.json``); exits 1 on a bitwise miss.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
MLP_SIZES = (784 * 512, 512, 512 * 256, 256, 256 * 128, 128, 128 * 10, 10)  # the paper MLP's leaves
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def time_ms(fn, flush, reps: int = 7) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.core import topology as T
    from repro_torch.core.commplan import compile_plan
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.mix import chunk_bounds, quant_mix_dense, quant_mix_pair
    from repro_torch.kernels.mix.quant import pair_launch, tile_plan
    from repro_torch.kernels.mix.ref import pair_round_ref

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "pair_exchange_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pair_exchange_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    kbuild.build(["quant_mix"])
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    plan = compile_plan(T.barabasi_albert(16, 3, seed=0), "dense", data_sizes=np.linspace(1.0, 2.0, 16), device=dev)
    m2 = plan.event_m2[0]
    d = sum(MLP_SIZES)
    x32 = torch.randn(2, d, generator=gen, device=dev) * 0.5
    h = x32 + 0.01 * torch.randn(2, d, generator=gen, device=dev)
    rows, bad = [], 0
    for codec, dtype, ef, chunk in (("int8", torch.float32, True, 2048), ("fp8", torch.float32, True, 2048),
                                    ("int8", torch.bfloat16, True, 2048), ("int8", torch.float32, False, 2048),
                                    ("int8", torch.float32, True, 512), ("int8", torch.float32, True, 65536)):
        x = x32.to(dtype)
        h_in = h if ef else None
        edges = tuple(chunk_bounds(MLP_SIZES, chunk).tolist())
        kw = dict(codec=codec, gamma=1.0, error_feedback=ef)
        (xp, hp), sp = quant_mix_pair(m2, x, h_in, edges, **kw)
        (xd, hd), sd = quant_mix_dense(m2, x, h_in, edges, **kw)
        xr, hr = pair_round_ref(m2, x, h_in, chunk_bounds(MLP_SIZES, chunk, dev), sp, **kw)
        same = dict(scales=bool(torch.equal(sp, sd)), h=bool(torch.equal(hp, hd)), x=bool(torch.equal(xp, xd)),
                    ref=bool(torch.equal(xp, xr) and torch.equal(hp, hr)))
        label = f"{codec} {str(dtype).removeprefix('torch.')} ef={int(ef)} chunk {chunk}"
        if not all(same.values()):
            print(f"pair_exchange_ab: {label}: not bitwise {same}", file=sys.stderr)
            bad += 1
        runs = {"pair": lambda: quant_mix_pair(m2, x, h_in, edges, **kw),
                "dense": lambda: quant_mix_dense(m2, x, h_in, edges, **kw)}
        turns = {k: [] for k in runs}
        for k in ("pair", "dense", "dense", "pair"):
            turns[k].append(time_ms(runs[k], flush))
        t = {k: min(v) for k, v in turns.items()}
        moved = 2 * d * (2 * x.element_size() + (8 if ef else 4)) + 16 + 8 * (len(edges) - 1) + 8 * len(edges)
        bound_ms = moved / PEAK_BYTES_PER_S * 1e3
        threads, blocks, passes = pair_launch(edges)
        dense_route = tile_plan(edges, 2, dtype, dev)[0].route
        rows.append(dict(case=label, pair_ms=t["pair"], dense_ms=t["dense"], turns_ms=turns, bound_ms=bound_ms,
                         bytes=moved, threads=threads, blocks=blocks, passes=passes, dense_route=dense_route,
                         bitwise=same))
        print(f"  {label:32s} pair {t['pair']:.4f} ms ({blocks} blocks of {threads} threads, {passes} pass(es); "
              f"{bound_ms / t['pair']:.1%} of the {bound_ms:.4f} ms bound), dense ({dense_route}) "
              f"{t['dense']:.4f} ms, in turns {turns}; bitwise {same}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "cases": rows}, indent=1))
    print(f"pair_exchange_ab: wrote {out}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
