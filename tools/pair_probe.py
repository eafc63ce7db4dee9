#!/usr/bin/env python3
"""Time the pair kernel's parts and launch shapes on one NVIDIA GPU.

    python3 tools/pair_probe.py [--out PATH]

Builds ``kernels/mix/csrc/quant_mix.cu`` more times under ``build/pair_probe/``
with its test hooks: ``-DQUANT_PAIR_PROBE=1`` (loads and the absmax only),
``=2`` (stores only), and ``-DQUANT_PAIR_SLOTS=`` 1 and 4 (a thread's groups
of 4 columns; the block's threads follow, as ``quant.pair_launch`` sizes
them for the library's 2).  At the paper MLP's row (d = 567,434, its
2,048-column chunk table, 281 chunks) and BA-16's first edge, int8, fp32:
the kernel whole at 1, 2, 3 and 4 chunks a block and one block an SM,
each slot count, each part, and an empty launch, each the median of 7
CUDA-event timings, L2 flushed, the stream held first (device time only),
in turns (the list forward, then backward; each entry's time the smaller
of its two).  The whole kernel's outputs must be bitwise the library's.
Writes the times as JSON to ``--out`` (default ``build/pair_probe.json``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SRC = ROOT / "src/repro_torch/kernels/mix/csrc"
OUT = ROOT / "build/pair_probe"
MLP_SIZES = (784 * 512, 512, 512 * 256, 256, 256 * 128, 128, 128 * 10, 10)
BUILDS = {"loads": ["-DQUANT_PAIR_PROBE=1"], "stores": ["-DQUANT_PAIR_PROBE=2"], "slots1": ["-DQUANT_PAIR_SLOTS=1"],
          "slots4": ["-DQUANT_PAIR_SLOTS=4"]}


def build() -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels.build import NVCC_FLAGS, _tool

    OUT.mkdir(parents=True, exist_ok=True)
    name = {k: "lib" + "".join(c if c.isalnum() else "_" for c in k) + ".so" for k in BUILDS}
    procs = {k: subprocess.Popen([_tool("nvcc"), *NVCC_FLAGS, "-I", str(SRC), *extra, "-o", str(OUT / name[k]),
                                  str(SRC / "quant_mix.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for k, extra in BUILDS.items()}
    libs = {}
    for k, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"pair_probe: nvcc failed for {k}:\n{log[-3000:]}")
        libs[k] = ctypes.CDLL(str(OUT / name[k]))
        lines = log.splitlines()
        for i, line in enumerate(lines):  # the fp32 pair kernel's registers and spills
            if "Compiling entry" in line and "quant_pair_kernelIf" in line:
                print(f"  {k}: {' '.join(x.strip() for x in lines[i + 2: i + 4])}")
    return libs


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.core import topology as T
    from repro_torch.core.commplan import compile_plan
    from repro_torch.kernels import _launch as K
    from repro_torch.kernels.mix import chunk_bounds, quant_mix_pair
    from repro_torch.kernels.mix import quant as Q

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "pair_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pair_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    libs = {"library": Q._lib(), **build()}
    for lib in libs.values():
        lib.quant_mix_pair.restype = ctypes.c_int
        lib.quant_mix_pair.argtypes = Q._lib().quant_mix_pair.argtypes
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    plan = compile_plan(T.barabasi_albert(16, 3, seed=0), "dense", data_sizes=np.linspace(1.0, 2.0, 16), device=dev)
    m2 = plan.event_m2[0]
    d = sum(MLP_SIZES)
    x = torch.randn(2, d, generator=gen, device=dev) * 0.5
    h = x + 0.01 * torch.randn(2, d, generator=gen, device=dev)
    edges = tuple(chunk_bounds(MLP_SIZES, 2048).tolist())
    bounds = Q.table_bounds(edges, dev)
    n_chunks = len(edges) - 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads, blocks, _ = Q.pair_launch(edges)
    groups = -(-max(b - a for a, b in zip(edges, edges[1:])) // 4) + 1

    def call(lib, thr, blk):
        xo, ho = torch.empty_like(x), torch.empty_like(h)
        sc = torch.empty(2, n_chunks, device=dev)
        err = lib.quant_mix_pair(0, K.ptr(m2), K.ptr(x), K.ptr(h), K.ptr(bounds), K.ptr(sc), K.ptr(xo), K.ptr(ho),
                                 d, n_chunks, thr, blk, 0, 1, 1.0, K.stream_of(x))
        K.raise_on_error(err, "pair_probe")
        return xo, ho, sc

    def time_ms(fn, reps=7):
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

    (xw, hw), sw = quant_mix_pair(m2, x, h, edges, codec="int8", gamma=1.0)
    runs = {f"whole, {c} chunks a block": (lambda c=c: call(libs["library"], threads, -(-n_chunks // c)))
            for c in (1, 2, 3, 4)}
    runs[f"whole, one block an SM ({sms})"] = lambda: call(libs["library"], threads, sms)
    for slots in (1, 4):
        thr = min(512, max(32, -(-groups // (slots * 32)) * 32))
        runs[f"{slots} slots a thread ({thr} threads), {Q.PAIR_CHUNKS_PER_BLOCK} chunks a block"] = (
            lambda s=slots, t=thr: call(libs[f"slots{s}"], t, blocks))
    runs["loads and absmax only"] = lambda: call(libs["loads"], threads, blocks)
    runs["stores only"] = lambda: call(libs["stores"], threads, blocks)
    runs["an empty launch (torch.cuda._sleep(0))"] = lambda: torch.cuda._sleep(0)
    bad = 0
    for name, fn in runs.items():
        if name.startswith(("whole", "1 slots", "4 slots")):
            xo, ho, sc = fn()
            if not (torch.equal(xo, xw) and torch.equal(ho, hw) and torch.equal(sc, sw)):
                print(f"pair_probe: {name}: not bitwise the library's call", file=sys.stderr)
                bad += 1
    turns = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)]:
        turns[name].append(time_ms(runs[name]))
    bound_ms = 2 * d * 16 / 3.35e12 * 1e3
    for name, t in turns.items():
        print(f"  {name:52s} {min(t):.4f} ms held ({t})", flush=True)
    print(f"  byte bound {bound_ms:.4f} ms; the library's launch: {blocks} blocks of {threads} threads")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "bound_ms": bound_ms, "turns_ms": turns}, indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
