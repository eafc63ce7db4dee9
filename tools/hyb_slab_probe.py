#!/usr/bin/env python3
"""Time the parts of the row-list kernel's slab route against the whole, and
both routes in turns, on one NVIDIA GPU.

    python3 tools/hyb_slab_probe.py

Builds ``kernels/mix/csrc/mix_hyb.cu`` three more times, each with one of
its probe hooks on (``-DMIX_HYB_PROBE=``): 1 loads only (no row is summed),
2 gathers and stores only (every strip after a block's first keeps its
first strip's rows), 4 gathers only (the stores skipped behind a test the
compiler cannot fold).
At the main path's n = 1024 shapes (fp32 d = 567,434 and its 16-byte
aligned neighbour 567,432, bf16) it times, L2 flushed, median of 7: the
slab route whole, each part, the rows route, ``mix_bsr`` and
``torch.sparse.mm``.  The kernel as it stands must equal ``mix_hyb_ref`` bit
for bit first.  Build outputs go under ``build/hyb_probe/``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SRC = ROOT / "src/repro_torch/kernels/mix/csrc"
OUT = ROOT / "build/hyb_probe"
PARTS = {0: "whole", 1: "loads only", 2: "gathers and stores", 4: "gathers only"}


def build() -> dict[int, ctypes.CDLL]:
    from repro_torch.kernels.build import NVCC_FLAGS, _tool

    OUT.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {p: subprocess.Popen([_tool("nvcc"), *flags, "-I", str(SRC), f"-DMIX_HYB_PROBE={p}", "-o",
                                  str(OUT / f"libprobe{p}.so"), str(SRC / "mix_hyb.cu")]) for p in PARTS}
    libs = {}
    for p, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"hyb_slab_probe: nvcc failed for MIX_HYB_PROBE={p}")
        libs[p] = ctypes.CDLL(str(OUT / f"libprobe{p}.so"))
        libs[p].mix_hyb_slab.restype = ctypes.c_int
    return libs


def main() -> int:
    import torch

    from repro_torch.core import topology as T
    from repro_torch.core.commplan import compile_plan
    from repro_torch.core.mixing import receive_matrix
    from repro_torch.kernels import _launch as K
    from repro_torch.kernels.mix import _launch as L
    from repro_torch.kernels.mix import hyb as H
    from repro_torch.kernels.mix import mix_bsr
    from repro_torch.launch import train as cli

    if not torch.cuda.is_available():
        print("hyb_slab_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    libs = build()
    for lib in libs.values():
        lib.mix_hyb_slab.argtypes = H._lib().mix_hyb_slab.argtypes
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, device=dev)

    def time_ms(fn, reps=7):
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

    def slab(lib, op, w):
        y = torch.empty_like(w)
        err = lib.mix_hyb_slab(K.DTYPE_CODES[w.dtype], K.ptr(op.walk), K.ptr(op.entries), op.entries.shape[0],
                               K.ptr(w), K.ptr(w), K.ptr(y), w.shape[0], w.shape[0], 0, op.n_rows, w.shape[1],
                               L.vec_width(w, y), K.stream_of(w))
        K.raise_on_error(err, "mix_hyb_slab probe")
        return y

    gen = torch.Generator(device=dev).manual_seed(0)
    for label, g, d, dtype in (("ring-1024", T.ring(1024), 567_434, torch.float32),
                               ("ring-1024", T.ring(1024), 567_432, torch.float32),
                               ("ring-1024", T.ring(1024), 567_434, torch.bfloat16),
                               ("kreg4-1024", T.random_k_regular(1024, 4, seed=0), 567_434, torch.float32),
                               ("ba-1024 (m 3)", T.barabasi_albert(1024, 3, seed=2), 567_434, torch.float32),
                               ("ba-1024 (m 8, the CLI's)", cli.build_graph("ba", 1024, 0), 567_434, torch.float32)):
        plan = compile_plan(g, "sparse", device=dev)
        op = plan.hyb
        w = torch.randn(g.n, d, generator=gen, device=dev).to(dtype)
        if not torch.equal(slab(libs[0], op, w), H.mix_hyb_ref(op, w)):
            print(f"hyb_slab_probe: {label}: the slab route differs from mix_hyb_ref", file=sys.stderr)
            return 1
        csr = torch.as_tensor(receive_matrix(g), dtype=torch.float32, device=dev).to_sparse_csr()
        runs = {**{PARTS[p]: (lambda p=p: slab(libs[p], op, w)) for p in PARTS},
                "rows route": lambda: H._launch(op, w, None, "rows"), "mix_bsr": lambda: mix_bsr(*plan.bsr, w)}
        if dtype == torch.float32:
            runs["torch.sparse.mm"] = lambda: torch.sparse.mm(csr, w)
        turns = {name: [] for name in runs}
        for name in [*runs, *reversed(runs)]:
            turns[name].append(time_ms(runs[name]))
        print(f"{label} d={d} {str(dtype).removeprefix('torch.')}: "
              + ", ".join(f"{name} {min(t):.4f} ms" for name, t in turns.items()), flush=True)
        del w, csr
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
