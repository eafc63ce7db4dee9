#!/usr/bin/env python3
"""Time this checkout's mixing kernels against another checkout's, in turns,
on one NVIDIA GPU.

    python3 tools/mix_walk_ab.py --other DIR [--pairs 5]

DIR is an unpacked checkout of another commit (``git archive``).  Both
checkouts' ``mix_bsr`` and ``quant_mix`` libraries are built from their own
sources with this checkout's nvcc flags and called through their C entry
points on the same inputs: the block-sparse mix and the int8 block-sparse
round (the scales pass, then the walk) at ring-1024 and kreg4-1024 (bn 32),
and the dense int8 round at complete-16 and complete-64, all at the paper
MLP's width (d = 567,434, fp32, its 281-chunk table).  A side whose
``quant_mix.cu`` has the one-launch round (``quant_round_kernel``) runs it;
an older side runs its scales pass and then its dense walk.  Each pair times
the other side, then this one, then this one, then the other (CUDA events,
L2 flushed, the stream held so that only device time counts, median of 7
each); the script prints every time, each side's
median, and the card's name and power limit.  The two sides' outputs must
agree: the scales and new mirrors bitwise, Y and X' within 1e-5 · max|W or X|.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
D_MAIN = 567_434


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path, help="an unpacked checkout of another commit")
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mix_walk_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import time_ms
    from repro_torch.core import topology as T
    from repro_torch.core.commplan import compile_plan
    from repro_torch.core.mixing import receive_matrix
    from repro_torch.kernels import _launch as K
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.mix import BSR, bsr_from_dense, chunk_bounds
    from repro_torch.kernels.mix import quant as Q
    from repro_torch.kernels.mix import sparse as S

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    this = {"mix_bsr": S._lib(), "quant_mix": Q._lib()}
    other = {}
    for name in this:
        src = args.other / kbuild.LIBRARIES[name].relative_to(ROOT)
        out = kbuild.BUILD_DIR / f"lib{name}-other.so"
        subprocess.run([kbuild._tool("nvcc"), *kbuild.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                       capture_output=True)
        other[name] = ctypes.CDLL(str(out))
        for fn in ("mix_bsr",) if name == "mix_bsr" else ("quant_scales", "quant_mix_dense", "quant_mix_bsr"):
            getattr(other[name], fn).restype = ctypes.c_int
            getattr(other[name], fn).argtypes = getattr(this[name], fn).argtypes
    fused = {"this": True, "other": "quant_round_kernel" in (
        args.other / kbuild.LIBRARIES["quant_mix"].relative_to(ROOT)).read_text()}
    if not fused["other"]:  # the scales pass, then the dense walk over them
        P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        other["quant_mix"].quant_mix_dense.argtypes = [I, P, P, P, P, P, P, P, P, P, I, LL, I, I, I, F, I, P]
    sides = {"other": other, "this": this}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    sizes = (784 * 512, 512, 512 * 256, 256, 256 * 128, 128, 128 * 10, 10)  # the paper MLP's leaves
    bounds = chunk_bounds(sizes, 2048, dev)
    n_chunks = bounds.numel() - 1
    ops = {"ring-1024": compile_plan(T.ring(1024), "sparse", device=dev).bsr,
           "kreg4-1024": BSR(*(torch.as_tensor(a, device=dev) for a in bsr_from_dense(
               receive_matrix(T.random_k_regular(1024, 4, seed=0)).astype("float32"), 32)))}
    w = torch.randn(1024, D_MAIN, generator=gen, device=dev)
    x = torch.randn(1024, D_MAIN, generator=gen, device=dev) * 2
    h = 0.3 * torch.randn(1024, D_MAIN, generator=gen, device=dev)
    dense_n = (16, 64)
    ms = {n: compile_plan(T.complete(n), "dense", device=dev).receive for n in dense_n}
    xs = {n: x[:n].contiguous() for n in dense_n}
    hs = {n: h[:n].contiguous() for n in dense_n}
    stream = K.stream_of(w)
    outs = {side: dict(y=torch.empty_like(w), xo=torch.empty_like(x), ho=torch.empty_like(x),
                       s=torch.empty(1024, n_chunks, device=dev),
                       **{f"{key}{n}": torch.empty(n, *shape, device=dev) for n in dense_n
                          for key, shape in (("xo", (D_MAIN,)), ("ho", (D_MAIN,)), ("s", (n_chunks,)))})
            for side in sides}
    edges = tuple(bounds.tolist())

    def mix(side, op):
        o = outs[side]
        return lambda: sides[side]["mix_bsr"].mix_bsr(
            0, K.ptr(op.block_cols), K.ptr(op.tiles), K.ptr(op.counts), K.ptr(w), K.ptr(o["y"]), 1024, D_MAIN,
            op.tiles.shape[0], op.tiles.shape[1], op.tiles.shape[2], 2, stream)

    def scales(side, xx, hh, s):
        return sides[side]["quant_mix"].quant_scales(0, K.ptr(xx), K.ptr(hh), K.ptr(bounds), K.ptr(s), xx.shape[0],
                                                     D_MAIN, n_chunks, 0, 1, 0, stream)

    def bsr_round(side, op):
        o = outs[side]
        lib = sides[side]["quant_mix"]
        return lambda: scales(side, x, h, o["s"]) or lib.quant_mix_bsr(
            0, K.ptr(op.block_cols), K.ptr(op.tiles), K.ptr(op.counts), K.ptr(x), K.ptr(h), None, K.ptr(bounds),
            K.ptr(o["s"]), None, K.ptr(o["xo"]), K.ptr(o["ho"]), 1024, D_MAIN, n_chunks, op.tiles.shape[0],
            op.tiles.shape[1], op.tiles.shape[2], 0, 1, 1.0, 2, stream)

    def dense_round(side, n):
        o = outs[side]
        lib = sides[side]["quant_mix"]
        xo, ho, s = o[f"xo{n}"], o[f"ho{n}"], o[f"s{n}"]
        if not fused[side]:
            return lambda: scales(side, xs[n], hs[n], s) or lib.quant_mix_dense(
                0, K.ptr(ms[n]), K.ptr(xs[n]), K.ptr(hs[n]), None, K.ptr(bounds), K.ptr(s), None, K.ptr(xo),
                K.ptr(ho), n, D_MAIN, n_chunks, 0, 1, 1.0, 2, stream)
        plan, table = Q.tile_plan(edges, n, torch.float32, dev)
        return lambda: lib.quant_mix_dense(
            0, K.ptr(ms[n]), K.ptr(xs[n]), K.ptr(hs[n]), None, K.ptr(bounds), K.ptr(table), K.ptr(s), None,
            K.ptr(xo), K.ptr(ho), n, D_MAIN, n_chunks, len(plan.tiles), plan.cluster, plan.cols, plan.tile_chunks,
            0, 1, 0, 1.0, stream)

    cases = {}
    for g, op in ops.items():
        cases[f"mix_bsr {g}"] = ({side: mix(side, op) for side in sides}, [("y", "tol", w)])
        cases[f"int8 round (scales + BSR walk) {g}"] = ({side: bsr_round(side, op) for side in sides},
                                                        [("ho", "bitwise", x), ("xo", "tol", x)])
    for n in dense_n:
        what = {side: "one launch" if fused[side] else "scales + dense walk" for side in sides}
        cases[f"int8 dense round complete-{n} (this: {what['this']}; other: {what['other']})"] = (
            {side: dense_round(side, n) for side in sides},
            [(f"s{n}", "bitwise", x), (f"ho{n}", "bitwise", x), (f"xo{n}", "tol", x)])
    ok = True
    for label, (runs, checks) in cases.items():
        for side, fn in runs.items():
            if fn() != 0:
                raise RuntimeError(f"{label}: the {side} side failed to launch")
        torch.cuda.synchronize()
        for key, how, ref in checks:
            a, b = outs["other"][key], outs["this"][key]
            agree = torch.equal(a, b) if how == "bitwise" else float((a - b).abs().max()) <= 1e-5 * float(
                ref.abs().max())
            ok &= agree
            print(f"  {label}: {key} {'bitwise' if how == 'bitwise' else 'within 1e-5 · max'} {agree}")
        times = {side: [] for side in sides}
        for _ in range(args.pairs):
            for side in ("other", "this", "this", "other"):
                times[side].append(time_ms(runs[side], flush=flush, hold=True))
        print(f"{label}: " + "; ".join(
            f"{side} median {statistics.median(t):.4f} ms (" + ", ".join(f"{v:.4f}" for v in t) + ")"
            for side, t in times.items()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
