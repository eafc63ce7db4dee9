#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints its own lines and any failed check stops the
run with a non-zero exit:

1. header  — the card's name and power limit, torch and CUDA versions;
2. build   — nvcc builds the mixing kernels from ``src/repro_torch/kernels``;
3. kernels — each hand-written kernel against its plain PyTorch version on
   the card (dense: n ∈ {8, 16, 32, 64} × d ∈ {567434, 1000, 1} fp32 plus
   one bf16 shape; block-sparse: ring-1024 at bn 32, random-4-regular-1024
   at bn 64, heavy-tail-40 at bn 8, one masked round), two launches
   bitwise equal, and timings at the main path's shapes;
4. quickstart — ``examples/quickstart.py``'s setup through ``run_sweep``:
   He init plateaus at ln 10, the gain-corrected init descends, 80 dense
   kernel launches;
5. card vs CPU — complete-8 from one numpy init, 3 rounds on each device;
6. CLI     — ``repro_torch.launch.train`` on a 1024-node ring (sparse
   backend, 3 block-sparse launches).

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
FP32_TOL = 1e-5  # × max|W|: one fp32 FMA chain vs cuBLAS's blocked sum
# bf16 output, elementwise: one bf16 ulp of |ref| (the two fp32 sums, taken
# in different orders, may round to neighbouring bf16 values) plus the fp32
# atol.  A kernel that accumulated in bf16 would be off by several ulps.
BF16_RTOL = 2.0**-7


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, reps: int = 7, flush=None) -> float:
    """Median CUDA-event time of one call, with L2 flushed before each."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase(name: str) -> None:
    print(f"\n=== {name} ===", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import topology as T
    from repro_torch.core.commplan import compile_plan
    from repro_torch.core.initialisation import InitConfig, gain_from_graph
    from repro_torch.core.mixing import receive_matrix
    from repro_torch.convert import state_from_numpy, to_numpy
    from repro_torch.data import batch_index_schedule, mnist_like, node_datasets
    from repro_torch.device import resolve_device
    from repro_torch.fed import init_fl_state, make_eval_fn, make_round_fn, run_sweep, run_trajectory
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.mix import bsr_from_dense, decavg_mix_ref, mix_bsr, mix_bsr_ref, mix_matmul
    from repro_torch.launch import train as cli
    from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
    from repro_torch.optim import sgd

    dev = resolve_device("cuda")
    kernels = [mix_matmul, mix_bsr]

    # ------------------------------------------------------------ 1. header
    phase("1. header")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ------------------------------------------------------------- 2. build
    phase("2. build")
    t0 = time.perf_counter()
    built = kbuild.build()
    print(f"built {built or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name in kbuild.LIBRARIES:
        log = kbuild.build_log(name)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", log))
        print(f"  {name}: {len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} "
              f"registers per thread, {spills} bytes spilled")

    # --------------------------------------------------- 3. kernels vs plain
    phase("3. kernels vs plain")
    rng = np.random.default_rng(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    gen = torch.Generator(device=dev).manual_seed(0)
    D_MAIN = 567_434  # the paper MLP's parameters per node

    def row_stochastic(n):
        m = rng.random((n, n)).astype(np.float32) + 1e-3
        return torch.as_tensor(m / m.sum(1, keepdims=True), device=dev)

    def compare(label, run, ref, w, bf16=False):
        got = run()
        again = run()
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        atol = FP32_TOL * max(float(w.float().abs().max()), 1.0)
        worst = float((diff / (atol + BF16_RTOL * ref.float().abs())).max()) if bf16 else err / atol
        bitwise = bool(torch.equal(got, again))
        rule = f"{atol:.1e} + 2^-7·|ref|" if bf16 else f"{atol:.1e}"
        print(f"  {label:48s} max_abs_err {err:.3e} tol {rule} (worst err/tol {worst:.3f}) "
              f"deterministic {bitwise}")
        check(got.dtype == w.dtype and got.shape == ref.shape, f"{label}: dtype/shape")
        check(worst <= 1.0, f"{label}: error above tolerance {rule} (worst err/tol {worst})")
        check(bitwise, f"{label}: two launches differ")
        return err

    errs = {"mix_matmul": 0.0, "mix_bsr": 0.0}
    for n in (8, 16, 32, 64):
        for d in (D_MAIN, 1000, 1):
            m = row_stochastic(n)
            w = torch.randn(n, d, generator=gen, device=dev)
            e = compare(f"mix_matmul fp32 n={n} d={d}", lambda: mix_matmul(m, w), decavg_mix_ref(m, w), w)
            errs["mix_matmul"] = max(errs["mix_matmul"], e)
    m = row_stochastic(16)
    w = torch.randn(16, D_MAIN, generator=gen, device=dev).to(torch.bfloat16)
    compare(f"mix_matmul bf16 n=16 d={D_MAIN}", lambda: mix_matmul(m, w), decavg_mix_ref(m, w), w, bf16=True)

    bsr_cases = [
        ("ring-1024 bn=32", T.ring(1024), 32),
        ("kreg4-1024 bn=64", T.random_k_regular(1024, 4, seed=0), 64),
        ("heavytail-40 bn=8", T.configuration_heavy_tail(40, 2.2, seed=0), 8),
    ]
    for label, g, bn in bsr_cases:
        m_np = receive_matrix(g).astype(np.float32)
        bc, tiles, counts = (torch.as_tensor(a, device=dev) for a in bsr_from_dense(m_np, bn))
        w = torch.randn(g.n, D_MAIN, generator=gen, device=dev)
        ref = mix_bsr_ref(bc, tiles, counts, w)
        e = compare(f"mix_bsr {label} d={D_MAIN}", lambda: mix_bsr(bc, tiles, counts, w), ref, w)
        dense_err = float((ref - decavg_mix_ref(torch.as_tensor(m_np, device=dev), w)).abs().max())
        print(f"    plain BSR vs dense M·W: {dense_err:.3e}; real tiles {int(counts.sum())} "
              f"of {counts.numel() * bc.shape[1]} stored, per row block max {int(counts.max())} "
              f"of {-(-g.n // bn)}")
        check(dense_err <= FP32_TOL * float(w.abs().max()), f"{label}: BSR lowering disagrees with M")
        errs["mix_bsr"] = max(errs["mix_bsr"], e)
        del w, ref

    # tile occupancy at the sizes the sparse backend serves: structure only
    for label, g, bn in (
        ("ring-1024", T.ring(1024), 32),
        ("torus-32x32", T.torus_lattice((32, 32)), 32),
        ("kreg4-1024", T.random_k_regular(1024, 4, seed=0), 32),
        ("kreg4-1024", T.random_k_regular(1024, 4, seed=0), 64),
    ):
        counts = bsr_from_dense(receive_matrix(g), bn)[2]
        print(f"    occupancy {label} bn={bn}: {counts.mean():.2f} of {len(counts)} tiles kept per row block "
              f"(max {counts.max()})")

    # one masked sparse round: injected node/edge masks renormalise the tiles
    ring = T.ring(1024)
    plan_s = compile_plan(ring, "sparse", device=dev)
    plan_d = compile_plan(ring, "dense", device=dev)
    active = torch.as_tensor(rng.random(1024) < 0.8, device=dev)
    edge_live = torch.as_tensor(rng.random(plan_s.n_edges) < 0.7, device=dev)
    op = plan_s.round_operator(active=active, edge_live=edge_live)
    m_masked = plan_d.round_operator(active=active, edge_live=edge_live)
    w = torch.randn(1024, D_MAIN, generator=gen, device=dev)
    e = compare("mix_bsr masked ring-1024 round", lambda: mix_bsr(*op, w), decavg_mix_ref(m_masked, w), w)
    errs["mix_bsr"] = max(errs["mix_bsr"], e)
    del w

    # timings at the main path's shapes: dense at the quickstart's complete-16,
    # block-sparse at the CLI's ring-1024 (bn 32); W fp32 of the full MLP width
    timing = {}
    m16 = compile_plan(T.complete(16), "dense", device=dev).receive
    w16 = torch.randn(16, D_MAIN, generator=gen, device=dev)
    b_k, op_k = bound(4 * 16 * 16 + 2 * 4 * 16 * D_MAIN, 2 * 16 * 16 * D_MAIN)
    timing["mix_matmul"] = dict(
        ms=time_ms(lambda: mix_matmul(m16, w16), flush=flush),
        plain_ms=time_ms(lambda: decavg_mix_ref(m16, w16), flush=flush),
        library_ms=time_ms(lambda: torch.matmul(m16, w16), flush=flush),
        bound_ms=b_k, bound_by=op_k, shape=f"n=16 d={D_MAIN} fp32",
    )
    del w16
    bsr = plan_s.bsr
    w1k = torch.randn(1024, D_MAIN, generator=gen, device=dev)
    nnz = int(np.count_nonzero(receive_matrix(ring)))
    tile_bytes = bsr.tiles.numel() * 4 + bsr.block_cols.numel() * 4 + bsr.counts.numel() * 4
    b_s, op_s = bound(tile_bytes + 2 * 4 * 1024 * D_MAIN, 2 * nnz * D_MAIN)
    m_csr = torch.as_tensor(receive_matrix(ring), dtype=torch.float32, device=dev).to_sparse_csr()
    timing["mix_bsr"] = dict(
        ms=time_ms(lambda: mix_bsr(*bsr, w1k), flush=flush),
        plain_ms=time_ms(lambda: mix_bsr_ref(*bsr, w1k), reps=3, flush=flush),
        library_ms=time_ms(lambda: torch.sparse.mm(m_csr, w1k), flush=flush),
        bound_ms=b_s, bound_by=op_s, shape=f"ring-1024 bn=32 d={D_MAIN} fp32",
    )
    del w1k, m_csr, plan_d, m16
    for name, t in timing.items():
        print(f"  {name} at {t['shape']}: kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms")
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 4. quickstart
    phase("4. quickstart (complete-16, full-width MLP, He vs gain-corrected)")
    N_NODES, PER_NODE, ROUNDS, B_LOCAL = 16, 128, 40, 4
    graph = T.complete(N_NODES)
    gain = gain_from_graph(graph)
    ds = mnist_like(N_NODES * PER_NODE + 512, seed=0)
    parts = [np.arange(i * PER_NODE, (i + 1) * PER_NODE) for i in range(N_NODES)]
    xs, ys = node_datasets(ds, parts)
    test = (ds.x[-512:], ds.y[-512:])

    def loss_fn(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    opt = sgd(1e-3, momentum=0.5)
    eval_fn = make_eval_fn(loss_fn)
    init_one = lambda g, gains: init_mlp(InitConfig("he_normal", gains), g)  # noqa: E731
    states = [init_fl_state(0, N_NODES, init_one, opt, gains=gv, device=dev) for gv in (1.0, gain)]
    check(states[0].params.shape == (N_NODES, D_MAIN), f"ensemble shape {tuple(states[0].params.shape)}")
    schedule = batch_index_schedule(PER_NODE, N_NODES, 16, ROUNDS * B_LOCAL, seed=0)
    round_fn = make_round_fn(loss_fn, opt, graph, device=dev)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    _, hists = run_sweep(
        states, round_fn, xs, ys, schedule, n_rounds=ROUNDS, eval_every=5,
        eval_fn=eval_fn, eval_batch=test, b_local=B_LOCAL, device=dev,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    quick_launches = {k.__name__: k.launches for k in kernels}
    for label, h in zip(("He (gain 1.00)", f"corrected (gain {gain:.2f})"), hists):
        print(f"  {label:22s} test loss @ {h['round']}:")
        print("    " + "  ".join(f"{v:.3f}" for v in h["test_loss"]))
    he, corr = hists[0]["test_loss"][-1], hists[1]["test_loss"][-1]
    print(f"  2 runs x {ROUNDS} rounds in {wall:.2f} s; launches {quick_launches}")
    check(all(math.isfinite(v) for h in hists for v in h["test_loss"] + h["train_loss"]), "non-finite loss")
    check(abs(he - math.log(10)) < 0.01, f"He final test loss {he} not within 0.01 of ln 10")
    check(corr < 2.0, f"corrected final test loss {corr} not below 2.0")
    check(quick_launches == {"mix_matmul": 2 * ROUNDS, "mix_bsr": 0}, f"launch counts {quick_launches}")

    # ------------------------------------------------------ 5. card vs CPU
    phase("5. card vs CPU (complete-8, numpy init, 3 rounds)")
    n8, per8, r8, b8 = 8, 64, 3, 2
    dims = [784, 512, 256, 128, 10]
    g8 = T.complete(n8)
    init_rng = np.random.default_rng(5)
    params_np = {
        f"fc{i}": {
            "w": (init_rng.standard_normal((n8, dims[i], dims[i + 1])) * math.sqrt(2.0 / dims[i])
                  * gain_from_graph(g8)).astype(np.float32),
            "b": np.zeros((n8, dims[i + 1]), np.float32),
        }
        for i in range(4)
    }
    ds8 = mnist_like(n8 * per8 + 256, seed=1)
    xs8, ys8 = node_datasets(ds8, [np.arange(i * per8, (i + 1) * per8) for i in range(n8)])
    sched8 = batch_index_schedule(per8, n8, 16, r8 * b8, seed=1)
    results = {}
    for d_name in ("cuda", "cpu"):
        st = state_from_numpy(params_np, optimizer=opt, device=d_name)
        rf = make_round_fn(loss_fn, opt, g8, device=d_name)
        st, h = run_trajectory(
            st, rf, xs8, ys8, sched8, n_rounds=r8, eval_every=1, eval_fn=eval_fn,
            eval_batch=(ds8.x[-256:], ds8.y[-256:]), track_sigmas=True, b_local=b8, device=d_name,
        )
        results[d_name] = (h, to_numpy(st)[0])
    (h_gpu, p_gpu), (h_cpu, p_cpu) = results["cuda"], results["cpu"]
    for key in ("train_loss", "test_loss", "sigma_ap", "sigma_an"):
        a, b = np.asarray(h_gpu[key]), np.asarray(h_cpu[key])
        diff = float(np.max(np.abs(a - b)))
        print(f"  {key:10s} cuda {np.array2string(a, precision=6)} cpu {np.array2string(b, precision=6)} "
              f"max abs diff {diff:.2e}")
        # atol only for values that are exactly 0 in exact arithmetic (σ_an
        # after a complete-graph round: every node holds the same average)
        check(np.allclose(a, b, rtol=1e-4, atol=1e-6), f"card vs CPU {key}")
    perr = max(float(np.abs(p_gpu[k]["w"] - p_cpu[k]["w"]).max()) for k in p_gpu)
    print(f"  final params max abs diff {perr:.2e}")
    check(perr < 1e-4, "card vs CPU final params")

    # ------------------------------------------------------- 6. CLI, sparse
    phase("6. CLI: ring-1024, sparse backend")
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = cli.main([
        "--model", "mlp", "--topology", "ring", "--nodes", "1024", "--rounds", "3",
        "--local-batches", "2", "--no-gain-correction",
    ])
    torch.cuda.synchronize()
    cli_launches = {k.__name__: k.launches for k in kernels}
    print(f"  {time.perf_counter() - t0:.1f} s incl. data generation; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {cli_launches}")
    check(all(math.isfinite(v) for k in ("train_loss", "test_loss", "sigma_ap", "sigma_an") for v in hist[k]),
          "CLI history not finite")
    check(len(hist["round"]) == 3, "CLI recorded rounds")
    check(cli_launches == {"mix_matmul": 0, "mix_bsr": 3}, f"CLI launch counts {cli_launches}")

    # ------------------------------------------------------------- result
    src = "src/repro_torch/kernels/mix/csrc"
    rows = []
    for name, replaces, source, launches in (
        ("mix_matmul", "src/repro/kernels/mix/mix.py:76", f"{src}/mix.cu", quick_launches["mix_matmul"]),
        ("mix_bsr", "src/repro/kernels/mix/sparse.py:114", f"{src}/mix_bsr.cu", cli_launches["mix_bsr"]),
    ):
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(f"\ncard: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
