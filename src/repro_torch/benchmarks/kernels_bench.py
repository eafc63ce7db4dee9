"""Kernel micro-benchmarks (counterpart of ``benchmarks/kernels_bench.py``).

``run`` times the port's hand-written kernels through their public wrappers
at the JAX driver's shapes: the dense DecAvg mix (``mix_matmul``), flash
attention (``flash_mha``, causal and sliding-window) and the RWKV-6
time-mix (``rwkv6_chunked``, in its own (B, L, H, M) layout).  Each row
reports the kernel's µs a call (CUDA events around ``iters`` calls after a
warm-up; host clock on the CPU), its GFLOP/s at the JAX driver's flop
counts, and in place of the JAX driver's interpret-mode error the largest
difference from the kernel's plain version on the same inputs
(``max_abs_err``) beside the magnitude the card checks scale it by
(``ref_scale``: max |W|, max |v|, max |out|) and the route it launched.
On the CPU a wrapper runs its plain version, so the error is 0.

``run_mixing`` sweeps the three ``CommPlan`` backends (dense: the dense mix
kernel; sparse: the row-list (HYB) kernel of the unmasked round; ppermute:
the edge-coloured gather)
over ring / kreg / ba / heavytail at n = 16, 64, 256, 1024 and d = 4096,
best of ``iters`` rounds each, and writes the JAX driver's schema (``{d,
iters, device, records: [{family, n, d, n_edges, mean_degree, us_dense,
us_sparse, us_ppermute, sparse_speedup_vs_dense,
ppermute_speedup_vs_dense}]}``) to ``out_path``, by default
``build/kernels_mixing.json``.

Run:  python -m repro_torch.benchmarks.kernels_bench [--device cpu]
"""
from __future__ import annotations

import json
import pathlib
import time

import torch

from repro_torch.core import topology as T
from repro_torch.core.commplan import BACKENDS, compile_plan
from repro_torch.device import resolve_device
from repro_torch.kernels.flash import attention_ref, flash_mha
from repro_torch.kernels.flash import route as flash_route
from repro_torch.kernels.mix import decavg_mix_ref, dense_route, mix_matmul
from repro_torch.kernels.rwkv import rwkv6_chunked, rwkv6_chunked_ref
from repro_torch.kernels.rwkv import route as rwkv_route

from .common import driver_main, emit

__all__ = ["run", "run_mixing"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time(f, dev: torch.device, iters: int = 5) -> float:
    """Seconds a call: ``iters`` calls after one warm-up, CUDA events on the card."""
    f()
    _sync(dev)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            f()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        f()
    return (time.perf_counter() - t0) / iters


def _err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).abs().max())


_MIX_FAMILIES = {
    "ring": lambda n: T.ring(n),
    "kreg": lambda n: T.random_k_regular(n, 4, seed=0),
    "ba": lambda n: T.barabasi_albert(n, 4, seed=0),
    "heavytail": lambda n: T.configuration_heavy_tail(n, 2.2, seed=0),
}


def run_mixing(ns=(16, 64, 256, 1024), d: int = 4096, iters: int = 5,
               out_path: str | pathlib.Path = "build/kernels_mixing.json", device=None) -> dict:
    """One DecAvg round of an (n, d) node-stacked tree per backend, n ×
    topology family; best of ``iters`` (min), the noise-robust estimator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def best_of(f):
        f()
        _sync(dev)
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            f()
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        return best

    records = []
    for family, build in _MIX_FAMILIES.items():
        for n in ns:
            g = build(n)
            params = {"w": torch.randn(n, d, generator=gen, device=dev)}
            row: dict = {"family": family, "n": n, "d": d, "n_edges": g.n_edges, "mean_degree": g.mean_degree}
            for backend in BACKENDS:
                plan = compile_plan(g, backend, device=dev)
                sec = best_of(lambda: plan.mix(params))
                row[f"us_{backend}"] = sec * 1e6
                emit(f"mixing.{backend}", sec * 1e6,
                     f"family={family};n={n};d={d};bytes_moved~={'n*d*4' if backend == 'dense' else 'deg*d*4'}")
            row["sparse_speedup_vs_dense"] = row["us_dense"] / row["us_sparse"]
            row["ppermute_speedup_vs_dense"] = row["us_dense"] / row["us_ppermute"]
            records.append(row)
    result = {
        "d": d,
        "iters": iters,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "records": records,
    }
    path = pathlib.Path(out_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=2) + "\n")
    print(f"wrote {path} ({len(records)} rows)", flush=True)
    return result


def run(quick: bool = True, device=None) -> dict[str, dict]:
    """The three kernels at the JAX driver's shapes; returns each row's
    numbers by name (``kernels.mix``, ``kernels.flash``, ``kernels.flash_swa``,
    ``kernels.rwkv6``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def row(name, sec, flops, got, ref, scale, route, plain_sec):
        rows[name] = dict(us=sec * 1e6, gflops=flops / sec / 1e9, max_abs_err=_err(got, ref), ref_scale=scale,
                          route=route, plain_us=plain_sec * 1e6)
        r = rows[name]
        emit(name, r["us"], f"gflops={r['gflops']:.1f};max_abs_err={r['max_abs_err']:.1e};"
             f"ref_scale={scale:.3e};route={route};plain_us={r['plain_us']:.1f}")

    # ---- mix: Y = M·W, fp32
    n, d = (16, 1_000_000) if quick else (32, 10_000_000)
    m = torch.rand(n, n, generator=gen, device=dev)
    m = m / m.sum(1, keepdim=True)
    w = torch.randn(n, d, generator=gen, device=dev)
    row("kernels.mix", _time(lambda: mix_matmul(m, w), dev), 2 * n * n * d, mix_matmul(m, w), decavg_mix_ref(m, w),
        float(w.abs().max()), dense_route(n, d, w.dtype), _time(lambda: decavg_mix_ref(m, w), dev))
    del w

    # ---- flash: GQA, fp32, causal; then a window of 128
    b, h, kvh, s, hd = (1, 4, 2, 1024, 64) if quick else (2, 8, 4, 4096, 128)
    q = torch.randn(b, h, s, hd, generator=gen, device=dev)
    k = torch.randn(b, kvh, s, hd, generator=gen, device=dev)
    v = torch.randn(b, kvh, s, hd, generator=gen, device=dev)
    flops = 4 * b * h * s * s * hd / 2  # the causal half
    for name, window in (("kernels.flash", 0), ("kernels.flash_swa", 128)):
        row(name, _time(lambda: flash_mha(q, k, v, causal=True, window=window), dev), flops,
            flash_mha(q, k, v, causal=True, window=window), attention_ref(q, k, v, causal=True, window=window),
            float(v.abs().max()), flash_route(q.dtype, hd),
            _time(lambda: attention_ref(q, k, v, causal=True, window=window), dev))
    del q, k, v

    # ---- rwkv6: the chunked WKV recurrence, B·H = bh sequences of L tokens
    bh, l_len, m_ = (8, 2048, 64) if quick else (32, 8192, 64)
    r = torch.randn(1, l_len, bh, m_, generator=gen, device=dev)
    k2 = torch.randn(1, l_len, bh, m_, generator=gen, device=dev) * 0.3
    v2 = torch.randn(1, l_len, bh, m_, generator=gen, device=dev)
    w2 = torch.exp(-torch.exp(torch.randn(1, l_len, bh, m_, generator=gen, device=dev).clamp(-8, 1)))
    u2 = torch.randn(bh, m_, generator=gen, device=dev).abs() * 0.3
    c = 32  # the JAX driver's flop count of the chunked form: 3 products a chunk
    flops = (l_len // c) * (2 * c * c * m_ + 4 * c * m_ * m_) * bh
    ref = rwkv6_chunked_ref(r, k2, v2, w2, u2)[0]
    row("kernels.rwkv6", _time(lambda: rwkv6_chunked(r, k2, v2, w2, u2), dev), flops,
        rwkv6_chunked(r, k2, v2, w2, u2)[0], ref, float(ref.abs().max()), rwkv_route(r.dtype, m_),
        _time(lambda: rwkv6_chunked_ref(r, k2, v2, w2, u2), dev, iters=1))
    return rows


def _main(quick: bool = True, device=None) -> None:
    run(quick, device)
    run_mixing(device=device)


main = driver_main(_main, __doc__)

if __name__ == "__main__":
    main()
