#!/usr/bin/env python3
"""Time this checkout's mixing kernels against another checkout's, in turns,
on one NVIDIA GPU.

    python3 tools/mix_walk_ab.py --other DIR [--pairs 5] [-k TEXT]

DIR is an unpacked checkout of another commit (``git archive``).  Each side
runs in a process of its own and calls its own wrappers (``tools/ab.py``
says how): the block-sparse mix and the int8 block-sparse round (the scales
pass, then the walk) at ring-1024 and kreg4-1024 (bn 32), and the dense
int8 round (one launch) at complete-16 and complete-64, all at the paper
MLP's width (d = 567,434, fp32, its 281-chunk table); the dense mix
``mix_matmul`` at complete-16 and complete-64 over that width, at
complete-16 over VGG16's (d = 33,638,218) and at complete-8 over the reduced
qwen2.5-3b's (d = 361,600), and over the gossip rounds' Mᵀ of kreg4-256 /
64 / 16 / 8 and complete-16 / 8 at d = 1–4 (also timed unheld: what a
caller pays).  Timed with the stream held (device time).  Each side's Y and X' are
held within 1e-5 · max|W or X| of the plain version; the two sides' scales
and new mirrors H', and the dense mix's Y at the training widths, must be
equal bit for bit.
"""
from __future__ import annotations

import sys

import ab

D_MAIN = 567_434
D_VGG = 33_638_218  # VGG16's parameters a node
D_LM = 361_600  # the reduced qwen2.5-3b's (the consensus example's DecAvg rounds at n = 8)
SIZES = (784 * 512, 512, 512 * 256, 256, 256 * 128, 128, 128 * 10, 10)  # the paper MLP's leaves


def _inputs(n):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, D_MAIN, generator=gen, device="cuda") * 2
    return x, 0.3 * torch.randn(n, D_MAIN, generator=gen, device="cuda")


def _op(graph):
    import torch

    from repro_torch.core import topology as T
    from repro_torch.core.commplan import compile_plan
    from repro_torch.core.mixing import receive_matrix
    from repro_torch.kernels.mix import BSR, bsr_from_dense

    if graph == "ring-1024":
        return compile_plan(T.ring(1024), "sparse", device="cuda").bsr
    m = receive_matrix(T.random_k_regular(1024, 4, seed=0)).astype("float32")
    return BSR(*(torch.as_tensor(a, device="cuda") for a in bsr_from_dense(m, 32)))


def _within(got, want, scale) -> float:
    return float((got - want).abs().max()) / (1e-5 * float(scale.abs().max()))


def _mix(graph):
    from repro_torch.kernels.mix import mix_bsr, mix_bsr_ref

    op, (w, _) = _op(graph), _inputs(1024)
    worst = _within(mix_bsr(*op, w), mix_bsr_ref(*op, w), w)
    return lambda: mix_bsr(*op, w), {"worst": worst}


def _bsr_round(graph):
    from repro_torch.kernels.mix import chunk_bounds, mix_bsr_ref, quant_mix_bsr, quant_scales
    from repro_torch.kernels.mix.ref import quant_mix_ref

    op, (x, h) = _op(graph), _inputs(1024)
    bounds = chunk_bounds(SIZES, 2048, "cuda")

    def run():
        s = quant_scales(x, h, bounds, codec="int8")
        return s, quant_mix_bsr(*op, x, h, bounds, s, codec="int8", gamma=1.0)

    s, (xo, ho) = run()
    want_x, _ = quant_mix_ref(lambda hq: mix_bsr_ref(*op, hq), x, h, bounds, s, codec="int8", gamma=1.0)
    return run, {"worst": _within(xo, want_x, x), "same": {"scales": ab.digest(s), "H'": ab.digest(ho)}}


def _dense_round(n):
    from repro_torch.core import topology as T
    from repro_torch.core.commplan import compile_plan
    from repro_torch.kernels.mix import chunk_bounds, decavg_mix_ref, quant_mix_dense
    from repro_torch.kernels.mix.ref import quant_mix_ref

    m = compile_plan(T.complete(n), "dense", device="cuda").receive
    x, h = _inputs(n)
    bounds = chunk_bounds(SIZES, 2048, "cuda")
    edges = tuple(bounds.tolist())
    (xo, ho), s = quant_mix_dense(m, x, h, edges, codec="int8", gamma=1.0)
    want_x, _ = quant_mix_ref(lambda hq: decavg_mix_ref(m, hq), x, h, bounds, s, codec="int8", gamma=1.0)
    return (lambda: quant_mix_dense(m, x, h, edges, codec="int8", gamma=1.0),
            {"worst": _within(xo, want_x, x), "same": {"scales": ab.digest(s), "H'": ab.digest(ho)}})


def _dense_mix(graph, n, d, gossip=False):
    import torch

    from repro_torch.core import topology as T
    from repro_torch.core.commplan import compile_plan
    from repro_torch.kernels.mix import decavg_mix_ref, mix_matmul
    from repro_torch.kernels.mix import mix as mix_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    g = T.complete(n) if graph == "complete" else T.random_k_regular(n, 4, seed=0)
    plan = compile_plan(g, "dense", device="cuda")
    if gossip:  # a gossip round: Mᵀ with a payload of d columns in [0, 1)
        m, w = plan.send_operator(), torch.rand(n, d, generator=gen, device="cuda")
    else:
        m, w = plan.receive, torch.randn(n, d, generator=gen, device="cuda")
    y = mix_matmul(m, w)
    info = {"worst": _within(y, decavg_mix_ref(m, w), w)}
    if hasattr(mix_kernel, "dense_route"):
        info["note"] = f"route {mix_kernel.dense_route(n, d, w.dtype)}"
    if not gossip:  # both sides sum each output over k in ascending order
        info["same"] = {"Y": ab.digest(y)}
    return lambda: mix_matmul(m, w), info


def cases() -> dict:
    """name -> (timing modes, build), as tools/ab.py takes them."""
    held = ("held",)
    return {
        **{f"mix_bsr {g}": (held, lambda g=g: _mix(g)) for g in ("ring-1024", "kreg4-1024")},
        **{f"int8 round (scales + BSR walk) {g}": (held, lambda g=g: _bsr_round(g))
           for g in ("ring-1024", "kreg4-1024")},
        **{f"int8 dense round complete-{n}": (held, lambda n=n: _dense_round(n)) for n in (16, 64)},
        **{f"mix_matmul complete-{n} d={d}": (held, lambda n=n, d=d: _dense_mix("complete", n, d))
           for n, d in ((16, D_MAIN), (64, D_MAIN), (16, D_VGG), (8, D_LM))},
        **{f"mix_matmul gossip {g}-{n} Mᵀ d={d}": (("unheld", "held"),
                                                  lambda g=g, n=n, d=d: _dense_mix(g, n, d, gossip=True))
           for g, n in (("kreg4", 256), ("kreg4", 64), ("kreg4", 16), ("complete", 16), ("kreg4", 8), ("complete", 8))
           for d in (1, 2, 3, 4)},
    }


if __name__ == "__main__":
    sys.path.insert(0, str(ab.ROOT / "src"))
    sys.exit(ab.main(__file__, cases))
