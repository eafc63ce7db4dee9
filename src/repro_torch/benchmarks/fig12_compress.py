"""Figure 12: compressed gossip, bytes on the wire against the final loss
(counterpart of ``benchmarks/fig12_compress.py``).

The compression layer (``core.compress``) makes wire bytes an axis to
trade; this driver measures the trade on three fronts, with bytes and time
side by side:

* **the codec sweep on the paper's fig1 setup** (the complete graph, the
  MLP): the final test loss and the wire bytes a round for none / int8 /
  fp8 / topk / qtopk with the error-feedback mirrors.  The headline:
  ``bytes_reduction_vs_fp32 >= 4`` at ``<= 2%`` final-loss degradation
  for at least one codec.
* **codec × topology**: the sparse families (kregular; ring at full size)
  where the damped sparsifier's γ trade-off bites.
* **the transformer trajectory**: the reduced qwen2.5-3b gossiped on a
  ring of 8 through ``run_trajectory`` on windowed token data, codec none
  against int8, timed by ``ChunkTimer`` (the first chunk's warm-up and the
  steady µs a round) beside its wire bytes.

On the card the dense rounds run the dense mix (none, topk, qtopk) or one
launch of the quantised dense round (int8, fp8) a round.

Writes ``{device, cpu_count, quick, records: [{kind: "codec", codec,
family, n, model, rounds, gamma, wire_bytes_per_round,
bytes_reduction_vs_fp32, final_test_loss, loss_delta_vs_fp32_pct,
compile_seconds, us_per_round_steady, meets_4x_2pct} | {kind:
"transformer", ..., params_per_node, sec_per_round, curve_round,
curve_test_loss}]}`` (the JAX driver's schema, ``BENCH_compress.json``'s
keys) to ``out_path``, by default ``build/fig12_compress.json``, and prints
its rows through ``emit``.

Run:  python -m repro_torch.benchmarks.fig12_compress [--device cpu]
"""
from __future__ import annotations

import json
import os
import pathlib
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.core import topology as T
from repro_torch.core.compress import Compression
from repro_torch.core.initialisation import InitConfig
from repro_torch.data import batch_index_schedule, make_token_stream
from repro_torch.device import resolve_device
from repro_torch.fed import init_fl_state, make_eval_fn, make_round_fn, run_trajectory
from repro_torch.models import transformer as TF
from repro_torch.optim import sgd

from .common import ChunkTimer, driver_main, emit, run_dfl_mlp

# γ: the quantisers contract at 1.0; the sparsifiers need damping, and the
# stability boundary tightens with the horizon (frac 0.1 needs γ ≤ 0.2
# over hundreds of rounds, the milder frac 0.3 holds at 0.5), as in the
# JAX driver
CODECS = {
    "none": None,
    "int8": Compression(codec="int8"),
    "fp8": Compression(codec="fp8"),
    "topk": Compression(codec="topk", topk_frac=0.1, gamma=0.2),
    "qtopk": Compression(codec="qtopk", topk_frac=0.3, gamma=0.5),
}


def _wire_per_round(hist) -> int:
    wb = np.asarray(hist.get("wire_bytes", [0]))
    return int(np.median(wb)) if wb.size else 0


def _codec_record(codec, comp, family, graph, n, rounds, base, **kw):
    hist, t = run_dfl_mlp(n_nodes=n, graph=graph, rounds=rounds, timing=True, compression=comp, **kw)
    wire = _wire_per_round(hist)
    base_wire, base_loss = base if base is not None else (wire, hist["test_loss"][-1])
    reduction = base_wire / max(wire, 1)
    delta_pct = 100.0 * (hist["test_loss"][-1] - base_loss) / base_loss
    rec = {
        "kind": "codec",
        "codec": codec,
        "family": family,
        "n": n,
        "model": "mlp",
        "rounds": rounds,
        "gamma": comp.gamma if comp is not None else 1.0,
        "wire_bytes_per_round": wire,
        "bytes_reduction_vs_fp32": reduction,
        "final_test_loss": hist["test_loss"][-1],
        "loss_delta_vs_fp32_pct": delta_pct,
        "compile_seconds": t["compile_seconds"],
        "us_per_round_steady": t["us_per_round_steady"],
        "meets_4x_2pct": bool(reduction >= 4.0 and delta_pct <= 2.0),
    }
    emit(f"fig12.{family}.{codec}.n{n}", t["us_per_round_steady"],
         f"wire={wire}B;x{reduction:.2f};loss={rec['final_test_loss']:.4f};delta={delta_pct:+.2f}%")
    return rec, (base_wire, base_loss)


def _fig1_codec_records(quick: bool, device=None):
    """The codec sweep on the paper's fig1 setup (the complete graph) and
    the sparse families where the topology's resistance shows."""
    # the horizon leaves the baseline well below chance (ln 10 ≈ 2.30), or
    # the relative loss delta is noise: 400 rounds of the quick MLP
    rounds = 400 if quick else 600
    n = 16 if quick else 32
    records = []
    sweeps = [("complete", T.complete(n)), ("kregular", T.random_k_regular(n, 4, seed=0))]
    if not quick:
        sweeps.append(("ring", T.ring(n)))
    for family, graph in sweeps:
        base = None
        for codec, comp in CODECS.items():
            rec, base = _codec_record(
                codec, comp, family, graph, n, rounds, base,
                per_node=64 if quick else 128, hidden=(64, 32) if quick else (128, 64),
                eval_every=max(rounds // 10, 1), device=device,
            )
            records.append(rec)
    return records


def _token_windows(cfg, n: int, items: int, seq: int):
    """Each node's next-token windows (xs, ys (n, items, seq) int32, from
    ``make_token_stream`` seeded by the node) and the held-out batch (16
    windows of stream n), as the JAX driver cuts them."""
    win = (np.arange(items) * seq)[:, None] + np.arange(seq + 1)

    def windows(seed):
        t = make_token_stream(items * seq + 1, cfg.vocab_size, seed=seed)[win]
        return t[:, :-1].astype(np.int32), t[:, 1:].astype(np.int32)

    per_node = [windows(i) for i in range(n)]
    ex, ey = windows(n)
    return np.stack([x for x, _ in per_node]), np.stack([y for _, y in per_node]), (ex[:16], ey[:16])


def _transformer_records(quick: bool, device=None, rounds: int | None = None):
    """The reduced qwen2.5-3b through ``run_trajectory`` on a ring of 8,
    codec none against int8 (``rounds``: default 8 quick, 24 full)."""
    dev = resolve_device(device)
    n = 8
    rounds = rounds or (8 if quick else 24)
    seq = 32 if quick else 64
    items = 32 if quick else 128
    bs, b_local = 4, 2
    cfg = get_reduced_config("qwen2.5-3b")
    xs, ys, test = _token_windows(cfg, n, items, seq)
    loss_fn = TF.node_loss(cfg)  # lm_loss + 0.01 · aux, one forward a node
    graph = T.ring(n)
    opt = sgd(1e-3, 0.5)

    def init_one(g, gains):
        return TF.init_params(g, cfg, InitConfig("trunc_normal", gains), device=g.device)

    state = init_fl_state(0, n, init_one, opt, gains=2.0, device=dev)
    d_node = state.layout.size
    sched = batch_index_schedule(items, n, bs, rounds * b_local, seed=0)
    eval_fn = make_eval_fn(loss_fn)

    records, base = [], None
    for codec in ("none", "int8"):
        comp = CODECS[codec]
        rf = make_round_fn(loss_fn, opt, graph, device=dev, compression=comp)
        timer = ChunkTimer()
        t0 = time.perf_counter()
        _, hist = run_trajectory(
            state, rf, xs, ys, sched, n_rounds=rounds, eval_every=max(rounds // 4, 1), eval_fn=eval_fn,
            eval_batch=test, b_local=b_local, chunk_size=max(rounds // 4, 1), on_chunk=timer, device=dev,
        )
        sec = (time.perf_counter() - t0) / rounds
        compile_s, steady = timer.split()
        wire = _wire_per_round(hist)
        if base is None:
            base = (wire, hist["test_loss"][-1])
        reduction = base[0] / max(wire, 1)
        delta_pct = 100.0 * (hist["test_loss"][-1] - base[1]) / base[1]
        rec = {
            "kind": "transformer",
            "codec": codec,
            "family": "ring",
            "n": n,
            "model": cfg.name,
            "rounds": rounds,
            "params_per_node": d_node,
            "gamma": comp.gamma if comp is not None else 1.0,
            "wire_bytes_per_round": wire,
            "bytes_reduction_vs_fp32": reduction,
            "final_test_loss": hist["test_loss"][-1],
            "loss_delta_vs_fp32_pct": delta_pct,
            "compile_seconds": compile_s,
            "us_per_round_steady": steady * 1e6,
            "sec_per_round": sec,
            "curve_round": hist["round"],
            "curve_test_loss": hist["test_loss"],
        }
        records.append(rec)
        emit(f"fig12.transformer.{codec}.n{n}", steady * 1e6,
             f"params={d_node};wire={wire}B;x{reduction:.2f};loss={rec['final_test_loss']:.4f};"
             f"delta={delta_pct:+.2f}%")
    return records


def run(quick: bool = True, device=None, out_path: str | pathlib.Path = "build/fig12_compress.json") -> dict:
    dev = resolve_device(device)
    records = _fig1_codec_records(quick, dev)
    records += _transformer_records(quick, dev)
    winners = [r for r in records if r["kind"] == "codec" and r["family"] == "complete" and r["meets_4x_2pct"]]
    emit("fig12.acceptance", 0.0, f"codecs_meeting_4x_2pct={','.join(r['codec'] for r in winners) or 'NONE'}")
    result = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "cpu_count": os.cpu_count(),
        "quick": quick,
        "records": records,
    }
    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2))
    print(f"# wrote {out}", flush=True)
    return result


main = driver_main(run, __doc__)

if __name__ == "__main__":
    main()
