#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints its own lines and any failed check stops the
run with a non-zero exit:

1. header  — the card's name and power limit, torch and CUDA versions;
2. build   — nvcc builds every kernel library from ``src/repro_torch/kernels``
   (mixing, quantised mixing, flash attention and the RWKV-6 time-mix, all
   at once) and prints ptxas registers and spills; the flash library
   (every dtype and head dim) and the rwkv library (every head dim, dtype
   and launch path) print every entry and must spill nothing, the flash
   SASS must hold wgmma (``HGMMA``) and TMA loads (``UTMALDG``), the rwkv
   SASS mma.sync (``HMMA``); the dense mix and the two block-sparse
   libraries (``mix``, ``mix_bsr``, ``quant_mix``) print every entry's
   registers and spills and must spill nothing, and the dense mix's wide
   route must hold its 8-byte W loads (``LDG.E.64``) in SASS;
3. kernels — each hand-written kernel against its plain PyTorch version on
   the card (dense: n ∈ {8, 16, 32, 64} × d ∈ {567434, 1000, 1} fp32 plus
   one bf16 shape and fig11's widths (32, 52,650), (64, 109,386) and (16,
   25,450), every dense case naming the route it launched on (``thin`` or
   ``wide``, ``dense_route``); the dense mix's crossover sweep, both routes
   at n ∈ {8, 16, 64, 256} × d ∈ {1, 2, 3, 4, 8, 16, 32, 64, 128, 1000}
   beside torch.matmul, with the widest d at which the thin route is held
   faster at every n; block-sparse: ring-1024 at bn 32 (fp32 and bf16),
   random-4-regular-1024 at bn 32 and 64, heavy-tail-40 at bn 8, one masked
   round with all-zero tiles, each also bitwise ``mix_bsr_rows_ref`` on 4096
   columns; flash attention:
   every shape phase 7 launches, in the decoder's (B, S, H, hd) layout
   (qwen2.5-3b prefill 4 × 2048 and per-node serve 1 × 512, gemma3-4b
   global and local layers 2 × 2048), contiguous bf16 shapes, ragged bf16
   shapes (S 1 to 2047, hd 64 / 128 / 256, GQA groups 1 / 2 / 8, windows
   0 / 17 / 1024, both layouts), bf16 at hd 32, ragged fp32 shapes at
   every hd and fp32 at the full-width prefill shapes (qwen2.5-3b 4 × 2048
   hd 128, gemma3-4b 2 × 2048 hd 256 global and windowed), each case
   checking its route (``route``: wgmma for bf16, wgmma_tf32x3 for fp32),
   and timings at the four bf16 main-path shapes against SDPA, at phase 8's
   fp32 shape and at the full-width fp32 shapes against SDPA in fp32, each
   as a caller pays for it (unheld) and in device time (held), with the
   call's host time; the
   RWKV-6 time-mix: every shape phase 7 launches (rwkv6-3b prefill
   4 × 2048, per-node serve 1 × 512 and one 16,384-token prompt, bf16 r/k/v
   and fp32 w in the decoder's layout), ragged bf16 and fp32 shapes at
   M 32 / 64 / 128 with and without an initial state, and extreme decays,
   each case checking its route (``route``: tc for bf16, tc_fp32 for fp32);
   out and final state both checked; timings at those shapes, at phase
   8's, at rwkv6-3b 4 × 2048 in fp32 and at M 128, each launch's device
   time read from ``torch.profiler``; an empty kernel's time, the floor of
   a launch-bound row; after the timings (after a profiler session later
   launches can take more host time), the one-launch path (L ≤ 128)
   at phase 8's shape: one device kernel, out bitwise the three-launch
   path's); the quantised mix (the one-launch dense round,
   and the scales pass and block-sparse walk) at complete-16 and ring-1024
   with the paper MLP's 281-chunk table, int8 and fp8, round mode at γ 1
   and 0.5, raw mode (the Pallas kernel's function) in fp32 and bf16, a
   masked round and the scale floors' edge cases, the dense round's wide
   route (chunks of 65,536 columns) and complete-64, and int8 / fp8 rounds
   at kreg4-1024, scales and new mirrors bitwise, each dense round checking
   its route; two launches bitwise equal, and timings at the main path's
   shapes (the dense round at complete-16 and complete-64); both block-sparse walks timed at ring-1024 and
   kreg4-1024 against the tile walks they replaced (``TILE_WALK_MS``), which
   they must beat at ring-1024; at VGG16's width (d = 33,638,218): the dense
   mix at n = 16 and 64 (n·d > 2^31), n = 16 timed against its byte bound,
   and the int8 dense round at VGG16's 16,437-chunk table, scales and H'
   bitwise, its route checked and timed, and at complete-64 (n·d > 2^31)
   its columns past a 32-bit offset against the plain version; the int8
   dense round at complete-8 on the reduced qwen2.5-3b's row and chunk
   table (phase 4j's ``--model transformer``); flash at the
   head dims it runs zero-padded (hd 30 fp32, 40 and 160 bf16; causal,
   windowed and not causal) and timed at stablelm-12b's prefill and the
   reduced configs' shapes; the gossip shapes, a round of
   ``CommPlan.spread``: mix_matmul over the dense Mᵀ of complete-8,
   kreg4-8 (phase 4j's health reports), complete-16, kreg4-16, kreg4-64 and
   kreg4-256 (held at most 1.25 × torch.matmul's time, the share within 5%
   printed), mix_bsr over the BSR Mᵀ of ring-1024, kreg4-1024
   and heavytail-1024, at d ∈ {1, 2, 3, 4}, each timed against its bound and
   torch.matmul / torch.sparse.mm; the compressed exchange of an
   asynchronous event (``quant_mix_pair``: the dense round over the pair's
   two rows with its 2 × 2 operator) at full width, int8 and fp8, γ 1 and
   0.5, against the plain version in the JAX pairwise form (scales and H'
   bitwise, X' within fp32 rounding), timed against its bound; flash at
   the new configs' serve shapes (granite-moe-1b-a400m 4 × 2048 and
   1 × 512, qwen1.5-4b and stablelm-12b 4 × 2048, the swa variant's
   1 × 16,384 at window 8192, its plain version one head at a time) and
   their reduced fp32 prefills (2 × 40), timed at the new bf16 prefills;
   the dense mix and the int8 dense round at ``--model moe``'s n = 8 over
   the reduced granite-moe's row; flash at phase 7d's prefills (jamba 2 ×
   2048 GQA 64 / 8, llava 2 × 4096, musicgen 4 × 2048 MHA hd 64,
   llama4-scout 2 × 2048 GQA 40 / 8, a group of 5), timed, and at their
   reduced fp32 prefills (2 × 40, or 48 with the frontend embeddings);
   phase 4l's shapes: the dense mix at n = 8 over the reduced rwkv6-3b's,
   jamba's and llava's rows, rwkv at the ``--model rwkv`` eval (64 × 64,
   fp32), each timed;
4. quickstart — the ported example, ``repro_torch/examples/quickstart.py``
   (``run_sweep``): He init plateaus at ln 10, the gain-corrected init
   descends, 80 dense kernel launches;
4b. compressed quickstart — the gain-corrected quickstart with codecs none,
   int8, fp8 and qtopk (frac 0.3, γ 0.5): int8 and fp8 end within 2% of
   the uncompressed test loss, every int8 / fp8 round one launch of the
   dense round (no scales pass), qtopk's rounds dense-kernel launches;
4c. paper cfg B and C — the CNN through the CLI (BA(m=8)-16, Zipf α 1.8,
   30 rounds): the gain-corrected init diverges from round 0 and He stays on
   the ln 17 plateau, as the JAX package's CLI shows on the CPU; the CLI's
   VGG16 (width 0.25, kreg4-16, 2 rounds, 2 dense launches); VGG16 at
   full width (d = 33,638,218 a node, kreg4-16, He init): 2 rounds, then 2
   int8 rounds, exact launch counts (2 dense mixes, then 2 dense int8
   rounds), finite losses; one round run three times from one state, bitwise
   equal; its local steps and mix timed apart, the conv weights' relayout,
   σ and peak memory;
4d. figures — ``repro_torch.benchmarks.fig1_scaling`` quick (400 rounds at
   n 8 / 16 / 32, He and proposed): the proposed init leaves the plateau
   first at every n and the He plateau ends within the 400 rounds at n = 8
   only, as in the JAX package's run, 2,400 dense launches, its wall time;
   fig. 3's diffusion
   model (kreg32-256): σ_ap within 5% of σ_init‖v_steady‖, the card's
   trajectory the CPU's (the same draws) to 1e-6;
4e. uncoordinated init (§4.4) — the gossip engine at kreg4-1024 and
   heavytail-1024 (sparse, link_p 0.9, 32 + 32 rounds): mass kept, reruns
   bitwise, the card equal to the CPU, one mix_bsr launch a round; µs a
   gossip round (dense n = 64, sparse n = 1024), the compressed send form
   (int8) card vs CPU, the port's estimates_bench quick rows; the ported
   ``examples/uncoordinated_init.py`` at the paper MLP's full width
   (kreg4-16, link_p 0.8, budgets 4 and 32): He within 0.01 of ln 10, the
   budget-32 run below 2.0, its gains the CPU's to 1e-4, its round time;
   fig4 quick through the port's driver, every row finite; the CLI with
   ``--uncoordinated-init`` at kreg-16 and ring-1024 (leader: the reached
   nodes the CPU's, the others at gain 1.0; leaderless: finite losses).
   Every gossip launch's (kernel, n, d) must be among phase 3's, and the
   counts one launch a round;
4f. time-varying topologies and the edge-coloured backend — a K = 1
   ``PlanSchedule`` bitwise its static plan at complete-16 (dense) and
   kreg8-256 (sparse), full width: a mix, a spread, an int8 round and the
   wire count, clean and at link_p 0.8; the CLI with ``--topology-schedule
   churn`` (kreg4-256, 8 snapshots at churn 0.2, the leaderless warmup, 6
   rounds): finite losses, one mix_bsr launch a training and a gossip round
   (38), each plan's Mᵀ built once, each plan's mix_bsr at full width and
   over its Mᵀ at d = 1–2 and its int8 round (scales pass and walk)
   against the plain version, mix_bsr timed against the static graph's, one
   int8 round a plan through the schedule (8 + 8 launches); each plan of
   the BA-16 schedule's dense mix and int8 round against the plain
   version (the kernels line's schedule rows: those errors, plan 3's
   times); card vs CPU for a K = 4 churned BA-16 schedule at link_p
   0.8, 3 rounds, uncompressed and int8 (phase 5's bounds, code flips
   counted); the ppermute backend at complete-16 and heavytail-64, full
   width, against the dense kernel (clean and masked) and timed against it;
   ``run_dfl_mlp(timing=True)``'s split and a chunked run bitwise the
   unchunked one; fig8 quick and the rounds bench quick at 40 rounds a
   trajectory (their JSON under ``build/``);
4g. event-driven gossip — the CLI with ``--async`` at full width on
   kreg4-16 (20 units of virtual time): plain (no listed kernel launches,
   messages twice the events), ``--compress int8`` (one ``quant_mix_dense``
   launch an event, all staged, the final test loss within 2% of the
   plain run's) and ``--uncoordinated-init --estimate-rounds 32 --link-p
   0.8 --local-batches 2``, each timed as a caller pays (µs an event);
   one event step eager
   against the same step replayed as a CUDA graph (the host / device
   split), its device operations and its host self time by kind of
   operator (profiler); ``push_sum_events`` and
   ``estimate_size_leaderless_events`` at kreg4-1024, card vs CPU; a BA-16
   event trajectory at link_p 0.8 with int8 exchanges, card vs CPU on the
   same draws (rtol 1e-4, code flips counted, each within one step);
   ``event_mix_batch`` bitwise the sequential ``event_mix`` on the card;
   fig9 quick on its ring family alone, n = 16 and 32
   (``build/fig9_async.json``; the executor's wire bytes held to the
   stream's messages);
4h. live serving under gossip — the serve CLI at its defaults (ring-16,
   full-width MLP, 30 units of virtual time, qps 4) and at qps 0: no listed
   kernel launches, µs an event and a query as a caller pays; on the card
   ring-16 at link_p 0.8: qps 0 bitwise ``run_event_trajectory``, qps 5
   bitwise qps 0's training; ring-6 card vs CPU (routing arrays and
   answers equal, losses to rtol 1e-4); fig13 quick (its ring family
   alone, 6 of 12 records, for the script's time) with its acceptance
   assertion (``build/fig13_serve.json``); the consensus example (30 AdamW
   DecAvg rounds of the reduced qwen2.5-3b on kreg4-8, then consensus and
   routed serving: one ``mix_matmul`` launch a round at n = 8, one fp32
   flash launch a prefill layer, every key among phase 3's), and 3 rounds
   of it card vs CPU (greedy tokens equal); one decoder training step's
   gradient card vs CPU with no flash launch under grad, and a
   grad-recording ``flash_mha`` / ``rwkv6_chunked`` call raising;
4i. elastic membership and checkpoints — the CLI's ``--elastic --join-nodes
   4 --fault-scenario crash`` at its defaults (complete-16, full width, 100
   rounds: 4 slots arrive at round 50 and initialise at 58 from their own
   sketches, 2 nodes down over rounds 33–42), plain and ``--compress int8``:
   ms a round as a caller pays, n_active the masks' own, the online n̂,
   exactly 100 ``mix_matmul`` / ``quant_mix_dense`` (staged) launches, int8
   within 5% of plain; a crash-window round's masked operator through
   ``mix_matmul`` and the int8 round with the members' keep mask against
   the plain versions; ``run_trajectory``, ``run_event_trajectory`` and
   ``run_elastic_trajectory`` at full width (kreg4-16, link_p 0.8) each
   killed by ``SIGKILL`` after chunk 0 in a child process, then resumed
   from the directory in another: state and history bitwise the
   uninterrupted run's; a checkpoint's bytes, restore ms and save ms (the
   chunked run with and without a checkpoint a chunk, in turns); the CLI's
   elastic run on kreg4-256 (crash+partition, 16 joiners, 20 rounds, one
   ``mix_bsr`` launch a round) and a partition round's masked BSR operator
   against the plain walk; kreg4-8 card vs CPU on the same draws; fig11
   quick (``build/fig11_elastic.json``, resume parity bit-exact, 388 dense
   launches);
4j. telemetry and the rest of the training CLI — ``--telemetry`` at
   complete-16 on the full-width MLP, 20 rounds plain then 20 int8: the
   port's ``validate_run_log`` passes, 1 manifest + 20 rounds + 1 summary +
   1 ``gossip_health``, 240 messages a round, bytes = messages × the row
   (priced by the codec for int8), exactly 20 ``mix_matmul`` / 20
   ``quant_mix_dense`` launches besides the health report's spreads;
   ring-1024 (sparse, link_p 0.9): every round's count the masked
   operator's off-diagonal entries, the mass drift below the CPU test's
   fp32 level; ``--async`` and ``--elastic`` on kreg4-16 (bin rows with
   messages; the masks' own live edges); the serve CLI's log with 16 query
   records; ``--profile-trace`` of the complete-16 run in a child process:
   every ``mix_wide_kernel`` launch inside a ``dfl_mix`` range, the device
   and host ms a round of ``dfl_local`` / ``dfl_mix`` / ``dfl_eval`` (and of
   3 ring-1024 rounds); ``--model transformer --compress int8`` and ``--arch
   qwen2.5-3b --reduced --legacy-loop``; a kreg4-8 log card vs CPU from one
   CPU init (kinds, keys, counts and wire channels equal, losses to 1e-4);
4k. ``--model moe`` and the measurement drivers — the CLI's ``--model moe``
   (the reduced granite-moe through the executor, n = 8, 3 rounds) plain
   and ``--compress int8``: exact launch counts, every mix and flash shape
   among phase 3's, and a run log card vs CPU from one CPU init (losses
   to rtol 1e-4); ``python -m repro_torch.benchmarks.run --quick fig12
   kernels`` in a child process, exit 0: fig12's wire bytes and reductions
   equal to the JAX package's ``BENCH_compress.json`` codec by codec, its
   losses and acceptance row printed, every kernels_bench error within
   phase 3's tolerance for its kernel; ``kernels_bench.run_mixing`` at its
   defaults, its rows printed;
4l. RWKV training, mamba and frontend configs — ``--model rwkv`` (the
   reduced rwkv6-3b through the executor, n = 8, 3 rounds: recorded
   forwards through the plain chunked time-mix, each eval's time-mix through
   the rwkv kernel) and ``--arch jamba-1.5-large-398b / rwkv6-3b /
   llava-next-mistral-7b --reduced`` (host-fed): exact launch counts (no
   kernel under grad, one DecAvg launch a round, 48 eval rwkv launches),
   every mix and rwkv shape among phase 3's, losses card vs CPU from one CPU
   init to rtol 1e-4;
5. card vs CPU — complete-8 from one numpy init, 3 rounds on each device,
   uncompressed and int8 (quantisation-code flips counted, each within one
   code step), and the paper CNN (He init);
6. CLI     — ``repro_torch.launch.train`` on a 1024-node ring (sparse
   backend, 3 block-sparse launches; then ``--compress int8``, 3 quantised
   block-sparse launches);
7. serve, full width — qwen2.5-3b in bf16: a 4-node ring ensemble, its
   consensus served by ``ServeEngine.generate`` (4 × 2048-token prompts, 32
   new tokens), ``ServeEngine.serve`` per node (4 × 512, 8 new) and
   ``prefill``, one decode step timed eager and replayed as a CUDA graph
   (the step's device time without host dispatch); then gemma3-4b
   (2 × 2048, past its 1024 window, 16 new); then rwkv6-3b (a 4-node ring
   ensemble: consensus generate 4 × 2048 → 32, prefill 4 × 2048, one
   16,384-token prompt, 8 decode steps and one replayed as a CUDA graph,
   per-node serve 4 × 512 → 8).
   Every prefill attention layer is one flash kernel launch (bf16: every
   one on the wgmma route) and every prefill RWKV layer one rwkv kernel
   launch (bf16: every one on the tc route): the counts are exact, and the
   key of each launch must be among those phase 3 checked;
7b. traced prefills, in a process of their own (``chip_smoke.py
   --traced-prefills``) — one qwen2.5-3b 4 × 2048 prefill under
   ``torch.profiler``: the top device kernels and flash's share of device
   time; and, as a diagnostic, the last position's logits against the same
   prefill with attention through ``attention_ref``; then one rwkv6-3b
   4 × 2048 prefill: the top device kernels and the rwkv kernel's share;
7c. serve, full width: the new configs — one model at a time, each freed
   before the next with its peak memory printed: granite-moe-1b-a400m (a
   4-node ring ensemble: consensus generate 4 × 2048 → 32, two prefills
   bitwise equal, 8 decode steps and one replayed as a CUDA graph,
   per-node serve 4 × 512 → 8), qwen1.5-4b (a 4-node ensemble beside its
   consensus: generate 4 × 2048 → 32, a prefill, 8 decode steps),
   stablelm-12b (one parameter set: a prefill 4 × 2048, generate → 16, 8
   decode steps) and the swa variant of qwen2.5-3b (one 1 × 16,384
   prefill); exact flash launch counts, every key among phase 3's, all on
   the wgmma route;
7d. serve, full width: mamba and the frontends — one model at a time in
   bf16, each freed before the next with its peak memory printed:
   jamba-1.5-large-398b cut to 5 layers (4 mamba blocks, 2 with the MoE
   FFN, and the attention block; one parameter set: a cached prefill and a
   forward prefill of 2 × 2048 that agree, 8 decode steps, one replayed as
   a CUDA graph bitwise the eager step, the mamba scans timed in a third
   prefill, peak ≤ 75 GiB), llava-next-mistral-7b (a 2-node ensemble's
   consensus: 2 × (2880 seeded patch embeddings + 1216 tokens), both
   prefills, 8 decode steps), musicgen-large (a 4-node ring ensemble's
   consensus: 4 × (256 conditioning embeddings + 1792 tokens), both
   prefills, 8 decode steps and one replayed as a CUDA graph) and
   llama4-scout-17b-a16e cut to 8 layers (2 × 2048 text tokens, both
   prefills, 8 decode steps); exact flash launch counts (1, 32, 48 and 8 a
   prefill), every key among phase 3's, all on the wgmma route;
8. serve, card vs CPU — reduced qwen2.5-3b, gemma3-4b, rwkv6-3b,
   granite-moe-1b-a400m, stablelm-12b, qwen1.5-4b, jamba-1.5-large-398b,
   llava-next-mistral-7b and musicgen-large (8 frontend embeddings before
   the prompt, in the prefill and a greedy decode from its cache) and
   llama4-scout-17b-a16e in fp32 from one init: equal greedy tokens,
   prefill logits to rtol 1e-4 (the attention on the flash kernel's
   wgmma_tf32x3 route, the time-mix on the rwkv kernel's tc_fp32 route,
   each prompt of 40 in one launch); the MoE configs' routing choices that
   differ card vs CPU counted, each with its top-k margin.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # tensor cores: bf16 products with fp32 accumulation
PEAK_TF32_FLOPS = 495e12  # tensor cores: TF32 products with fp32 accumulation
FP32_TOL = 1e-5  # × max|W|: one fp32 FMA chain vs cuBLAS's blocked sum
# The tile walks (bn FMAs per tile row) that the walks over the nonzeros of M
# replaced, as this script's phase 3 timed them on an NVIDIA H100 80GB HBM3
# at 700 W.  Phase 3 fails unless the walks at ring-1024 beat them.
TILE_WALK_MS = {("mix_bsr", "ring-1024"): 4.7063, ("mix_bsr", "kreg4-1024"): 42.3145,
            ("quant_mix_bsr", "ring-1024"): 19.7464, ("quant_mix_bsr", "kreg4-1024"): 100.2908}
# bf16 output, elementwise: one bf16 ulp of |ref| (the two fp32 sums, taken
# in different orders, may round to neighbouring bf16 values) plus the fp32
# atol.  A kernel that accumulated in bf16 would be off by several ulps.
BF16_RTOL = 2.0**-7
# phase 7d: the depth cuts of the two configs too large for one card at
# full width (jamba at 5 layers keeps every kind of layer: 4 mamba blocks,
# the MoE FFN at layers 1 and 3, the attention block at 4), and its prompts
JAMBA_LAYERS, LLAMA4_LAYERS = 5, 8
LLAVA_PATCHES, LLAVA_TEXT = 2880, 1216  # anyres: 576 base + 4 × 576 tiles, then text
MUSICGEN_COND, MUSICGEN_TEXT = 256, 1792  # T5 conditioning embeddings, then EnCodec tokens
NEW_ARCHS = ("jamba-1.5-large-398b", "llava-next-mistral-7b", "musicgen-large", "llama4-scout-17b-a16e")
# idle trace before and after a profiled call (see ``traced``)
TRACE_MARGIN_S = 0.1
# traces of one call before ``traced`` gives up on a complete one
TRACE_ATTEMPTS = 3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, reps: int = 7, flush=None, hold: bool = False) -> float:
    """Median CUDA-event time of one call, with L2 flushed before each.  With
    ``hold`` the stream first spins ~0.5 ms, so the whole call is queued
    before the start event fires: the wrapper's host time (checks, output
    allocation) is not counted, the gaps between its launches are."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if hold:
            torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def host_ms(fn, reps: int = 21) -> float:
    """Median host time of one call, the stream idle before it: from the
    call to its return, what the caller's thread spends to launch it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


def traced(call, want=None, before=None):
    """``call()`` under torch.profiler: (its result, the profile, its wall
    seconds until the card finished).  The trace window opens
    ``TRACE_MARGIN_S`` before the call and closes ``TRACE_MARGIN_S`` after
    the card has finished, so that no launch lies near an edge.

    The profiler can still lose device events: runs of this script on an
    H100 lost all three kernels of one rwkv layer from a traced 4 × 2048
    prefill (31 of 32 launches each, the wrapper's count 32), once with the
    window closing right after the synchronize and once with the margins,
    the lost layer then inside the window (the trace's first and last
    kernels were the embedding's and the head's).  So ``want`` maps a
    device kernel name's substring to the launches a complete trace of
    ``call`` holds; a trace short of them is printed and ``call`` traced
    again, ``before()`` first each time, up to ``TRACE_ATTEMPTS`` traces.
    The last trace is returned either way: the caller's check of its counts
    fails if none was complete."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        if before is not None:
            before()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_MARGIN_S)
            t0 = time.perf_counter()
            got = call()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            time.sleep(TRACE_MARGIN_S)
        if not want:
            break
        held = trace_counts(prof, want)
        if held == want:
            if attempt > 1:
                print(f"  trace {attempt} of {TRACE_ATTEMPTS} complete: {held}")
            break
        print(f"  trace {attempt} of {TRACE_ATTEMPTS} lost device events: {held}, want {want}; {trace_edges(prof)}")
    return got, prof, wall_s


def trace_counts(prof, names) -> dict[str, int]:
    """Device launches in a trace whose kernel name holds each of ``names``."""
    import torch

    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {name: sum(e.count for e in dev if name in e.key) for name in names}


def trace_edges(prof) -> str:
    """The first and last device kernels of a trace, in time order: which
    edge of the window an event went missing from."""
    import torch

    dev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    return f"first {[e.name[:60] for e in dev[:3]]}, last {[e.name[:60] for e in dev[-3:]]}"


def bound(bytes_moved: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_entries(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill bytes) of every entry in nvcc's ``-Xptxas -v``
    report, the names demangled where ``c++filt`` is installed."""
    entries, name, spill = [], "", 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            entries.append((name, int(m.group(1)), spill))
            name = ""
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        out = subprocess.run(["c++filt"], input="\n".join(e[0] for e in entries), capture_output=True,
                             text=True, check=True).stdout.splitlines()
        if len(out) == len(entries):
            entries = [(o.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void "), r, sp)
                       for o, (_, r, sp) in zip(out, entries)]
    return entries


def sass_functions(sass: str) -> dict[str, str]:
    """``cuobjdump -sass`` split by function: mangled name -> its code."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = ""
        elif name is not None:
            out[name] += line + "\n"
    return out


def phase(name: str) -> None:
    print(f"\n=== {name} ===", flush=True)


def kernel_counters():
    """The port's kernel wrappers (each counts the launches it makes) and a
    function that sets every count, by route too, to 0."""
    from repro_torch.kernels.flash import ROUTES, flash_mha
    from repro_torch.kernels.mix import mix_bsr, mix_matmul, quant_mix_bsr, quant_mix_dense, quant_scales
    from repro_torch.kernels.mix import mix as mix_kernel
    from repro_torch.kernels.rwkv import rwkv as rwkv_kernels
    from repro_torch.kernels.rwkv import rwkv6_chunked

    kernels = [mix_matmul, mix_bsr, flash_mha, rwkv6_chunked, quant_scales, quant_mix_dense, quant_mix_bsr]

    def reset_counts():
        for kern in kernels:
            kern.launches = 0
        flash_mha.launches_by_route.update(dict.fromkeys(ROUTES, 0))
        rwkv6_chunked.launches_by_route.update(dict.fromkeys(rwkv_kernels.ROUTES, 0))
        rwkv6_chunked.one_launch = 0
        quant_mix_dense.launches_by_route.update(dict.fromkeys(quant_mix_dense.launches_by_route, 0))
        mix_matmul.launches_by_route.update(dict.fromkeys(mix_kernel.ROUTES, 0))

    return kernels, reset_counts


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

    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.configs.qwen2p5_3b import swa_variant
    from repro_torch.core import topology as T
    from repro_torch.core.commplan import FailureModel, compile_plan
    from repro_torch.core.compress import Compression
    from repro_torch.core.initialisation import InitConfig, gain_from_graph
    from repro_torch.core.mixing import receive_matrix, v_steady_norm
    from repro_torch.convert import params_from_numpy, params_to_numpy, state_from_numpy, to_numpy
    from repro_torch.data import (
        batch_index_schedule, cifar10_like, make_token_stream, mnist_like, node_datasets, partition_iid, so2sat_like,
    )
    from repro_torch.device import resolve_device
    from repro_torch.fed import (
        ServeEngine, consensus_params, decode_one, init_fl_state, make_eval_fn, make_round_fn, prefill,
        run_trajectory, run_warmup_trajectory, sigma_metrics,
    )
    from repro_torch.gossip import split_seed
    from repro_torch.fed.trainer import _local_steps as local_steps
    from repro_torch.fed.trainer import copy_state
    from repro_torch.flat import FlatLayout, tree_map
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash import HEAD_DIMS as FLASH_HEAD_DIMS
    from repro_torch.kernels.flash import ROUTES, attention_ref, flash_mha
    from repro_torch.kernels.flash import route as flash_route
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.mix import (
        BSR, bsr_from_dense, chunk_bounds, decavg_mix_ref, dense_route, mix_bsr, mix_bsr_ref, mix_bsr_rows_ref,
        mix_matmul,
        pallas_bounds, quant_mix_bsr,
        quant_mix_dense, quant_scales,
    )
    from repro_torch.kernels.mix import mix as mix_kernel
    from repro_torch.kernels.mix import ops as mix_ops
    from repro_torch.kernels.mix import quant as mix_quant
    from repro_torch.kernels.mix import pair_mix_ref, quant_mix_pair
    from repro_torch.kernels.mix.ref import quant_mix_ref, quant_scales_ref
    from repro_torch.kernels.rwkv import ops as rwkv_ops
    from repro_torch.kernels.rwkv import rwkv as rwkv_kernels
    from repro_torch.kernels.rwkv import rwkv6_chunked, rwkv6_chunked_ref
    from repro_torch import gossip as G
    from repro_torch.benchmarks import common as fig_common
    from repro_torch.benchmarks import estimates_bench, fig1_scaling, fig4_estimates, fig8_churn, rounds_bench
    from repro_torch.core.diffusion import run_diffusion
    from repro_torch.examples import quickstart, uncoordinated_init
    from repro_torch.launch import train as cli
    from repro_torch.models import transformer as TF
    from repro_torch.models.paper_models import (
        classifier_loss, cnn_forward, init_cnn, init_mlp, init_vgg16, mlp_forward, vgg16_forward,
    )
    from repro_torch.optim import sgd

    dev = resolve_device("cuda")
    kernels, reset_counts = kernel_counters()
    none_launched = {kern.__name__: 0 for kern in kernels}
    t_start = time.perf_counter()

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
    # registers and spills of every entry of the flash library (bf16 and
    # fp32 at hd 32 / 64 / 128 / 256), the rwkv library (its three kernels
    # and the one-launch output kernel at every head dim and dtype) and the
    # block-sparse walks' libraries; each instantiation is on the main path
    # or phase 3's, so none may spill
    for name in ("mix", "flash_sm90", "rwkv_sm90", "mix_bsr", "quant_mix"):
        entries = ptxas_entries(kbuild.build_log(name))
        for entry, regs, spill in entries:
            print(f"    {name}: {regs:3d} registers, {spill} bytes spilled  {entry}")
        check(bool(entries) and all(spill == 0 for _, _, spill in entries), f"{name} spills")
    # the products and loads must be the tensor-core and TMA instructions
    sass = kbuild.sass("flash_sm90")
    n_hgmma, n_utma = sass.count("HGMMA"), sass.count("UTMALDG")
    print(f"  flash_sm90 SASS: {n_hgmma} HGMMA, {n_utma} UTMALDG")
    check(n_hgmma > 0 and n_utma > 0, "flash_sm90 SASS lacks HGMMA or UTMALDG")
    # the dense mix's wide route reads W 8 bytes a thread a row
    wide_sass = "".join(body for name, body in sass_functions(kbuild.sass("mix")).items() if "mix_wide_kernel" in name)
    n_ldg64 = len(re.findall(r"\bLDG\.E\.64\b", wide_sass))
    print(f"  mix wide route SASS: {n_ldg64} LDG.E.64")
    check(n_ldg64 > 0, "mix_wide_kernel SASS lacks its 8-byte loads")
    n_hmma = kbuild.sass("rwkv_sm90").count("HMMA")
    print(f"  rwkv_sm90 SASS: {n_hmma} HMMA")
    check(n_hmma > 0, "rwkv_sm90 SASS lacks HMMA")

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
        # a mix_matmul case names its route and must launch on it, twice
        route = dense_route(*w.shape, w.dtype) if label.startswith("mix_matmul") else None
        by_route = dict(mix_matmul.launches_by_route)
        got = run()
        again = run()
        torch.cuda.synchronize()
        if route is not None:
            label = f"{label} [{route}]"
            check(mix_matmul.launches_by_route == {**by_route, route: by_route[route] + 2},
                  f"{label}: routes {mix_matmul.launches_by_route}, want two launches on {route}")
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

    # the block-sparse walk: against the plain tile walk at full width, and
    # bitwise against its rendering mix_bsr_rows_ref (the same FMA chains in
    # the same order) on the first 4096 columns
    def rows_bitwise(label, op_b, w):
        w_s = w[:, :4096].contiguous()
        same = bool(torch.equal(mix_bsr(*op_b, w_s), mix_bsr_rows_ref(*op_b, w_s)))
        print(f"    {label}: bitwise mix_bsr_rows_ref on 4096 columns {same}")
        check(same, f"{label}: the walk differs from mix_bsr_rows_ref")

    bsr_cases = [
        ("ring-1024 bn=32", T.ring(1024), 32),
        ("kreg4-1024 bn=32", T.random_k_regular(1024, 4, seed=0), 32),
        ("kreg4-1024 bn=64", T.random_k_regular(1024, 4, seed=0), 64),
        ("heavytail-40 bn=8", T.configuration_heavy_tail(40, 2.2, seed=0), 8),
    ]
    for label, g, bn in bsr_cases:
        m_np = receive_matrix(g).astype(np.float32)
        bc, tiles, counts = (torch.as_tensor(a, device=dev) for a in bsr_from_dense(m_np, bn))
        w = torch.randn(g.n, D_MAIN, generator=gen, device=dev)
        ref = mix_bsr_ref(bc, tiles, counts, w)
        e = compare(f"mix_bsr {label} d={D_MAIN}", lambda: mix_bsr(bc, tiles, counts, w), ref, w)
        rows_bitwise(f"mix_bsr {label}", (bc, tiles, counts), w)
        dense_err = float((ref - decavg_mix_ref(torch.as_tensor(m_np, device=dev), w)).abs().max())
        print(f"    plain BSR vs dense M·W: {dense_err:.3e}; real tiles {int(counts.sum())} "
              f"of {counts.numel() * bc.shape[1]} stored, per row block max {int(counts.max())} "
              f"of {-(-g.n // bn)}")
        check(dense_err <= FP32_TOL * float(w.abs().max()), f"{label}: BSR lowering disagrees with M")
        errs["mix_bsr"] = max(errs["mix_bsr"], e)
        del w, ref
    ring_bsr_np = bsr_from_dense(receive_matrix(T.ring(1024)).astype(np.float32), 32)
    ring_bsr_b = BSR(*(torch.as_tensor(a, device=dev) for a in ring_bsr_np))
    w = torch.randn(1024, D_MAIN, generator=gen, device=dev).to(torch.bfloat16)
    compare(f"mix_bsr ring-1024 bn=32 bf16 d={D_MAIN}", lambda: mix_bsr(*ring_bsr_b, w), mix_bsr_ref(*ring_bsr_b, w),
            w, bf16=True)
    rows_bitwise("mix_bsr ring-1024 bn=32 bf16", ring_bsr_b, w)
    del w

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

    # one masked sparse round: injected node/edge masks renormalise the
    # tiles; rows 64-127 inactive, so row blocks 2-3 keep only their self
    # weights and their neighbour tiles are all zero
    ring = T.ring(1024)
    plan_s = compile_plan(ring, "sparse", device=dev)
    plan_d = compile_plan(ring, "dense", device=dev)
    active = torch.as_tensor(rng.random(1024) < 0.8, device=dev)
    active[64:128] = False
    edge_live = torch.as_tensor(rng.random(plan_s.n_edges) < 0.7, device=dev)
    op = plan_s.round_operator(active=active, edge_live=edge_live)
    m_masked = plan_d.round_operator(active=active, edge_live=edge_live)
    real = torch.arange(op.tiles.shape[1], device=dev)[None, :] < op.counts[:, None]
    zero_tiles = int((real & (op.tiles.abs().sum((2, 3)) == 0)).sum())
    check(zero_tiles > 0, "masked round: no real tile is all zero")
    w = torch.randn(1024, D_MAIN, generator=gen, device=dev)
    e = compare(f"mix_bsr masked ring-1024 round ({zero_tiles} zero tiles)", lambda: mix_bsr(*op, w),
                decavg_mix_ref(m_masked, w), w)
    rows_bitwise("mix_bsr masked ring-1024 round", op, w)
    errs["mix_bsr"] = max(errs["mix_bsr"], e)
    del w
    kreg_np = receive_matrix(T.random_k_regular(1024, 4, seed=0)).astype(np.float32)
    kreg_bsr = BSR(*(torch.as_tensor(a, device=dev) for a in bsr_from_dense(kreg_np, 32)))

    # the row-block forms of kernels 1 and 2, the node-sharded round's calls
    # (core/shardplan.py) at the shapes S = 2 and S = 4 produce: every rank's
    # rows of complete-16's operator at the MLP width (r = 8 and 4), against
    # the plain version and bitwise the square call's rows; fig10 quick's
    # ring and kreg4 shards (nps 64, d 256) over their [local | halo]
    # buffers, the buffer widths read off the layouts, against the plain
    # tile walk, bitwise the walk's rendering, and to the tolerance the
    # unsharded product's rows
    m16_full = compile_plan(T.complete(16), "dense", device=dev).receive
    w16 = torch.randn(16, D_MAIN, generator=gen, device=dev)
    full16 = mix_matmul(m16_full, w16)
    errs["mix_matmul_rows"] = errs["mix_bsr_halo"] = 0.0
    for r in (8, 4):
        for rank in range(16 // r):
            block = m16_full[rank * r : (rank + 1) * r].contiguous()
            e = compare(f"mix_matmul_rows complete-16 r={r} rank {rank} d={D_MAIN}", lambda: mix_matmul(block, w16),
                        decavg_mix_ref(block, w16), w16)
            check(torch.equal(mix_matmul(block, w16), full16[rank * r : (rank + 1) * r]),
                  f"mix_matmul_rows r={r} rank {rank}: not the square call's rows")
            errs["mix_matmul_rows"] = max(errs["mix_matmul_rows"], e)
    block4 = m16_full[:4].contiguous()
    b_r, op_r = bound(4 * 4 * 16 + 4 * 16 * D_MAIN + 4 * 4 * D_MAIN, 2 * 4 * 16 * D_MAIN)
    timing_rows = {}
    timing_rows["mix_matmul_rows"] = dict(
        ms=time_ms(lambda: mix_matmul(block4, w16), flush=flush),
        plain_ms=time_ms(lambda: decavg_mix_ref(block4, w16), flush=flush),
        library_ms=time_ms(lambda: torch.matmul(block4, w16), flush=flush),
        bound_ms=b_r, bound_by=op_r, shape=f"complete-16 rows 0-3 (S = 4) d={D_MAIN} fp32",
        dense_route=dense_route(16, D_MAIN, torch.float32),
    )
    del w16, full16
    from repro_torch.core.shardplan import _layouts, _local_op

    halo_cases = {}
    for fam, build_g in (("ring", T.ring), ("kreg4", lambda n_g: T.random_k_regular(n_g, 4, seed=0))):
        for n_sh in (2, 4):
            n_g = 64 * n_sh
            plan_h = compile_plan(build_g(n_g), "sparse", device=dev)
            recv_h, _ = _layouts(plan_h, n_sh)
            x_h = torch.randn(n_g, 256, generator=gen, device=dev)
            full_h = mix_bsr(*plan_h.bsr, x_h)
            for rank in range(n_sh):
                op_h = _local_op(recv_h, rank, plan_h.bsr.block_n, dev)
                halo = recv_h.send[:, rank, : recv_h.h_max] + np.arange(n_sh)[:, None] * recv_h.nps
                buf = torch.cat([x_h[rank * 64 : (rank + 1) * 64],
                                 x_h[torch.as_tensor(halo.reshape(-1), dtype=torch.int64, device=dev)]])
                label = f"mix_bsr_halo {fam}-{n_g} S={n_sh} rank {rank} ({buf.shape[0]} buffer rows)"
                e = compare(label, lambda: mix_bsr(*op_h.bsr, buf, 64), mix_bsr_ref(*op_h.bsr, buf, 64), buf)
                got_h = mix_bsr(*op_h.bsr, buf, 64)
                check(torch.equal(got_h, mix_bsr_rows_ref(*op_h.bsr, buf, 64)), f"{label}: not the walk's rendering")
                off = float((got_h - full_h[rank * 64 : (rank + 1) * 64]).abs().max())
                check(off <= FP32_TOL * float(x_h.abs().max()), f"{label}: {off} off the unsharded rows")
                errs["mix_bsr_halo"] = max(errs["mix_bsr_halo"], e)
                halo_cases[(fam, n_sh, rank)] = (op_h, buf, recv_h)
    # the timed row: kreg4-256 at S = 4, rank 0
    op_h, buf, recv_h = halo_cases[("kreg4", 4, 0)]
    bn_h = op_h.bsr.block_n
    local_dense = torch.zeros(-(-64 // bn_h) * bn_h, -(-buf.shape[0] // bn_h) * bn_h, device=dev)
    for i, cnt in enumerate(op_h.bsr.counts.tolist()):
        for t_i in range(cnt):
            c_b = int(op_h.bsr.block_cols[i, t_i])
            local_dense[i * bn_h : (i + 1) * bn_h, c_b * bn_h : (c_b + 1) * bn_h] = op_h.bsr.tiles[i, t_i]
    local_dense = local_dense[:64, : buf.shape[0]].contiguous()
    nnz_h = int((local_dense != 0).sum())
    local_csr = local_dense.to_sparse_csr()
    check(float((torch.sparse.mm(local_csr, buf) - mix_bsr(*op_h.bsr, buf, 64)).abs().max())
          <= FP32_TOL * float(buf.abs().max()), "mix_bsr_halo: torch.sparse.mm computes another function")
    # bytes the function needs: each nonzero's weight and column index (4 B
    # each), the buffer rows some nonzero reads (the rank's padded slot of
    # the halo is read by none), the output written once
    rows_read_h = int((local_dense != 0).any(0).sum())
    bytes_h = 8 * nnz_h + 4 * 256 * rows_read_h + 4 * 64 * 256
    b_h, op_hb = bound(bytes_h, 2 * nnz_h * 256)
    timing_rows["mix_bsr_halo"] = dict(
        ms=time_ms(lambda: mix_bsr(*op_h.bsr, buf, 64), flush=flush),
        plain_ms=time_ms(lambda: mix_bsr_ref(*op_h.bsr, buf, 64), flush=flush),
        library_ms=time_ms(lambda: torch.sparse.mm(local_csr, buf), flush=flush),
        bound_ms=b_h, bound_by=op_hb, bytes=bytes_h,
        shape=f"kreg4-256 S=4 rank 0: 64 rows over a {buf.shape[0]}-row [local | halo] buffer ({rows_read_h} rows "
              f"read, {nnz_h} nonzeros), d=256 fp32",
    )
    print("  row-block timings: " + "; ".join(
        f"{k} {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound {t['bound_ms']:.6f} "
        f"by {t['bound_by']}) at {t['shape']}" for k, t in timing_rows.items()))
    del halo_cases, op_h, buf, local_dense, local_csr, m16_full

    # flash attention.  First every launch phase 7 makes, from the two
    # configs, in the decoder's layout ((B, S, H, hd) activations passed as
    # transposed views, as attention_prefill passes them): qwen2.5-3b's
    # batched prefill (4 × 2048) and per-node serve (1 × 512); gemma3-4b's
    # global and local layers (2 × 2048, window 1024).  Phase 7 records the
    # key of each launch and fails on one not held here.  Then contiguous
    # (B, H, S, hd) bf16 shapes, ragged bf16 shapes on the wgmma route
    # (every S of the list at every hd, the GQA group, window, layout and
    # mask cycling), and on the wgmma_tf32x3 route phase 8's fp32 launch,
    # the full-width prefill shapes in fp32 and ragged fp32 shapes at every
    # hd.  Each case checks which route it launched.
    qcfg, gcfg = get_config("qwen2.5-3b"), get_config("gemma3-4b")
    mcfg, q15cfg, scfg = get_config("granite-moe-1b-a400m"), get_config("qwen1.5-4b"), get_config("stablelm-12b")
    swacfg = swa_variant(8192)
    # phase 7d's configs at full width, jamba and llama4-scout cut in depth
    jcfg = dataclasses.replace(get_config("jamba-1.5-large-398b"), n_layers=JAMBA_LAYERS)
    lcfg, mgcfg = get_config("llava-next-mistral-7b"), get_config("musicgen-large")
    l4cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"), n_layers=LLAMA4_LAYERS)

    def attn_inputs(b, h, kvh, s_len, hd, dtype, layout="bhsd"):
        if layout == "bshd":
            return tuple(torch.randn(b, s_len, n, hd, generator=gen, device=dev).to(dtype).transpose(1, 2)
                         for n in (h, kvh, kvh))
        return tuple(torch.randn(b, n, s_len, hd, generator=gen, device=dev).to(dtype) for n in (h, kvh, kvh))

    def flash_key(q, k, causal, window):
        layout = "bshd" if q.shape[2] > 1 and q.transpose(1, 2).is_contiguous() else "bhsd"
        return (*q.shape[:2], k.shape[1], *q.shape[2:], q.dtype, bool(causal), int(window), layout)

    def serve_case(label, cfg, b, s_len, window, dtype=torch.bfloat16):
        shape = (b, cfg.n_heads, cfg.n_kv_heads, s_len, cfg.resolved_head_dim, dtype)
        return label, shape, True, window, "bshd"

    flash_cases = [
        serve_case("qwen prefill", qcfg, 4, 2048, 0),
        serve_case("qwen serve", qcfg, 1, 512, 0),
        serve_case("gemma3 global", gcfg, 2, 2048, 0),
        serve_case("gemma3 local", gcfg, 2, 2048, gcfg.sliding_window),
        ("qwen prefill", (4, 16, 2, 2048, 128, torch.bfloat16), True, 0, "bhsd"),
        ("gemma3 local", (1, 8, 4, 2048, 256, torch.bfloat16), True, 1024, "bhsd"),
    ] + [
        ("ragged", (2, 2 * (1, 2, 8)[i % 3], 2, s_len, hd, torch.bfloat16), i % 4 != 3,
         (0, 17, 1024)[i // 3 % 3], ("bshd", "bhsd")[i % 2])
        for i, (s_len, hd) in enumerate((s_len, hd) for s_len in (1, 63, 64, 65, 127, 129, 300, 2047)
                                        for hd in (64, 128, 256))
    ] + [
        ("ragged", (2, 2 * (1, 2, 8)[i % 3], 2, s_len, 32, torch.bfloat16), i % 4 != 3, (0, 17)[i % 2],
         ("bshd", "bhsd")[i // 2 % 2])
        for i, s_len in enumerate((1, 40, 63, 65, 300, 2047))
    ] + [
        serve_case("phase 8", get_reduced_config("qwen2.5-3b"), 2, 40, 0, torch.float32),
        # phase 4h's consensus example: its consensus prefill (4 prompts of
        # 8) and each routed query's (1 × 8)
        serve_case("example consensus", get_reduced_config("qwen2.5-3b"), 4, 8, 0, torch.float32),
        serve_case("example serve", get_reduced_config("qwen2.5-3b"), 1, 8, 0, torch.float32),
        # phase 4j's --model transformer: each recorded round's eval, the
        # held-out batch of 64 windows of 64 tokens
        serve_case("transformer CLI eval", get_reduced_config("qwen2.5-3b"), 64, 64, 0, torch.float32),
        serve_case("qwen prefill", qcfg, 4, 2048, 0, torch.float32),
        serve_case("gemma3 global", gcfg, 2, 2048, 0, torch.float32),
        serve_case("gemma3 local", gcfg, 2, 2048, gcfg.sliding_window, torch.float32),
    ] + [
        ("ragged", (2, 2 * group, 2, s_len, hd, torch.float32), causal, (0, 17)[s_len % 2], ("bshd", "bhsd")[group % 2])
        for s_len in (1, 77, 300) for hd in (32, 64, 128, 256) for causal in (False, True) for group in (1, 8)
    ] + [
        # head dims without an instance, run zero-padded to the next one:
        # reduced qwen1.5-4b (hd 30, fp32 rows of 120 B), reduced stablelm-12b
        # (hd 40, bf16 rows of 80 B) and stablelm-12b (hd 160)
        ("padded", (2, h, kvh, s_len, hd, dtype), causal, window, "bshd")
        for h, kvh, hd, dtype in ((4, 4, 30, torch.float32), (4, 2, 40, torch.bfloat16), (32, 8, 160, torch.bfloat16))
        for s_len, causal, window in ((40, True, 0), (300, True, 17), (300, False, 0), (2048, True, 0))
    ] + [
        # phase 7's granite-moe-1b-a400m (prefill 4 × 2048, per-node serve 1 ×
        # 512), qwen1.5-4b and stablelm-12b (hd 160, zero-padded) prefills,
        # and the swa variant's 1 × 16,384 prompt (window 8192); phase 8's
        # reduced fp32 prefills of the three (2 × 40; stablelm hd 40 and
        # qwen1.5 hd 30 zero-padded)
        serve_case("granite prefill", mcfg, 4, 2048, 0),
        serve_case("granite serve", mcfg, 1, 512, 0),
        serve_case("qwen1.5 prefill", q15cfg, 4, 2048, 0),
        serve_case("stablelm prefill", scfg, 4, 2048, 0),
        serve_case("swa prefill", swacfg, 1, 16384, swacfg.sliding_window),
    ] + [serve_case("phase 8", get_reduced_config(a), 2, 40, 0, torch.float32)
         for a in ("granite-moe-1b-a400m", "stablelm-12b", "qwen1.5-4b")] + [
        # phase 7d's prefills: jamba (5 layers; its attention layer, GQA
        # 64 / 8), llava (2 × (2880 patch embeddings + 1216 tokens)),
        # musicgen (MHA 32 / 32, hd 64; 4 × (256 conditioning embeddings +
        # 1792 tokens)), llama4-scout (GQA 40 / 8: a group of 5); phase 8's
        # reduced prefills of the four (2 × 40, with 8 frontend embeddings
        # for llava and musicgen)
        serve_case("jamba prefill", jcfg, 2, 2048, 0),
        serve_case("llava prefill", lcfg, 2, LLAVA_PATCHES + LLAVA_TEXT, 0),
        serve_case("musicgen prefill", mgcfg, 4, MUSICGEN_COND + MUSICGEN_TEXT, 0),
        serve_case("llama4 prefill", l4cfg, 2, 2048, 0),
    ] + [serve_case("phase 8", get_reduced_config(a), 2, 40 + get_reduced_config(a).n_frontend_tokens, 0,
                    torch.float32) for a in NEW_ARCHS]
    # errors by route: the bf16 route's row is flash_mha, the fp32 route's
    # flash_mha_fp32; a head dim run zero-padded has a row of its own, and so
    # have the new configs' serve shapes
    row_of = {"wgmma": "flash_mha", "wgmma_tf32x3": "flash_mha_fp32"}
    row_of_label = {"granite prefill": "flash_mha_granite", "granite serve": "flash_mha_granite",
                    "qwen1.5 prefill": "flash_mha_qwen15", "swa prefill": "flash_mha_swa",
                    "jamba prefill": "flash_mha_jamba", "llava prefill": "flash_mha_llava",
                    "musicgen prefill": "flash_mha_musicgen", "llama4 prefill": "flash_mha_llama4"}
    errs.update(dict.fromkeys(row_of.values(), 0.0))
    flash_checked = set()

    def attention_ref_by_head(q, k, v, causal, window):
        """attention_ref one query head at a time, with its KV head: the
        plain version at a length whose (S, S) fp32 scores for every head at
        once would not fit beside this phase's tensors."""
        g = q.shape[1] // k.shape[1]
        return torch.cat([attention_ref(q[:, i:i + 1], k[:, i // g:i // g + 1], v[:, i // g:i // g + 1],
                                        causal=causal, window=window) for i in range(q.shape[1])], dim=1)

    for label, shape, causal, window, layout in flash_cases:
        q, k, v = attn_inputs(*shape, layout=layout)
        b, h, kvh, s_len, hd, dtype = shape
        want = flash_route(dtype, hd)
        before = dict(flash_mha.launches_by_route)
        plain_attention = attention_ref_by_head if s_len > 8192 else (
            lambda q, k, v, causal, window: attention_ref(q, k, v, causal=causal, window=window))
        e = compare(
            f"flash_mha {label} B{b} H{h}/{kvh} S{s_len} hd{hd} {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
            f"{' causal' if causal else ''}{f' w{window}' if window else ''} {layout} ({want})",
            lambda: flash_mha(q, k, v, causal=causal, window=window),
            plain_attention(q, k, v, causal, window), v, bf16=dtype == torch.bfloat16,
        )
        check(flash_mha.launches_by_route == {**before, want: before[want] + 2},
              f"{label}: not launched on {want}")
        if hd not in FLASH_HEAD_DIMS:
            row = f"flash_mha_hd{hd}{'_fp32' if dtype == torch.float32 else ''}"
        else:
            row = row_of_label.get(label, row_of[want])
        if label.startswith("example"):
            row = "flash_mha_fp32_example"
        errs[row] = max(errs.get(row, 0.0), e)
        flash_checked.add(flash_key(q, k, causal, window))
        del q, k, v

    # the RWKV-6 time-mix.  First every launch phase 7 makes, from the
    # config, in the decoder's layout ((B, L, H·M) projections viewed as
    # (B, L, H, M)): rwkv6-3b's consensus prefill (4 × 2048), per-node serve
    # (1 × 512) and long prompt (1 × 16,384), bf16 r/k/v, fp32 w, zero
    # initial state.  Phase 7 records the key of each launch and fails on
    # one not held here.  Then ragged shapes with and without an initial
    # state, bf16 (route tc) and fp32 (route tc_fp32) at M 32, 64 and 128,
    # and decays alternating at the clamp's two ends on both routes.  Each
    # case checks which route it launched.  Out and final state are both
    # fp32: 5e-5 · max|ref|, the JAX package's kernel-vs-oracle bound.
    rcfg = get_config("rwkv6-3b")
    r_heads, r_hd = rcfg.d_model // rcfg.rwkv_head_dim, rcfg.rwkv_head_dim

    def rwkv_inputs(b, l_len, h, m, dtype, with_state=False):
        r, k, v = (torch.randn(b, l_len, h * m, generator=gen, device=dev).to(dtype).view(b, l_len, h, m)
                   for _ in range(3))
        z = -6.0 + 7.0 * torch.rand(b, l_len, h * m, generator=gen, device=dev)  # w over the clamp's range
        w = torch.exp(-torch.exp(z)).view(b, l_len, h, m)
        u = 0.5 * torch.rand(h, m, generator=gen, device=dev)
        state = 0.3 * torch.randn(b, h, m, m, generator=gen, device=dev) if with_state else None
        return r, k, v, w, u, state

    def rwkv_key(r, state):
        return (*r.shape, r.dtype, state is not None, r.is_contiguous())

    def compare_rwkv(label, args):
        want = rwkv_kernels.route(args[0].dtype, args[0].shape[-1])
        before = dict(rwkv6_chunked.launches_by_route)
        got, again = rwkv6_chunked(*args), rwkv6_chunked(*args)
        check(rwkv6_chunked.launches_by_route == {**before, want: before[want] + 2},
              f"{label}: not launched on {want}")
        torch.cuda.synchronize()
        ref = rwkv6_chunked_ref(*args)
        errs_r, worst = [], 0.0
        for g_t, r_t in zip(got, ref):
            check(g_t.dtype == torch.float32 and g_t.shape == r_t.shape, f"{label}: dtype/shape")
            e = float((g_t - r_t).abs().max())
            errs_r.append(e)
            worst = max(worst, e / (5e-5 * float(r_t.abs().max())))
        bitwise = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        print(f"  {label:48s} max_abs_err out {errs_r[0]:.3e} state {errs_r[1]:.3e} tol 5e-5·max|ref| "
              f"(worst err/tol {worst:.3f}) deterministic {bitwise} ({want})")
        check(worst <= 1.0, f"{label}: error above tolerance 5e-5·max|ref| (worst err/tol {worst})")
        check(bitwise, f"{label}: two launches differ")
        return want, errs_r[0]

    rwkv_red = get_reduced_config("rwkv6-3b")
    rwkv_cases = [
        # phase 4l's --model rwkv: each recorded round's eval, the held-out
        # batch of 64 windows of 64 tokens through the reduced rwkv6-3b (fp32)
        ("rwkv CLI eval", (64, 64, rwkv_red.d_model // rwkv_red.rwkv_head_dim, rwkv_red.rwkv_head_dim,
                           torch.float32, False)),
        ("rwkv prefill", (4, 2048, r_heads, r_hd, torch.bfloat16, False)),
        ("rwkv serve", (1, 512, r_heads, r_hd, torch.bfloat16, False)),
        ("rwkv long prompt", (1, 16384, r_heads, r_hd, torch.bfloat16, False)),
    ] + [
        ("ragged", (2, l_len, 3, m, dtype, with_state))
        for dtype in (torch.bfloat16, torch.float32) for m in (32, 64, 128) for l_len in (1, 33, 77, 300, 2049)
        for with_state in (False, True)
    ]
    # errors by route: the bf16 route's row is rwkv6_chunked, the fp32 route's rwkv6_chunked_fma
    rwkv_row = {"tc": "rwkv6_chunked", "tc_fp32": "rwkv6_chunked_fma"}
    errs.update(dict.fromkeys(rwkv_row.values(), 0.0))
    rwkv_checked = set()
    for label, shape in rwkv_cases:
        args = rwkv_inputs(*shape)
        b, l_len, h, m, dtype, with_state = shape
        want, e = compare_rwkv(f"rwkv6_chunked {label} B{b} L{l_len} H{h} M{m} "
                               f"{'bf16' if dtype == torch.bfloat16 else 'fp32'}{' state' if with_state else ''}", args)
        errs[rwkv_row[want]] = max(errs[rwkv_row[want]], e)
        rwkv_checked.add(rwkv_key(args[0], args[5]))
        del args
    for m, dtype, l_len in ((32, torch.float32, 128), (64, torch.bfloat16, 300)):
        ones = torch.ones(2, l_len, 1, m, device=dev, dtype=dtype)
        alt = torch.where(torch.arange(l_len, device=dev) % 2 == 0, 0.066, 0.9997)
        extreme = (ones, ones, ones, alt[None, :, None, None].expand(2, l_len, 1, m).contiguous(),
                   torch.zeros(1, m, device=dev), None)
        check(all(bool(torch.isfinite(t).all()) for t in rwkv6_chunked(*extreme)), "rwkv extreme decay not finite")
        want, e = compare_rwkv(f"rwkv6_chunked extreme decay B2 L{l_len} H1 M{m} {str(dtype)[6:]}", extreme)
        errs[rwkv_row[want]] = max(errs[rwkv_row[want]], e)
    red = get_reduced_config("rwkv6-3b")

    # timings at the main path's shapes: dense at the quickstart's complete-16,
    # block-sparse at the CLI's ring-1024 (bn 32); W fp32 of the full MLP width
    timing = {**timing_rows}
    m16 = compile_plan(T.complete(16), "dense", device=dev).receive
    w16 = torch.randn(16, D_MAIN, generator=gen, device=dev)
    b_k, op_k = bound(4 * 16 * 16 + 2 * 4 * 16 * D_MAIN, 2 * 16 * 16 * D_MAIN)
    timing["mix_matmul"] = dict(
        ms=time_ms(lambda: mix_matmul(m16, w16), flush=flush),
        plain_ms=time_ms(lambda: decavg_mix_ref(m16, w16), flush=flush),
        library_ms=time_ms(lambda: torch.matmul(m16, w16), flush=flush),
        bound_ms=b_k, bound_by=op_k, shape=f"n=16 d={D_MAIN} fp32", dense_route=dense_route(16, D_MAIN, torch.float32),
    )
    # a yardstick for the byte bound: PyTorch's copy of W into a buffer of
    # its shape reads and writes the same bytes the mix does
    y16 = torch.empty_like(w16)
    copy16_ms = time_ms(lambda: y16.copy_(w16), flush=flush)
    del w16, y16
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
    # both block-sparse walks at kreg4-1024, bn 32: a randomly numbered graph
    # keeps nearly every tile of a row block (31.5 of 32), with about the
    # ring's nonzeros a row (5 against 3).  Bounds as ring-1024's: 2 nnz d
    # flops, W read and Y written once (mix), X and H read and X' and H'
    # written once (round)
    kreg_nnz = int(np.count_nonzero(kreg_np))
    kreg_tile_bytes = sum(t.numel() * 4 for t in kreg_bsr)
    walks = {("mix_bsr", "ring-1024"): timing["mix_bsr"]}
    b_w, op_w = bound(kreg_tile_bytes + 2 * 4 * 1024 * D_MAIN, 2 * kreg_nnz * D_MAIN)
    kreg_csr = torch.as_tensor(kreg_np, device=dev).to_sparse_csr()
    walks[("mix_bsr", "kreg4-1024")] = dict(ms=time_ms(lambda: mix_bsr(*kreg_bsr, w1k), flush=flush),
                                            library_ms=time_ms(lambda: torch.sparse.mm(kreg_csr, w1k), flush=flush),
                                            bound_ms=b_w, bound_by=op_w)
    del w1k, m_csr, kreg_csr, plan_d, m16
    # the consensus example's DecAvg rounds (phase 4h): n = 8 over the
    # reduced qwen2.5-3b's flat row, its d from the layout of a CPU init
    D_LM = FlatLayout.of(TF.init_params(0, get_reduced_config("qwen2.5-3b"),
                                        InitConfig("trunc_normal", torch.ones(8)), device="cpu")).size
    m8 = row_stochastic(8)
    w8 = torch.randn(8, D_LM, generator=gen, device=dev)
    errs["mix_matmul_decoder"] = compare(f"mix_matmul fp32 n=8 d={D_LM} (reduced qwen2.5-3b)",
                                         lambda: mix_matmul(m8, w8), decavg_mix_ref(m8, w8), w8)
    b_lm, op_lm = bound(4 * 8 * 8 + 2 * 4 * 8 * D_LM, 2 * 8 * 8 * D_LM)
    timing["mix_matmul_decoder"] = dict(
        ms=time_ms(lambda: mix_matmul(m8, w8), flush=flush),
        plain_ms=time_ms(lambda: decavg_mix_ref(m8, w8), flush=flush),
        library_ms=time_ms(lambda: torch.matmul(m8, w8), flush=flush),
        bound_ms=b_lm, bound_by=op_lm, shape=f"n=8 d={D_LM} fp32 (reduced qwen2.5-3b)",
        dense_route=dense_route(8, D_LM, torch.float32),
    )
    del m8, w8
    # phase 4k's --model moe rounds: n = 8 over the reduced
    # granite-moe-1b-a400m's flat row (the final norm included), its d from
    # the layout of a CPU init
    D_MOE = FlatLayout.of(TF.init_params(0, get_reduced_config("granite-moe-1b-a400m"),
                                         InitConfig("trunc_normal", torch.ones(8)), device="cpu")).size
    m8 = row_stochastic(8)
    w8 = torch.randn(8, D_MOE, generator=gen, device=dev)
    errs["mix_matmul_moe"] = compare(f"mix_matmul fp32 n=8 d={D_MOE} (reduced granite-moe)",
                                     lambda: mix_matmul(m8, w8), decavg_mix_ref(m8, w8), w8)
    b_moe, op_moe = bound(4 * 8 * 8 + 2 * 4 * 8 * D_MOE, 2 * 8 * 8 * D_MOE)
    timing["mix_matmul_moe"] = dict(
        ms=time_ms(lambda: mix_matmul(m8, w8), flush=flush),
        plain_ms=time_ms(lambda: decavg_mix_ref(m8, w8), flush=flush),
        library_ms=time_ms(lambda: torch.matmul(m8, w8), flush=flush),
        bound_ms=b_moe, bound_by=op_moe, shape=f"n=8 d={D_MOE} fp32 (reduced granite-moe-1b-a400m)",
        dense_route=dense_route(8, D_MOE, torch.float32),
    )
    del m8, w8
    # phase 4l's rounds: n = 8 over the flat rows of the reduced rwkv6-3b
    # (--model rwkv and --arch rwkv6-3b), jamba and llava (--arch), each d
    # from the layout of a CPU init; the row's times at rwkv6-3b's
    D_ZOO = {a: FlatLayout.of(TF.init_params(0, get_reduced_config(a), InitConfig("trunc_normal", torch.ones(8)),
                                             device="cpu")).size
             for a in ("rwkv6-3b", "jamba-1.5-large-398b", "llava-next-mistral-7b")}
    errs["mix_matmul_zoo"] = 0.0
    for a, d_a in D_ZOO.items():
        m8 = row_stochastic(8)
        w8 = torch.randn(8, d_a, generator=gen, device=dev)
        errs["mix_matmul_zoo"] = max(errs["mix_matmul_zoo"], compare(
            f"mix_matmul fp32 n=8 d={d_a} (reduced {a})", lambda: mix_matmul(m8, w8), decavg_mix_ref(m8, w8), w8))
        if a == "rwkv6-3b":
            b_z, op_z = bound(4 * 8 * 8 + 2 * 4 * 8 * d_a, 2 * 8 * 8 * d_a)
            timing["mix_matmul_zoo"] = dict(
                ms=time_ms(lambda: mix_matmul(m8, w8), flush=flush),
                plain_ms=time_ms(lambda: decavg_mix_ref(m8, w8), flush=flush),
                library_ms=time_ms(lambda: torch.matmul(m8, w8), flush=flush),
                bound_ms=b_z, bound_by=op_z, shape=f"n=8 d={d_a} fp32 (reduced rwkv6-3b)",
                dense_route=dense_route(8, d_a, torch.float32),
            )
    del m8, w8
    # the widths of phase 4i's fig11 quick: the paper MLP at hidden (64, 32)
    # on kreg8-32, (128, 64) on kreg8-64 (its checkpoint-overhead record) and
    # (32,) on kreg8-16 (its resume-parity record); the masked operators of
    # the elastic rounds join this row's error in phase 4i
    errs["mix_matmul_elastic"] = 0.0
    for n_e, d_e in ((32, 52_650), (64, 109_386), (16, 25_450)):
        m_e = row_stochastic(n_e)
        w_e = torch.randn(n_e, d_e, generator=gen, device=dev)
        errs["mix_matmul_elastic"] = max(errs["mix_matmul_elastic"], compare(
            f"mix_matmul fp32 n={n_e} d={d_e} (fig11)", lambda: mix_matmul(m_e, w_e), decavg_mix_ref(m_e, w_e), w_e))
    del m_e, w_e
    # flash at every shape phase 7 launches, on the decoder's (B, S, H, hd)
    # views (the qwen2.5-3b prefill's row goes into the kernels line, its
    # contiguous layout timed beside it), and at phase 8's and the
    # full-width fp32 shapes.  Each is timed twice: as a caller pays for it
    # (the kernels line's time: L2 flushed, host time counted where the
    # wrapper outlasts the flush before it) and with the stream held
    # (device time only).  Bytes are q, k, v read once and o written once;
    # flops 4·hd per (q, k) pair the mask keeps, per head (QKᵀ and PV).
    # bf16: the flops at the bf16 tensor-core peak; the route does 6·hd (PV
    # on bf16 hi and lo parts of P), its own floor, printed beside.  fp32:
    # the route's own floor, every product as three TF32 products (12·hd)
    # at the TF32 peak, since no fp32 rate is faster.  library: SDPA in the
    # same dtype, with a boolean mask for the window.
    def sdpa(q, k, v, window):
        if not window:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        i = torch.arange(q.shape[2], device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    def time_flash(cfg, b, s_len, window, dtype):
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q, k, v = attn_inputs(b, h, kvh, s_len, hd, dtype, layout="bshd")
        pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s_len))
        size = q.element_size()
        bf16 = dtype == torch.bfloat16
        flops = 4 * b * h * hd * pairs
        b_f, op_f = bound(size * (2 * b * h * s_len * hd + 2 * b * kvh * s_len * hd), flops if bf16 else 3 * flops,
                          PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS)
        return dict(
            ms=time_ms(lambda: flash_mha(q, k, v, window=window), reps=21, flush=flush),
            held_ms=time_ms(lambda: flash_mha(q, k, v, window=window), reps=21, flush=flush, hold=True),
            host_ms=host_ms(lambda: flash_mha(q, k, v, window=window)),
            plain_ms=time_ms(lambda: attention_ref(q, k, v, window=window), reps=3, flush=flush) if s_len <= 8192
            else time_ms(lambda: attention_ref_by_head(q, k, v, True, window), reps=3, flush=flush),
            library_ms=time_ms(lambda: sdpa(q, k, v, window), reps=21, flush=flush),
            bound_ms=b_f, bound_by=op_f, pairs=pairs,
            floor_ms=1.5 * flops / PEAK_BF16_FLOPS * 1e3 if bf16 else b_f,
            shape=f"B{b} H{h}/{kvh} S{s_len} hd{hd} {'bf16' if bf16 else 'fp32'} causal"
                  f"{f' w{window}' if window else ''}, (B, S, H, hd) views",
        ), (q, k, v)

    flash_shapes = {}
    for label, cfg, b, s_len, window, dtype in (
        ("qwen prefill", qcfg, 4, 2048, 0, torch.bfloat16), ("qwen serve", qcfg, 1, 512, 0, torch.bfloat16),
        ("gemma3 global", gcfg, 2, 2048, 0, torch.bfloat16),
        ("gemma3 local", gcfg, 2, 2048, gcfg.sliding_window, torch.bfloat16),
        ("phase 8 fp32", get_reduced_config("qwen2.5-3b"), 2, 40, 0, torch.float32),
        ("example consensus fp32", get_reduced_config("qwen2.5-3b"), 4, 8, 0, torch.float32),
        ("qwen prefill fp32", qcfg, 4, 2048, 0, torch.float32), ("gemma3 global fp32", gcfg, 2, 2048, 0, torch.float32),
        ("gemma3 local fp32", gcfg, 2, 2048, gcfg.sliding_window, torch.float32),
        # the padded head dims: stablelm-12b's prefill (4 × 2048), the
        # reduced stablelm-12b's and qwen1.5-4b's (2 × 40, as phase 8's)
        ("stablelm-12b hd160", SimpleNamespace(n_heads=32, n_kv_heads=8, resolved_head_dim=160), 4, 2048, 0,
         torch.bfloat16),
        ("reduced stablelm-12b hd40", SimpleNamespace(n_heads=4, n_kv_heads=2, resolved_head_dim=40), 2, 40, 0,
         torch.bfloat16),
        ("reduced qwen1.5-4b hd30 fp32", SimpleNamespace(n_heads=4, n_kv_heads=4, resolved_head_dim=30), 2, 40, 0,
         torch.float32),
        # phase 7's new prefills (granite-moe, qwen1.5-4b; the swa variant's
        # long prompt, its plain version one head at a time) and phase 8's
        # reduced stablelm-12b in fp32 (hd 40 zero-padded)
        ("granite prefill", mcfg, 4, 2048, 0, torch.bfloat16), ("qwen1.5 prefill", q15cfg, 4, 2048, 0, torch.bfloat16),
        ("swa prefill", swacfg, 1, 16384, swacfg.sliding_window, torch.bfloat16),
        ("reduced stablelm-12b hd40 fp32", get_reduced_config("stablelm-12b"), 2, 40, 0, torch.float32),
        # phase 7d's prefills (frontend embeddings and text in one sequence)
        ("jamba prefill", jcfg, 2, 2048, 0, torch.bfloat16),
        ("llava prefill", lcfg, 2, LLAVA_PATCHES + LLAVA_TEXT, 0, torch.bfloat16),
        ("musicgen prefill", mgcfg, 4, MUSICGEN_COND + MUSICGEN_TEXT, 0, torch.bfloat16),
        ("llama4 prefill", l4cfg, 2, 2048, 0, torch.bfloat16),
    ):
        flash_shapes[label], qkv = time_flash(cfg, b, s_len, window, dtype)
        if label == "qwen prefill":
            qc, kc, vc = (t.contiguous() for t in qkv)
            flash_contiguous_ms = time_ms(lambda: flash_mha(qc, kc, vc), reps=21, flush=flush)
            del qc, kc, vc
        del qkv
    timing["flash_mha"] = flash_shapes["qwen prefill"]
    # the fp32 route's row: phase 8's launches (the reduced qwen2.5-3b, 2 prompts of 40)
    timing["flash_mha_fp32"] = flash_shapes["phase 8 fp32"]
    # phase 4h's consensus example: its consensus prefill (4 prompts of 8)
    timing["flash_mha_fp32_example"] = flash_shapes["example consensus fp32"]
    # the padded head dims' rows: stablelm-12b's prefills (phase 7, hd 160),
    # phase 8's reduced stablelm-12b (hd 40 fp32) and qwen1.5-4b (hd 30
    # fp32); no path launches hd 40 in bf16
    timing["flash_mha_hd160"] = flash_shapes["stablelm-12b hd160"]
    timing["flash_mha_hd40"] = flash_shapes["reduced stablelm-12b hd40"]
    timing["flash_mha_hd30_fp32"] = flash_shapes["reduced qwen1.5-4b hd30 fp32"]
    timing["flash_mha_hd40_fp32"] = flash_shapes["reduced stablelm-12b hd40 fp32"]
    timing["flash_mha_granite"] = flash_shapes["granite prefill"]
    timing["flash_mha_qwen15"] = flash_shapes["qwen1.5 prefill"]
    timing["flash_mha_swa"] = flash_shapes["swa prefill"]
    for name in ("jamba", "llava", "musicgen", "llama4"):
        timing[f"flash_mha_{name}"] = flash_shapes[f"{name} prefill"]
    # an empty kernel, queued behind the held stream like the held timings:
    # the least time any launch takes, the floor of the launch-bound rows
    empty_ms = time_ms(lambda: torch.cuda._sleep(0), reps=21, hold=True)
    # rwkv at the three shapes phase 7 launches (rwkv6-3b's consensus prefill
    # 4 × 2048, per-node serve 1 × 512, the long prompt 1 × 16,384; 40 heads
    # of 64, bf16 r/k/v), at phase 8's (the reduced rwkv6-3b, fp32, 2
    # prompts of 40: one launch), at 4 × 2048 with fp32 r/k/v
    # (ArchConfig.dtype fp32) and at M 128 (20 heads of 128, bf16 and
    # fp32): bytes are r, k, v and w read once, out and the final state
    # written once; flops per (b, h, chunk of c) are what the chunked form
    # needs: 2cM² (r·S) and 2cM² (state update), and over the causal pairs
    # only 2M·c(c−1)/2 (scores, s < t) + 2M·c(c+1)/2 (scores·V, s ≤ t, the
    # bonus on the diagonal) = 2c²M.  The kernel does them on the tensor
    # cores as products of split fp32 operands: three for fp32 × fp32 (r·S,
    # scores; with fp32 v all four), two for fp32 × bf16 (state update,
    # scores·V with bf16 v), so 10cM² + 5c²M bf16 flops (12cM² + 6c²M TF32
    # flops with fp32 r/k/v) at the bf16 (TF32) peak, far below the bytes:
    # its bound is the byte time; the fp32 flops at the fp32 peak are
    # printed as a note.
    # Timed with the stream held so the wrapper's allocations are not
    # timed; then three calls under torch.profiler, L2 flushed before each:
    # the mean device time of each launch (A span deltas, B state scan,
    # C outputs).
    rwkv_shapes = {}
    for label, b, l_len, h, m, dtype in (
        ("prefill", 4, 2048, r_heads, r_hd, torch.bfloat16), ("serve", 1, 512, r_heads, r_hd, torch.bfloat16),
        ("long prompt", 1, 16384, r_heads, r_hd, torch.bfloat16),
        ("phase 8 fp32", 2, 40, red.d_model // red.rwkv_head_dim, red.rwkv_head_dim, torch.float32),
        ("CLI eval fp32", 64, 64, red.d_model // red.rwkv_head_dim, red.rwkv_head_dim, torch.float32),
        ("prefill fp32", 4, 2048, r_heads, r_hd, torch.float32),
        ("M 128 bf16", 4, 2048, rcfg.d_model // 128, 128, torch.bfloat16),
        ("M 128 fp32", 4, 2048, rcfg.d_model // 128, 128, torch.float32),
    ):
        r_args = rwkv_inputs(b, l_len, h, m, dtype)
        c, n_chunks = 32, -(-l_len // 32)
        size = r_args[0].element_size()
        r_bytes = 3 * r_args[0].numel() * size + r_args[3].numel() * 4 + r_args[4].numel() * 4 \
            + b * l_len * h * m * 4 + b * h * m * m * 4
        r_flops = (4 * c * m * m + 2 * c * c * m) * b * h * n_chunks
        tc_flops = ((12 if size == 4 else 10) * c * m * m + (6 if size == 4 else 5) * c * c * m) * b * h * n_chunks
        ms = time_ms(lambda: rwkv6_chunked(*r_args), flush=flush, hold=True)
        r_host_ms = host_ms(lambda: rwkv6_chunked(*r_args))
        r_phases = (["rwkv_span_out"] if l_len <= rwkv_kernels.SPAN else
                    ["rwkv_span_delta", "rwkv_span_scan", "rwkv_span_out"])
        _, prof, _ = traced(lambda: [(flush.zero_(), rwkv6_chunked(*r_args)) for _ in range(3)],
                            want=dict.fromkeys(r_phases, 3))
        phases_ms = {}
        for ph, kname in (("A", "rwkv_span_delta"), ("B", "rwkv_span_scan"), ("C", "rwkv_span_out")):
            hits = [e for e in prof.key_averages() if kname in e.key]
            check(len(hits) <= 1 and all(e.count == 3 for e in hits), f"rwkv {label} {ph}: traced "
                  f"{[(e.key, e.count) for e in hits]}; {trace_edges(prof)}")
            if hits:
                phases_ms[ph] = hits[0].self_device_time_total / hits[0].count / 1e3
        check(sorted(phases_ms) == (["C"] if l_len <= rwkv_kernels.SPAN else ["A", "B", "C"]),
              f"rwkv {label}: launched {sorted(phases_ms)}")
        del prof
        b_r, op_r = bound(r_bytes, tc_flops, PEAK_BF16_FLOPS if size == 2 else PEAK_TF32_FLOPS)
        rwkv_shapes[label] = dict(
            ms=ms, host_ms=r_host_ms, phases=phases_ms, bound_ms=b_r, bound_by=op_r, bytes=r_bytes, flops=r_flops, tc_flops=tc_flops,
            fp32_ops_ms=r_flops / PEAK_FP32_FLOPS * 1e3, library_ms=None,  # no one PyTorch call computes this recurrence
            shape=f"B{b} L{l_len} H{h} M{m} {'bf16' if size == 2 else 'fp32'} r/k/v, fp32 w, zero state",
        )
        if label in ("prefill", "phase 8 fp32", "CLI eval fp32"):
            rwkv_shapes[label]["plain_ms"] = time_ms(lambda: rwkv6_chunked_ref(*r_args), reps=3, flush=flush)
        del r_args
    timing["rwkv6_chunked"] = rwkv_shapes["prefill"]
    # the fp32 route's row: phase 8's launches
    timing["rwkv6_chunked_fma"] = rwkv_shapes["phase 8 fp32"]
    # phase 4l's --model rwkv evals (fp32, the tc_fp32 route)
    timing["rwkv6_chunked_eval"] = rwkv_shapes["CLI eval fp32"]
    errs["rwkv6_chunked_eval"] = errs["rwkv6_chunked_fma"]

    # (after the flash and mix timings: after a torch.profiler session later
    # launches can take more host time, which an unheld timing would count)
    def rwkv_kernels_run(call, want):
        """The result of one call and the rwkv kernels it ran on the card,
        one name a launch (torch.profiler; ``want`` as for ``traced``)."""
        got, prof, _ = traced(call, want=want)
        return got, [re.sub(r".*(rwkv_span_[a-z]+).*", r"\1", e.key) for e in prof.key_averages()
                     for _ in range(e.count) if "rwkv_span" in e.key]

    # the one-launch path at phase 8's shape (the reduced rwkv6-3b, fp32, 2
    # prompts of 40) and at bf16 M 64, with and without a state: one device
    # kernel (the span outputs), out bitwise the three launches' (the same
    # state in, the same arithmetic; the kernel given a span's scratch), the
    # state in the bound
    for shape in ((2, 40, red.d_model // red.rwkv_head_dim, red.rwkv_head_dim, torch.float32, False),
                  (2, 40, red.d_model // red.rwkv_head_dim, red.rwkv_head_dim, torch.float32, True),
                  (2, 128, 3, 64, torch.bfloat16, True)):
        args = rwkv_inputs(*shape)
        (out1, state1), names1 = rwkv_kernels_run(lambda: rwkv6_chunked(*args), {"rwkv_span_out": 1})
        (out3, state3), names3 = rwkv_kernels_run(lambda: rwkv_kernels._launch(
            *args, rwkv_kernels.span_scratch_floats(*shape[:4])),
            dict.fromkeys(("rwkv_span_delta", "rwkv_span_scan", "rwkv_span_out"), 1))
        ref_state = rwkv6_chunked_ref(*args)[1]
        worst = float((state1 - ref_state).abs().max()) / (5e-5 * float(ref_state.abs().max()))
        print(f"  rwkv6_chunked one launch B{shape[0]} L{shape[1]} H{shape[2]} M{shape[3]} {str(shape[4])[6:]}"
              f"{' state' if shape[5] else ''}: kernels {names1} against {names3}; out bitwise "
              f"{torch.equal(out1, out3)}; state worst err/tol {worst:.3f}")
        check(names1 == ["rwkv_span_out"] and sorted(names3) == ["rwkv_span_delta", "rwkv_span_out", "rwkv_span_scan"],
              f"one-launch path: kernels {names1}, three-launch path {names3}")
        check(torch.equal(out1, out3), "one-launch out differs from the three launches'")
        check(worst <= 1.0, f"one-launch state above 5e-5·max|ref| (worst err/tol {worst})")
        del args

    # the quantised mix (kernel 3), at the main path's shapes: the compressed
    # quickstart's complete-16 (dense) and the CLI's ring-1024 (BSR, bn 32),
    # the paper MLP's width with its per-leaf chunk table (281 chunks a row at
    # chunk 2048); int8 and fp8; round mode against a nonzero mirror H at γ 1
    # and 0.5 (and one dense round without error feedback); raw mode, the
    # Pallas kernel's function (512-column chunks, its scale floor), in fp32
    # and bf16; one masked ring round.  Row 0 holds an all-zero chunk of
    # X − H, row 1 a chunk of absmax 1e-29, where the two scale floors
    # differ.  Scales and H' must equal the plain version's bit for bit (the
    # same arithmetic, element for element); X' and Y within 1e-5 · max|X|
    # (bf16 Y: one ulp more).
    mlp_layout = FlatLayout.of(init_mlp(InitConfig("he_normal", torch.ones(1, device=dev)), gen))
    mlp_bounds = chunk_bounds(mlp_layout.sizes, 2048, dev)
    n_chunks = mlp_bounds.numel() - 1
    check(mlp_layout.size == D_MAIN and n_chunks == 281, f"MLP chunk table: {n_chunks} chunks of {mlp_layout.size}")

    def quant_inputs(n):
        x = torch.randn(n, D_MAIN, generator=gen, device=dev) * (0.01 + 5 * torch.rand(n, 1, generator=gen, device=dev))
        h = 0.3 * torch.randn(n, D_MAIN, generator=gen, device=dev)
        x[0, :512], h[0, :512] = 0.0, 0.0  # fc0/b: an all-zero chunk of X − H
        x[1, 512:2560] *= 1e-29 / float(x[1, 512:2560].abs().max())  # fc0/w's first chunk
        h[1, 512:2560] = 0.0
        return x, h

    def compare_quant(label, kernel, plain_mix, x, h, bounds, *, codec, gamma, floor="codec", ef=True, route=None,
                      keep=None):
        """With ``route`` the kernel is the dense round: it takes the table as
        host ints and returns its scales, both its launches take that route,
        and the host's count of its shared memory is the kernel's; else a BSR
        walk given the scales pass's.  ``keep`` freezes the mirrors of the
        rows it marks False (the elastic round's non-members)."""
        ref_scales = quant_scales_ref(x, h, bounds, codec=codec, error_feedback=ef and h is not None, floor=floor)
        kw = dict(codec=codec, gamma=gamma, error_feedback=ef, **({} if keep is None else {"keep": keep}))
        if route is None:
            scales = quant_scales(x, h, bounds, codec=codec, error_feedback=ef, floor=floor)

            def run():
                return kernel(x, h, bounds, scales, **kw), scales
        else:
            by_route = dict(quant_mix_dense.launches_by_route)
            edges = tuple(bounds.tolist())
            plan = mix_quant.tile_plan(edges, x.shape[0], x.dtype, x.device)[0]
            args = (x.shape[0], plan.cols, plan.tile_chunks, x.element_size())
            smem = (mix_quant.round_smem_bytes(*args), mix_quant._lib().quant_round_smem_bytes(*args))
            check(smem[0] == smem[1], f"{label}: the host counts {smem[0]} bytes of shared memory, the kernel {smem[1]}")

            def run():
                return kernel(x, h, edges, floor=floor, **kw)
        (got, scales), (again, scales_again) = run(), run()
        torch.cuda.synchronize()
        check(torch.equal(scales, ref_scales) and torch.equal(scales, scales_again),
              f"{label}: scales differ from the plain version")
        if route is not None:
            check(quant_mix_dense.launches_by_route == {**by_route, route: by_route[route] + 2},
                  f"{label}: routes {quant_mix_dense.launches_by_route}, want two launches on {route}")
        ref = quant_mix_ref(plain_mix, x, h, bounds, ref_scales, codec=codec, gamma=gamma,
                            error_feedback=ef and h is not None, keep=keep)
        outs = [("Y", got, again, ref)] if gamma is None else [
            ("X'", got[0], again[0], ref[0]), ("H'", got[1], again[1], ref[1])]
        for what, g_t, a_t, r_t in outs:
            check(g_t.shape == r_t.shape and g_t.dtype == r_t.dtype, f"{label} {what}: dtype/shape")
            check(torch.equal(g_t, a_t), f"{label} {what}: two launches differ")
        h_off = 0 if gamma is None else int((got[1] != ref[1]).sum())
        y, y_ref = outs[0][1].float(), outs[0][3].float()
        diff = (y - y_ref).abs()
        err = float(diff.max())
        atol = FP32_TOL * max(float(x.float().abs().max()), 1.0)
        bf16 = x.dtype == torch.bfloat16
        worst = float((diff / (atol + BF16_RTOL * y_ref.abs())).max()) if bf16 else err / atol
        print(f"  {label:48s} {outs[0][0]} max_abs_err {err:.3e} (worst err/tol {worst:.3f})"
              + ("" if gamma is None else f", H' elements off the plain version {h_off}")
              + ("" if route is None else f"; route {route}") + "; scales bitwise; deterministic True")
        check(h_off == 0, f"{label}: H' differs from the plain version in {h_off} elements")
        check(worst <= 1.0, f"{label}: error above tolerance (worst err/tol {worst})")
        del got, again, ref, outs, y, y_ref, diff
        return err

    def dense_kernel(m):
        return lambda *a, **kw: quant_mix_dense(m, *a, **kw)

    def bsr_kernel(op_b):
        return lambda *a, **kw: quant_mix_bsr(*op_b, *a, **kw)

    errs.update(quant_scales=0.0, quant_mix_dense=0.0, quant_mix_bsr=0.0)  # scales: bitwise in every case
    m16 = compile_plan(T.complete(16), "dense", device=dev).receive
    x16, h16 = quant_inputs(16)
    raw16 = pallas_bounds(D_MAIN, 512, dev)
    for codec in ("int8", "fp8"):
        for gamma in (1.0, 0.5):
            e = compare_quant(f"quant_mix_dense {codec} round complete-16 γ={gamma}", dense_kernel(m16),
                              lambda hq: decavg_mix_ref(m16, hq), x16, h16, mlp_bounds, codec=codec, gamma=gamma,
                              route="staged")
            errs["quant_mix_dense"] = max(errs["quant_mix_dense"], e)
        e = compare_quant(f"quant_mix_dense {codec} raw complete-16 fp32", dense_kernel(m16),
                          lambda hq: decavg_mix_ref(m16, hq), x16, None, raw16, codec=codec, gamma=None,
                          floor="pallas", route="staged")
        errs["quant_mix_dense"] = max(errs["quant_mix_dense"], e)
    e = compare_quant("quant_mix_dense int8 round, no error feedback", dense_kernel(m16),
                      lambda hq: decavg_mix_ref(m16, hq), x16, h16, mlp_bounds, codec="int8", gamma=0.5, ef=False,
                      route="staged")
    errs["quant_mix_dense"] = max(errs["quant_mix_dense"], e)
    # the wide route: chunks of 65,536 columns (Compression's largest), more
    # than a cluster stages: fc0/w's six full chunks
    wide_bounds = chunk_bounds(mlp_layout.sizes, 65536, dev)
    for codec in ("int8", "fp8"):
        e = compare_quant(f"quant_mix_dense {codec} round complete-16 chunk 65536", dense_kernel(m16),
                          lambda hq: decavg_mix_ref(m16, hq), x16, h16, wide_bounds, codec=codec, gamma=1.0,
                          route="wide")
        errs["quant_mix_dense"] = max(errs["quant_mix_dense"], e)
    m64 = compile_plan(T.complete(64), "dense", device=dev).receive
    x64, h64 = quant_inputs(64)
    e = compare_quant("quant_mix_dense int8 round complete-64 γ=1.0", dense_kernel(m64),
                      lambda hq: decavg_mix_ref(m64, hq), x64, h64, mlp_bounds, codec="int8", gamma=1.0,
                      route="staged")
    errs["quant_mix_dense"] = max(errs["quant_mix_dense"], e)
    # phase 4j's --model transformer --compress int8: the reduced
    # qwen2.5-3b's rows at complete-8, its own chunk table
    lm_layout = FlatLayout.of(TF.init_params(0, get_reduced_config("qwen2.5-3b"), InitConfig("trunc_normal", torch.ones(1)),
                                             device="cpu"))
    m8q = compile_plan(T.complete(8), "dense", device=dev).receive
    x8q = torch.randn(8, lm_layout.size, generator=gen, device=dev) * (0.01 + torch.rand(8, 1, generator=gen, device=dev))
    h8q = 0.3 * torch.randn(8, lm_layout.size, generator=gen, device=dev)
    e = compare_quant(f"quant_mix_dense int8 round complete-8 d={lm_layout.size} (reduced qwen2.5-3b)",
                      dense_kernel(m8q), lambda hq: decavg_mix_ref(m8q, hq), x8q, h8q,
                      chunk_bounds(lm_layout.sizes, 2048, dev), codec="int8", gamma=1.0, route="staged")
    errs["quant_mix_dense"] = max(errs["quant_mix_dense"], e)
    del x8q, h8q
    # phase 4k's --model moe --compress int8: the reduced granite-moe's rows
    # at complete-8, its own chunk table (the router and expert stacks are
    # leaves of their own); timed below
    moe_layout = FlatLayout.of(TF.init_params(0, get_reduced_config("granite-moe-1b-a400m"),
                                              InitConfig("trunc_normal", torch.ones(1)), device="cpu"))
    moe_bounds = chunk_bounds(moe_layout.sizes, 2048, dev)
    x8m = torch.randn(8, moe_layout.size, generator=gen, device=dev) * (0.01 + torch.rand(8, 1, generator=gen, device=dev))
    h8m = 0.3 * torch.randn(8, moe_layout.size, generator=gen, device=dev)
    errs["quant_mix_dense_moe"] = compare_quant(
        f"quant_mix_dense int8 round complete-8 d={moe_layout.size} (reduced granite-moe)", dense_kernel(m8q),
        lambda hq: decavg_mix_ref(m8q, hq), x8m, h8m, moe_bounds, codec="int8", gamma=1.0, route="staged")
    x1k, h1k = quant_inputs(1024)
    ring_bsr = plan_s.bsr
    for codec in ("int8", "fp8"):
        for gamma in (1.0, 0.5):
            e = compare_quant(f"quant_mix_bsr {codec} round ring-1024 γ={gamma}", bsr_kernel(ring_bsr),
                              lambda hq: mix_bsr_ref(*ring_bsr, hq), x1k, h1k, mlp_bounds, codec=codec, gamma=gamma)
            errs["quant_mix_bsr"] = max(errs["quant_mix_bsr"], e)
    e = compare_quant("quant_mix_bsr int8 masked ring-1024 round", bsr_kernel(op),
                      lambda hq: mix_bsr_ref(*op, hq), x1k, h1k, mlp_bounds, codec="int8", gamma=1.0)
    errs["quant_mix_bsr"] = max(errs["quant_mix_bsr"], e)
    for codec in ("int8", "fp8"):
        e = compare_quant(f"quant_mix_bsr {codec} round kreg4-1024 γ=1.0", bsr_kernel(kreg_bsr),
                          lambda hq: mix_bsr_ref(*kreg_bsr, hq), x1k, h1k, mlp_bounds, codec=codec, gamma=1.0)
        errs["quant_mix_bsr"] = max(errs["quant_mix_bsr"], e)
    for dtype in (torch.float32, torch.bfloat16):
        w_raw = x1k.to(dtype)
        e = compare_quant(f"quantised_mix_bsr raw ring-1024 {str(dtype)[6:]} (Pallas chunks)", bsr_kernel(ring_bsr),
                          lambda hq: mix_bsr_ref(*ring_bsr, hq), w_raw, None, raw16, codec="int8", gamma=None,
                          floor="pallas")
        if dtype == torch.float32:
            errs["quant_mix_bsr"] = max(errs["quant_mix_bsr"], e)
        del w_raw
    # the scale floors at row 1's chunk of absmax 1e-29: the codec's is
    # 1e-29 · fl(1/127), the Pallas kernel's 1e-30
    s_codec = quant_scales(x1k[:2], None, mlp_bounds, codec="int8")
    s_pallas = quant_scales(x1k[:2], None, mlp_bounds, codec="int8", floor="pallas")
    check(float(s_pallas[1, 1]) == float(np.float32(1e-30)) and float(s_codec[1, 1]) < 1e-30
          and float(s_codec[0, 0]) == float(np.float32(np.float32(1e-30) * np.float32(1 / 127))),
          f"scale floors: codec {float(s_codec[1, 1])}, Pallas {float(s_pallas[1, 1])}")
    print(f"  scale floors at absmax 1e-29: codec {float(s_codec[1, 1]):.4e}, Pallas {float(s_pallas[1, 1]):.4e}; "
          f"all-zero chunk {float(s_codec[0, 0]):.4e}")

    # timings: the round at complete-16 (dense) and ring-1024 (BSR), int8,
    # γ 1.  Bytes: X and H read once, X' and H' written once (16 per fp32
    # element), the operator, the scales and the chunk table; flops: the
    # mix's 2 n² d (dense) or 2 nnz d (BSR) plus ~9 per element to
    # dequantise a source row once (sub, div, rint, 2 clips, fma) and to
    # form X' (sub, mul, add).  The scales pass reads X and H and writes
    # n·C floats; 3 flops per element (sub, abs, max).
    table_bytes = 8 * (n_chunks + 1)
    mlp_edges = tuple(mlp_bounds.tolist())
    s1k = quant_scales(x1k, h1k, mlp_bounds, codec="int8")
    b_qs, op_qs = bound(8 * 1024 * D_MAIN + 4 * 1024 * n_chunks + table_bytes, 3 * 1024 * D_MAIN)
    timing["quant_scales"] = dict(
        ms=time_ms(lambda: quant_scales(x1k, h1k, mlp_bounds, codec="int8"), flush=flush),
        plain_ms=time_ms(lambda: quant_scales_ref(x1k, h1k, mlp_bounds, codec="int8"), reps=3, flush=flush),
        library_ms=None,  # no one PyTorch call computes a per-chunk absmax over a chunk table
        bound_ms=b_qs, bound_by=op_qs, shape=f"ring-1024 X − H, d={D_MAIN}, {n_chunks} chunks a row, fp32",
    )
    # the dense round, one launch, device time (the stream held): X and H
    # in, X' and H' out, M, the scales out and the chunk table; flops: the
    # mix's 2 n² d and ~12 per element
    # (sub, abs, max for the scale; div, rint, 2 clips, fma to decode; sub,
    # mul, add for X')
    for n_d, m_d, x_d, h_d in ((16, m16, x16, h16), (64, m64, x64, h64)):
        b_qd, op_qd = bound(16 * n_d * D_MAIN + 4 * n_d * n_d + 4 * n_d * n_chunks + table_bytes,
                            2 * n_d * n_d * D_MAIN + 12 * n_d * D_MAIN)
        timing["quant_mix_dense" if n_d == 16 else "quant_mix_dense_64"] = dict(
            ms=time_ms(lambda: quant_mix_dense(m_d, x_d, h_d, mlp_edges, codec="int8", gamma=1.0),
                       flush=flush, hold=True),
            plain_ms=time_ms(lambda: quant_mix_ref(lambda hq: decavg_mix_ref(m_d, hq), x_d, h_d, mlp_bounds,
                                                   quant_scales_ref(x_d, h_d, mlp_bounds, codec="int8"),
                                                   codec="int8", gamma=1.0), flush=flush),
            library_ms=None,  # no one PyTorch call quantises and mixes
            bound_ms=b_qd, bound_by=op_qd, shape=f"complete-{n_d} int8 round, d={D_MAIN}, fp32, scales included",
        )
    # phase 4k's --model moe --compress int8 round, timed as the complete-16 one
    n_moe_chunks = moe_bounds.numel() - 1
    moe_edges = tuple(moe_bounds.tolist())
    b_qm, op_qm = bound(16 * 8 * moe_layout.size + 4 * 8 * 8 + 4 * 8 * n_moe_chunks + 8 * (n_moe_chunks + 1),
                        2 * 8 * 8 * moe_layout.size + 12 * 8 * moe_layout.size)
    timing["quant_mix_dense_moe"] = dict(
        ms=time_ms(lambda: quant_mix_dense(m8q, x8m, h8m, moe_edges, codec="int8", gamma=1.0), flush=flush, hold=True),
        plain_ms=time_ms(lambda: quant_mix_ref(lambda hq: decavg_mix_ref(m8q, hq), x8m, h8m, moe_bounds,
                                               quant_scales_ref(x8m, h8m, moe_bounds, codec="int8"),
                                               codec="int8", gamma=1.0), flush=flush),
        library_ms=None,  # no one PyTorch call quantises and mixes
        bound_ms=b_qm, bound_by=op_qm,
        shape=f"complete-8 int8 round, d={moe_layout.size} (reduced granite-moe-1b-a400m), {n_moe_chunks} chunks, "
              "fp32, scales included",
    )
    del x8m, h8m
    # the compressed exchange of an asynchronous event (phase 4g's int8
    # exchanges): the dense round over the pair's two rows with its 2 × 2
    # operator [[1 − w_uv, w_uv], [w_vu, 1 − w_vu]] (BA-16 with data sizes,
    # its first and last edge), against the plain version, which mixes in
    # the JAX package's pairwise form h'_u + w_uv (h'_v − h'_u): scales and
    # H' bitwise, X' within fp32 rounding of the two forms; compare_quant
    # holds the host's shared-memory count at n = 2 to the kernel's
    pair_plan = compile_plan(T.barabasi_albert(16, 3, seed=0), "dense", data_sizes=np.linspace(1.0, 2.0, 16),
                             device=dev)
    x2, h2 = quant_inputs(2)
    errs["quant_mix_dense_event"] = 0.0
    for e_p in (0, pair_plan.n_edges - 1):
        m2_p, w2_p = pair_plan.event_m2[e_p], pair_plan.event_w[e_p]
        for codec in ("int8", "fp8"):
            for gamma in (1.0, 0.5):
                errs["quant_mix_dense_event"] = max(errs["quant_mix_dense_event"], compare_quant(
                    f"quant_mix_pair {codec} BA-16 edge {e_p} γ={gamma}",
                    lambda x, h, edges, floor="codec", m2=m2_p, **kw: quant_mix_pair(m2, x, h, edges, **kw),
                    lambda hq, w=w2_p: pair_mix_ref(hq, w), x2, h2, mlp_bounds, codec=codec, gamma=gamma,
                    route="staged"))
    m2_p, w2_p = pair_plan.event_m2[0], pair_plan.event_w[0]
    pair_tiles = mix_quant.tile_plan(mlp_edges, 2, torch.float32, dev)[0]
    # bytes: X and H of the two rows read once, X' and H' written once, M,
    # the scales and the chunk table; flops: the mix's 2 n² d and ~12 per
    # element, as the dense round's row above
    b_qp, op_qp = bound(16 * 2 * D_MAIN + 4 * 4 + 4 * 2 * n_chunks + table_bytes, 2 * 4 * D_MAIN + 12 * 2 * D_MAIN)
    timing["quant_mix_dense_event"] = dict(
        ms=time_ms(lambda: quant_mix_pair(m2_p, x2, h2, mlp_edges, codec="int8", gamma=1.0), flush=flush, hold=True),
        plain_ms=time_ms(lambda: quant_mix_ref(lambda hq: pair_mix_ref(hq, w2_p), x2, h2, mlp_bounds,
                                               quant_scales_ref(x2, h2, mlp_bounds, codec="int8"), codec="int8",
                                               gamma=1.0), flush=flush),
        library_ms=None,  # no one PyTorch call quantises and mixes
        bound_ms=b_qp, bound_by=op_qp,
        shape=f"an event's pair (n = 2) int8 round, d={D_MAIN}, fp32, scales included, {len(pair_tiles.tiles)} "
              f"tiles of {pair_tiles.cluster} CTAs",
    )
    t_p = timing["quant_mix_dense_event"]
    print(f"  quant_mix_pair int8 at n = 2: {t_p['ms']:.4f} ms held, bound {t_p['bound_ms']:.4f} ms "
          f"({t_p['bound_by']}; {t_p['bound_ms'] / t_p['ms']:.1%} of it), plain {t_p['plain_ms']:.4f} ms; "
          f"{len(pair_tiles.tiles)} tiles of {pair_tiles.cluster} CTAs ({pair_tiles.cols} columns staged a CTA)")
    del x2, h2
    b_qb, op_qb = bound(16 * 1024 * D_MAIN + tile_bytes + 4 * 1024 * n_chunks + table_bytes,
                        2 * nnz * D_MAIN + 9 * 1024 * D_MAIN)
    timing["quant_mix_bsr"] = dict(
        ms=time_ms(lambda: quant_mix_bsr(*ring_bsr, x1k, h1k, mlp_bounds, s1k, codec="int8", gamma=1.0), flush=flush),
        plain_ms=time_ms(lambda: quant_mix_ref(lambda hq: mix_bsr_ref(*ring_bsr, hq), x1k, h1k, mlp_bounds, s1k,
                                               codec="int8", gamma=1.0), reps=3, flush=flush),
        library_ms=None,
        bound_ms=b_qb, bound_by=op_qb, shape=f"ring-1024 bn=32 int8 round, d={D_MAIN}, fp32",
    )
    walks[("quant_mix_bsr", "ring-1024")] = timing["quant_mix_bsr"]
    b_w, op_w = bound(16 * 1024 * D_MAIN + kreg_tile_bytes + 4 * 1024 * n_chunks + table_bytes,
                      2 * kreg_nnz * D_MAIN + 9 * 1024 * D_MAIN)
    walks[("quant_mix_bsr", "kreg4-1024")] = dict(
        ms=time_ms(lambda: quant_mix_bsr(*kreg_bsr, x1k, h1k, mlp_bounds, s1k, codec="int8", gamma=1.0), flush=flush),
        bound_ms=b_w, bound_by=op_w)
    for (name, graph), t in walks.items():
        lib = "" if t.get("library_ms") is None else f", torch.sparse.mm {t['library_ms']:.4f} ms"
        print(f"  {name} at {graph} bn=32 d={D_MAIN} fp32{' int8 round' if name == 'quant_mix_bsr' else ''}: "
              f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}; {t['bound_ms'] / t['ms']:.1%} of it)"
              f"{lib}; the tile walk {TILE_WALK_MS[(name, graph)]:.4f} ms")
    for name in ("mix_bsr", "quant_mix_bsr"):
        check(walks[(name, "ring-1024")]["ms"] < TILE_WALK_MS[(name, "ring-1024")],
              f"{name} at ring-1024 is not faster than the tile walk it replaced")
    round_ms = {n_d: time_ms(lambda: mix_ops.quant_mix_flat(m_d, x_d, h_d, mlp_edges, codec="int8", gamma=1.0),
                             flush=flush)
                for n_d, m_d, x_d, h_d in ((16, m16, x16, h16), (64, m64, x64, h64))}
    round1k_ms = time_ms(lambda: mix_ops.quant_mix_flat(ring_bsr, x1k, h1k, mlp_edges, codec="int8", gamma=1.0),
                         flush=flush)
    print(f"  quantised round bytes: complete-16 {16 * 16 * D_MAIN / 1e6:.1f} MB, ring-1024 "
          f"{16 * 1024 * D_MAIN / 1e9:.3f} GB (16 a fp32 element: X, H in, X', H' out)")
    del x16, h16, x1k, h1k, s1k, m16, x64, h64, m64
    torch.cuda.empty_cache()
    for name, t in timing.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"  {name} at {t['shape']}: kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, library {lib}"
              + (f"; route {t['dense_route']}, W copied (Tensor.copy_) in {copy16_ms:.4f} ms" if name == "mix_matmul"
                 else ""))
    print(f"  flash_mha on contiguous (B, H, S, hd) tensors of the same shape: kernel {flash_contiguous_ms:.4f} ms")
    for label, t in flash_shapes.items():
        print(f"  flash_mha ({flash_route(torch.float32 if 'fp32' in label else torch.bfloat16, 0)}) {label} at "
              f"{t['shape']}: kernel {t['ms']:.4f} ms (held: {t['held_ms']:.4f} ms; the call's host time "
              f"{t['host_ms']:.4f} ms), bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {t['pairs']} kept pairs a head; {t['bound_ms'] / t['held_ms']:.1%} of the held time), "
              f"the route's own floor "
              f"{t['floor_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms "
              f"({t['ms'] / t['library_ms']:.2f}x SDPA's time)")
    print(f"  an empty kernel: {empty_ms:.4f} ms")
    for label, t in rwkv_shapes.items():
        print(f"  rwkv6_chunked {label} at {t['shape']}: {t['bytes'] / 1e6:.1f} MB, {t['flops'] / 1e9:.3f} GFLOP "
              f"({t['tc_flops'] / 1e9:.3f} GFLOP of tensor-core products; fp32 flops at the fp32 peak "
              f"{t['fp32_ops_ms']:.4f} ms); kernel {t['ms']:.4f} ms (the call's host time {t['host_ms']:.4f} ms), "
              f"bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {t['bound_ms'] / t['ms']:.1%} of it); launches, mean device time (profiler): "
              + ", ".join(f"{ph} {ms:.4f} ms" for ph, ms in t["phases"].items())
              + f", sum {sum(t['phases'].values()):.4f} ms")
    for n_d, key in ((16, "quant_mix_dense"), (64, "quant_mix_dense_64")):
        t = timing[key]
        print(f"  one int8 round through quant_mix_flat: complete-{n_d} {round_ms[n_d]:.4f} ms with the wrapper's "
              f"host time (one launch; its device time {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms, "
              f"{t['bound_ms'] / t['ms']:.1%} of it)")
    print(f"  one int8 round through quant_mix_flat: ring-1024 {round1k_ms:.4f} ms (scales + BSR walk)")
    torch.cuda.empty_cache()

    # paper cfg C's width: VGG16 at full width, d = 33,638,218 a node, the
    # widest shape any DecAvg kernel takes (phase 4c's rounds).  mix_matmul at
    # n = 16 (every VGG16 round) and n = 64, where n·d = 2.15e9 > 2^31, so no
    # int product on the path may overflow; the error against the plain product
    # reduced over column blocks (each n = 64 buffer is 8.6 GB).  n = 16 is
    # timed against its byte bound, 8·n·d / 3.35 TB/s.  Then the int8 dense
    # round at VGG16's chunk table (n = 16, chunk 2048, ~16,400 chunks a row):
    # scales and H' bitwise the plain version's, its route checked.
    vgg_layout = FlatLayout.of(init_vgg16(InitConfig("he_normal", torch.ones(1, device=dev)), gen))
    D_VGG = vgg_layout.size
    check(D_VGG == 33_638_218, f"VGG16 has {D_VGG} parameters a node")

    def compare_wide(label, m, w):
        route = dense_route(*w.shape, w.dtype)
        by_route = dict(mix_matmul.launches_by_route)
        got, again = mix_matmul(m, w), mix_matmul(m, w)
        torch.cuda.synchronize()
        label = f"{label} [{route}]"
        check(mix_matmul.launches_by_route == {**by_route, route: by_route[route] + 2},
              f"{label}: routes {mix_matmul.launches_by_route}, want two launches on {route}")
        bitwise = bool(torch.equal(got, again))
        del again
        ref = decavg_mix_ref(m, w)
        block = 1 << 24
        err = max(float((got[:, c:c + block] - ref[:, c:c + block]).abs().max()) for c in range(0, w.shape[1], block))
        atol = FP32_TOL * max(float(w.abs().max()), 1.0)
        print(f"  {label:48s} max_abs_err {err:.3e} tol {atol:.1e} (worst err/tol {err / atol:.3f}) "
              f"deterministic {bitwise}")
        check(got.shape == ref.shape and got.dtype == w.dtype, f"{label}: dtype/shape")
        check(err <= atol, f"{label}: error above tolerance {atol:.1e} ({err})")
        check(bitwise, f"{label}: two launches differ")
        return err

    for n_w in (16, 64):
        m_w = row_stochastic(n_w)
        w_w = torch.randn(n_w, D_VGG, generator=gen, device=dev)
        errs["mix_matmul"] = max(errs["mix_matmul"], compare_wide(f"mix_matmul fp32 n={n_w} d={D_VGG} (VGG16)", m_w, w_w))
        if n_w == 16:
            b_v, op_v = bound(4 * 16 * 16 + 2 * 4 * 16 * D_VGG, 2 * 16 * 16 * D_VGG)
            y_w = torch.empty_like(w_w)
            vgg_mix = dict(
                copy_ms=time_ms(lambda: y_w.copy_(w_w), flush=flush),
                ms=time_ms(lambda: mix_matmul(m_w, w_w), flush=flush),
                plain_ms=time_ms(lambda: decavg_mix_ref(m_w, w_w), reps=3, flush=flush),
                library_ms=time_ms(lambda: torch.matmul(m_w, w_w), flush=flush),
                bound_ms=b_v, bound_by=op_v,
            )
            print(f"  mix_matmul at n=16 d={D_VGG} fp32 (VGG16) [{dense_route(16, D_VGG, torch.float32)}]: kernel "
                  f"{vgg_mix['ms']:.4f} ms, bound "
                  f"{vgg_mix['bound_ms']:.4f} ms ({vgg_mix['bound_by']}; {vgg_mix['bound_ms'] / vgg_mix['ms']:.1%} of "
                  f"it), plain {vgg_mix['plain_ms']:.4f} ms, torch.matmul {vgg_mix['library_ms']:.4f} ms, W copied "
                  f"(Tensor.copy_) in {vgg_mix['copy_ms']:.4f} ms")
            del y_w
        del m_w, w_w
        torch.cuda.empty_cache()
    vgg_bounds = chunk_bounds(vgg_layout.sizes, 2048, dev)
    vgg_chunks = vgg_bounds.numel() - 1
    m_k4 = compile_plan(T.random_k_regular(16, 4, seed=0), "dense", device=dev).receive
    x_v = torch.randn(16, D_VGG, generator=gen, device=dev) * (0.01 + torch.rand(16, 1, generator=gen, device=dev))
    h_v = 0.3 * torch.randn(16, D_VGG, generator=gen, device=dev)
    errs["quant_mix_dense"] = max(errs["quant_mix_dense"], compare_quant(
        f"quant_mix_dense int8 round kreg4-16 VGG16 ({vgg_chunks} chunks)", dense_kernel(m_k4),
        lambda hq: decavg_mix_ref(m_k4, hq), x_v, h_v, vgg_bounds, codec="int8", gamma=1.0, route="staged"))
    vgg_edges = tuple(vgg_bounds.tolist())
    b_qv, op_qv = bound(16 * 16 * D_VGG + 4 * 16 * 16 + 4 * 16 * vgg_chunks + 8 * (vgg_chunks + 1),
                        2 * 16 * 16 * D_VGG + 12 * 16 * D_VGG)
    vgg_round = dict(
        ms=time_ms(lambda: quant_mix_dense(m_k4, x_v, h_v, vgg_edges, codec="int8", gamma=1.0), flush=flush, hold=True),
        bound_ms=b_qv, bound_by=op_qv,
    )
    print(f"  quant_mix_dense int8 round at n=16 d={D_VGG} ({vgg_chunks} chunks) fp32, device time: "
          f"{vgg_round['ms']:.4f} ms, bound {b_qv:.4f} ms ({op_qv}; {b_qv / vgg_round['ms']:.1%} of it)")
    del x_v, h_v, m_k4
    torch.cuda.empty_cache()
    # the round at n = 64 (n·d = 2.15e9 > 2^31) over the whole table; then,
    # from the last chunk boundary at or before row 63's 2^31-th element to
    # the row's end, scales, H' and X' against the plain version on those
    # columns alone (a chunk's scale and a column's mix read only its own
    # columns), so every element past a 32-bit offset is held
    m64v = compile_plan(T.complete(64), "dense", device=dev).receive
    x_w = torch.randn(64, D_VGG, generator=gen, device=dev) * (0.01 + torch.rand(64, 1, generator=gen, device=dev))
    h_w = 0.3 * torch.randn(64, D_VGG, generator=gen, device=dev)
    by_route = dict(quant_mix_dense.launches_by_route)
    (xo_w, ho_w), sc_w = quant_mix_dense(m64v, x_w, h_w, vgg_edges, codec="int8", gamma=1.0)
    torch.cuda.synchronize()
    check(quant_mix_dense.launches_by_route == {**by_route, "staged": by_route["staged"] + 1},
          f"VGG16 complete-64 round: routes {quant_mix_dense.launches_by_route}")
    k0 = int(np.searchsorted(np.asarray(vgg_edges), 2**31 - 63 * D_VGG, side="right")) - 1
    c0 = vgg_edges[k0]
    sub = vgg_bounds[k0:] - c0
    xs_w, hs_w = x_w[:, c0:].contiguous(), h_w[:, c0:].contiguous()
    del x_w, h_w
    rs_w = quant_scales_ref(xs_w, hs_w, sub, codec="int8", error_feedback=True)
    rx_w, rh_w = quant_mix_ref(lambda hq: decavg_mix_ref(m64v, hq), xs_w, hs_w, sub, rs_w, codec="int8", gamma=1.0,
                               error_feedback=True)
    err_w = float((xo_w[:, c0:] - rx_w).abs().max())
    atol_w = FP32_TOL * max(float(xs_w.abs().max()), 1.0)
    h_off = int((ho_w[:, c0:] != rh_w).sum())
    print(f"  quant_mix_dense int8 round complete-64 VGG16 (n·d = {64 * D_VGG:,}): columns {c0:,}-{D_VGG:,} "
          f"({vgg_chunks - k0} chunks) against the plain version: scales bitwise "
          f"{torch.equal(sc_w[:, k0:], rs_w)}, H' elements off {h_off}, X' max_abs_err {err_w:.3e} (tol {atol_w:.1e})")
    check(torch.equal(sc_w[:, k0:], rs_w) and h_off == 0, "VGG16 complete-64 round: scales or H' differ")
    check(err_w <= atol_w, f"VGG16 complete-64 round: X' error {err_w} above {atol_w}")
    errs["quant_mix_dense"] = max(errs["quant_mix_dense"], err_w)
    del xo_w, ho_w, sc_w, xs_w, hs_w, rs_w, rx_w, rh_w, m64v
    torch.cuda.empty_cache()

    # the gossip shapes: a round of CommPlan.spread is one launch of
    # mix_matmul / mix_bsr over Mᵀ with a payload of d = 1–4 fp32 columns (the
    # power iteration's x, push-sum's [moments, weight]): the dense Mᵀ of
    # complete-16, kreg4-16 (phase 4e's warmup), kreg4-64 and kreg4-256 (the
    # estimates bench), complete-8 and kreg4-8 (phase 4j's gossip-health
    # reports at n = 8), the BSR Mᵀ of ring-1024, kreg4-1024 and
    # heavytail-1024 (bn 32) and of heavytail-16 / 64 / 256 (the estimates
    # bench's sparse plans, bn 4 / 8 / 32).  Each against its plain version
    # and, for BSR, bitwise its rendering mix_bsr_rows_ref; timed as a
    # caller pays for it (L2 flushed, host time counted) and held (device
    # time), against torch.matmul / torch.sparse.mm on the same Mᵀ.  Bounds:
    # W read and Y written once (8·n·d bytes) plus the operator's bytes
    # (dense 4·n²; BSR its nonzeros, an fp32 value and an int32 column each,
    # the stored tiles' zero padding not counted: printed beside as the
    # layout's cost); 2·d flops a nonzero of Mᵀ (dense: n² of them).  Phase
    # 4e and 4j record the (kernel, n, d, bn) of every gossip launch and
    # fail on one not held here.
    gossip_ops = {
        "complete-8": compile_plan(T.complete(8), "dense", device=dev),
        "kreg4-8": compile_plan(T.random_k_regular(8, 4, seed=0), "dense", device=dev),
        "complete-16": compile_plan(T.complete(16), "dense", device=dev),
        "kreg4-16": compile_plan(T.random_k_regular(16, 4, seed=0), "dense", device=dev),
        "kreg4-64": compile_plan(T.random_k_regular(64, 4, seed=0), "dense", device=dev),
        "kreg4-256": compile_plan(T.random_k_regular(256, 4, seed=0), "dense", device=dev),
        "ring-1024": compile_plan(T.ring(1024), "sparse", device=dev),
        "kreg4-1024": compile_plan(T.random_k_regular(1024, 4, seed=0), "sparse", device=dev),
        "heavytail-1024": compile_plan(T.configuration_heavy_tail(1024, 2.2, seed=0), "sparse", device=dev),
        **{f"heavytail-{n_h}": compile_plan(T.configuration_heavy_tail(n_h, 2.2, seed=0), "sparse", device=dev)
           for n_h in (16, 64, 256)},
    }
    gossip_shapes, gossip_checked = {}, set()
    errs.update(mix_matmul_gossip=0.0, mix_bsr_gossip=0.0)
    for glabel, gplan in gossip_ops.items():
        n_g = gplan.n
        mt_dense = gplan.send_operator() if gplan.backend == "dense" else None
        if gplan.backend == "dense":
            op_bytes, nnz_t, bn_g, stored = 4 * n_g * n_g, n_g * n_g, 0, 4 * n_g * n_g
            run_k = lambda w, op=mt_dense: mix_matmul(op, w)  # noqa: E731
            run_p = lambda w, op=mt_dense: decavg_mix_ref(op, w)  # noqa: E731
            run_l = lambda w, op=mt_dense: torch.matmul(op, w)  # noqa: E731
        else:
            op_b = gplan.send_operator()
            nnz_t = gplan.src.numel() + n_g  # the edges of Mᵀ and its diagonal
            op_bytes, bn_g = 8 * nnz_t, op_b.tiles.shape[-1]
            stored = sum(t.numel() * t.element_size() for t in op_b)
            mt_csr = torch.as_tensor(receive_matrix(gplan.graph).T.copy(), dtype=torch.float32, device=dev).to_sparse_csr()
            run_k = lambda w, op=op_b: mix_bsr(*op, w)  # noqa: E731
            run_p = lambda w, op=op_b: mix_bsr_ref(*op, w)  # noqa: E731
            run_l = lambda w, csr=mt_csr: torch.sparse.mm(csr, w)  # noqa: E731
        kname = "mix_matmul" if gplan.backend == "dense" else "mix_bsr"
        for d_g in (1, 2, 3, 4):
            w = torch.rand(n_g, d_g, generator=gen, device=dev)
            e = compare(f"{kname} gossip {glabel} Mᵀ d={d_g}", lambda: run_k(w), run_p(w), w)
            if gplan.backend == "sparse":
                rows_bitwise(f"{kname} gossip {glabel} Mᵀ d={d_g}", op_b, w)
            errs[f"{kname}_gossip"] = max(errs[f"{kname}_gossip"], e)
            gossip_checked.add((kname, n_g, d_g, bn_g))
            b_g, op_g = bound(8 * n_g * d_g + op_bytes, 2 * nnz_t * d_g)
            gossip_shapes[(glabel, d_g)] = dict(
                kernel=kname, shape=f"{glabel} Mᵀ, d={d_g} fp32" + (f", bn {bn_g}" if bn_g else ""), max_abs_err=e,
                **({"dense_route": dense_route(n_g, d_g, torch.float32)} if kname == "mix_matmul" else {}),
                operator_bytes=op_bytes, stored_operator_bytes=stored,
                ms=time_ms(lambda: run_k(w), reps=21, flush=flush),
                held_ms=time_ms(lambda: run_k(w), reps=21, flush=flush, hold=True),
                plain_ms=time_ms(lambda: run_p(w), reps=7, flush=flush),
                library_ms=time_ms(lambda: run_l(w), reps=21, flush=flush),
                bound_ms=b_g, bound_by=op_g,
            )
    for (glabel, d_g), t in gossip_shapes.items():
        print(f"  {t['kernel']} gossip {glabel} Mᵀ d={d_g}: {t['ms']:.4f} ms as a caller pays (held {t['held_ms']:.4f}), "
              f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}; operator {t['operator_bytes']:,} B, stored "
              f"{t['stored_operator_bytes']:,} B), plain {t['plain_ms']:.4f} ms, "
              f"{'torch.matmul' if t['kernel'] == 'mix_matmul' else 'torch.sparse.mm'} {t['library_ms']:.4f} ms")
    print(f"  an empty kernel (held): {empty_ms:.4f} ms")
    # every dense gossip shape against torch.matmul on the same Mᵀ (as a
    # caller pays): at or below it within 5% (noise) is the aim, as a caller
    # pays and held; held 25% slower fails (a caller's time also carries
    # the host's hiccups: one run of this script on an H100 saw mix_bsr's
    # wrapper pay 0.0364 ms for a 0.0091 ms kernel at ring-1024, d = 3)
    for mode in ("ms", "held_ms"):
        ratio = {k: t[mode] / t["library_ms"] for k, t in gossip_shapes.items() if t["kernel"] == "mix_matmul"}
        over = {f"{g} d={d_g}": round(r, 3) for (g, d_g), r in ratio.items() if r > 1.05}
        print(f"  mix_matmul gossip shapes at or below torch.matmul (+5%), "
              f"{'as a caller pays' if mode == 'ms' else 'held'}: {len(ratio) - len(over)} of {len(ratio)}"
              + (f"; above: {over}" if over else ""))
    check(max(ratio.values()) <= 1.25, f"mix_matmul gossip shapes far slower than torch.matmul, held: {ratio}")

    # the dense mix's two routes across payload widths: each shape on both
    # routes (mix_kernel._launch, which counts nothing), checked against the
    # plain version, timed as a caller pays and held, beside torch.matmul;
    # the thin route should win up to the package's D_THIN and lose past it
    print(f"  dense mix crossover sweep (ms as a caller pays / held; package D_THIN = {mix_kernel.D_THIN}):")
    sweep, thin_wins = {}, {}
    for n_s in (8, 16, 64, 256):
        mt_s = compile_plan(T.random_k_regular(n_s, 4, seed=0), "dense", device=dev).send_operator()
        for d_s in (1, 2, 3, 4, 8, 16, 32, 64, 128, 1000):
            w = torch.rand(n_s, d_s, generator=gen, device=dev)
            row_s = {}
            for route in mix_kernel.ROUTES:
                run_s = lambda r=route: mix_kernel._launch(mt_s, w, r)  # noqa: E731
                compare(f"dense sweep {route} n={n_s} d={d_s}", run_s, decavg_mix_ref(mt_s, w), w)
                row_s[route] = (time_ms(run_s, reps=21, flush=flush), time_ms(run_s, reps=21, flush=flush, hold=True))
            row_s["torch.matmul"] = (time_ms(lambda: torch.matmul(mt_s, w), reps=21, flush=flush),)
            sweep[(n_s, d_s)] = row_s
            thin_wins[(n_s, d_s)] = row_s["thin"][1] <= row_s["wide"][1]
            print(f"    n={n_s:3d} d={d_s:4d}: " + "; ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                                                         for k, v in row_s.items())
                  + f"; package route {dense_route(n_s, d_s, torch.float32)}")
    d_grid = sorted({d for _, d in sweep})
    crossover = max((d for d in d_grid if all(thin_wins[(n_s, e)] for n_s in (8, 16, 64, 256) for e in d_grid if e <= d)),
                    default=0)
    print(f"  the thin route is held faster at every n up to d = {crossover} of the grid; the package's D_THIN is "
          f"{mix_kernel.D_THIN}")
    # the rows of the kernels line: the warmup's push-sum round (kreg4-16,
    # d = 3: x², the leader one-hot, the weight) and the CLI's ring-1024
    timing["mix_matmul_gossip"] = gossip_shapes[("kreg4-16", 3)]
    timing["mix_bsr_gossip"] = gossip_shapes[("ring-1024", 3)]
    del gossip_ops
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 4. quickstart
    phase("4. quickstart (complete-16, full-width MLP, He vs gain-corrected)")
    # the ported example itself (repro_torch/examples/quickstart.py), its
    # trajectories printed as a user sees them
    ROUNDS = quickstart.ROUNDS
    reset_counts()
    t0 = time.perf_counter()
    gain, hists = quickstart.run(device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    quick_launches = {kern.__name__: kern.launches for kern in kernels}
    he, corr = hists[0]["test_loss"][-1], hists[1]["test_loss"][-1]
    print(f"  2 runs x {ROUNDS} rounds in {wall:.2f} s (setup included); launches {quick_launches}")
    check(all(math.isfinite(v) for h in hists for v in h["test_loss"] + h["train_loss"]), "non-finite loss")
    check(abs(he - math.log(10)) < 0.01, f"He final test loss {he} not within 0.01 of ln 10")
    check(corr < 2.0, f"corrected final test loss {corr} not below 2.0")
    check(quick_launches == {**none_launched, "mix_matmul": 2 * ROUNDS},
          f"launch counts {quick_launches}")
    # the example's setup, for the phases that follow (4b, 5)
    q = quickstart.setup(dev)
    graph, xs, ys, test, schedule, B_LOCAL = q.graph, q.xs, q.ys, q.test, q.schedule, quickstart.B_LOCAL
    loss_fn, opt, eval_fn, states = q.loss_fn, q.opt, q.eval_fn, q.states
    check(states[0].params.shape == (quickstart.N_NODES, D_MAIN), f"ensemble shape {tuple(states[0].params.shape)}")

    # ------------------------------------------- 4b. compressed quickstart
    phase("4b. compressed quickstart (complete-16, full-width MLP, gain-corrected, 40 rounds)")
    # fig12's codec sweep on the quickstart setup: int8 and fp8 must end
    # within 2% of the uncompressed final test loss; qtopk at frac 0.3, γ 0.5
    # is its acceptance codec (4.43x fewer bytes).  Every int8 / fp8 round
    # is one launch of the dense round (scales, decode and mix; no scales
    # pass), on the staged route; qtopk's h' mixes through the dense DecAvg
    # kernel.
    codecs = [("none", None), ("int8", Compression("int8")), ("fp8", Compression("fp8")),
              ("qtopk", Compression("qtopk", topk_frac=0.3, gamma=0.5))]
    comp_final, comp_launches = {}, {}
    for label, comp in codecs:
        rf = make_round_fn(loss_fn, opt, graph, device=dev, compression=comp)
        reset_counts()
        routes_before = dict(quant_mix_dense.launches_by_route)
        t0 = time.perf_counter()
        final, h = run_trajectory(
            states[1], rf, xs, ys, schedule, n_rounds=ROUNDS, eval_every=5, eval_fn=eval_fn, eval_batch=test,
            b_local=B_LOCAL, device=dev,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        comp_launches[label] = {kern.__name__: kern.launches for kern in kernels}
        comp_routes = {k: v - routes_before[k] for k, v in quant_mix_dense.launches_by_route.items()}
        check(comp_routes == {"staged": comp_launches[label]["quant_mix_dense"], "wide": 0},
              f"{label}: dense round routes {comp_routes}")
        ratio = 1.0 if comp is None else 4 * D_MAIN / sum(comp.leaf_row_bytes(sz, np.float32)
                                                          for sz in final.layout.sizes)
        comp_final[label] = h["test_loss"][-1]
        check(all(math.isfinite(v) for v in h["test_loss"] + h["train_loss"]), f"{label}: non-finite loss")
        check((final.residual is None) == (comp is None), f"{label}: mirror carried {final.residual is not None}")
        print(f"  {label:6s} bytes/row reduction {ratio:.3f}x; test loss @ {h['round'][::2]}: "
              + "  ".join(f"{v:.4f}" for v in h["test_loss"][::2]) + f"; final {comp_final[label]:.4f}; "
              f"{ROUNDS} rounds in {wall:.2f} s; launches "
              + str({k: v for k, v in comp_launches[label].items() if v}))
    for label in ("int8", "fp8"):
        rel = comp_final[label] / comp_final["none"] - 1
        print(f"  {label}: final test loss {rel:+.3%} against the uncompressed run")
        check(abs(rel) <= 0.02, f"{label} final test loss {comp_final[label]} not within 2% of "
                                f"{comp_final['none']}")
        check(comp_launches[label] == {**none_launched, "quant_mix_dense": ROUNDS},
              f"{label} launch counts {comp_launches[label]}")
    for label in ("none", "qtopk"):
        check(comp_launches[label] == {**none_launched, "mix_matmul": ROUNDS}, f"{label} launch counts "
                                                                              f"{comp_launches[label]}")

    # ------------------------------------- 4c. paper cfg B and C
    phase("4c. paper cfg B (CNN, BA(m=8)-16, Zipf α 1.8) and cfg C (VGG16 at full width, kreg4-16)")
    # cfg B through the CLI, gain-corrected and He, 30 rounds.  The JAX
    # package's CLI on the CPU at the same settings (--model cnn --topology ba
    # --zipf 1.8 --nodes 16 --rounds 30) shows: the corrected init (gain 3.95
    # over six layers) diverges, every recorded loss NaN from round 0; the He
    # init stays finite on the 17-class plateau, test loss within 0.01 of
    # ln 17.  The card run is held to the same comparison.
    cnn_hist = {}
    for label, extra in (("corrected", []), ("He", ["--no-gain-correction"])):
        reset_counts()
        t0 = time.perf_counter()
        cnn_hist[label] = cli.main(["--model", "cnn", "--topology", "ba", "--zipf", "1.8", "--nodes", "16",
                                    "--rounds", "30", *extra])
        torch.cuda.synchronize()
        cnn_launches = {kern.__name__: kern.launches for kern in kernels}
        print(f"  CNN {label}: 30 rounds in {time.perf_counter() - t0:.2f} s incl. data generation; launches "
              + str({k: v for k, v in cnn_launches.items() if v}))
        check(cnn_launches == {**none_launched, "mix_matmul": 30}, f"CNN {label} launch counts {cnn_launches}")
    corr_h, he_h = cnn_hist["corrected"], cnn_hist["He"]
    check(all(math.isnan(v) for v in corr_h["test_loss"] + corr_h["train_loss"]),
          "CNN corrected: the JAX package's run diverges from round 0, the card's did not")
    check(all(math.isfinite(v) for k in ("train_loss", "test_loss", "sigma_ap", "sigma_an") for v in he_h[k]),
          "CNN He: non-finite history")
    check(all(abs(v - math.log(17)) < 0.01 for v in he_h["test_loss"]),
          f"CNN He: test loss off the ln 17 plateau {he_h['test_loss']}")
    print(f"  as the JAX CPU run: corrected NaN from round 0, He on the ln 17 = {math.log(17):.4f} plateau "
          f"(test loss {min(he_h['test_loss']):.4f}-{max(he_h['test_loss']):.4f})")
    # cfg C through the CLI (width 0.25, as the JAX CLI; He, see below)
    reset_counts()
    t0 = time.perf_counter()
    hist = cli.main(["--model", "vgg16", "--topology", "kregular", "--nodes", "16", "--rounds", "2",
                     "--no-gain-correction"])
    torch.cuda.synchronize()
    cli_v_launches = {kern.__name__: kern.launches for kern in kernels}
    print(f"  CLI VGG16 (width 0.25): 2 rounds in {time.perf_counter() - t0:.2f} s incl. data generation; launches "
          + str({k: v for k, v in cli_v_launches.items() if v}))
    check(all(math.isfinite(v) for k in ("train_loss", "test_loss", "sigma_ap", "sigma_an") for v in hist[k]),
          "CLI VGG16: non-finite history")
    check(cli_v_launches == {**none_launched, "mix_matmul": 2}, f"CLI VGG16 launch counts {cli_v_launches}")

    # cfg C at full width (d = 33,638,218 a node; 2.15 GB a copy of the
    # 16-node ensemble): random 4-regular, 2 rounds, then 2 int8 rounds, each
    # recorded (the eval on 1024 shared images).  He init: the corrected gain
    # (4.0 over 16 layers) overflows fp32 in the first round, on the card and in
    # the JAX package's CLI on the CPU (width 0.25: round-0 train loss 7.5e9,
    # test loss NaN).  Exactly one mix launch a round; then one round run twice
    # from one state must agree bit for bit (cuDNN's deterministic algorithms,
    # device.py), and one round's local steps and mix are timed apart.
    n_v, items_v, b_v = 16, 64, 2
    g_v = T.random_k_regular(n_v, 4, seed=0)
    ds_v = cifar10_like(n_v * items_v + 1024, seed=0)
    xs_v, ys_v = node_datasets(ds_v, partition_iid(n_v * items_v, n_v, seed=0))
    eval_v = (ds_v.x[-1024:], ds_v.y[-1024:])

    def loss_v(p, b):
        return classifier_loss(vgg16_forward(p, b[0]), b[1])

    opt_v = sgd(1e-3, 0.5)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st_v = init_fl_state(0, n_v, lambda g, gains: init_vgg16(InitConfig("he_normal", gains), g), opt_v, device=dev)
    check(st_v.params.shape == (n_v, D_VGG), f"VGG16 ensemble {tuple(st_v.params.shape)}")
    sched_v = batch_index_schedule(items_v, n_v, 16, 4 * b_v, seed=0)
    vgg_runs, vgg_launches = {}, {}
    state_v = st_v
    for label, comp, rows in (("uncompressed", None, slice(0, 2 * b_v)), ("int8", Compression("int8"),
                                                                         slice(2 * b_v, 4 * b_v))):
        rf_v = make_round_fn(loss_v, opt_v, g_v, device=dev, compression=comp)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state_v, h_v = run_trajectory(
            state_v, rf_v, xs_v, ys_v, sched_v[rows], n_rounds=2, eval_every=1, eval_fn=make_eval_fn(loss_v),
            eval_batch=eval_v, track_sigmas=True, b_local=b_v, device=dev,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        vgg_launches[label] = {kern.__name__: kern.launches for kern in kernels}
        vgg_runs[label] = h_v
        print(f"  VGG16 {label}: 2 rounds (each with its eval and σ) in {wall:.2f} s; train loss "
              f"{[round(v, 4) for v in h_v['train_loss']]}, test loss {[round(v, 4) for v in h_v['test_loss']]}, "
              f"σ_ap {[f'{v:.5f}' for v in h_v['sigma_ap']]}, σ_an {[f'{v:.5f}' for v in h_v['sigma_an']]}; "
              f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches " + str({k: v for k, v in vgg_launches[label].items() if v}))
        check(all(math.isfinite(v) for k in ("train_loss", "test_loss", "sigma_ap", "sigma_an") for v in h_v[k]),
              f"VGG16 {label}: non-finite history")
    check(vgg_launches["uncompressed"] == {**none_launched, "mix_matmul": 2},
          f"VGG16 launch counts {vgg_launches['uncompressed']}")
    check(vgg_launches["int8"] == {**none_launched, "quant_mix_dense": 2},
          f"VGG16 int8 launch counts {vgg_launches['int8']}")
    # one round from one state, twice: bitwise; then its parts by the host clock
    rf_v = make_round_fn(loss_v, opt_v, g_v, device=dev)
    idx_v = torch.as_tensor(sched_v[:b_v], device=dev).long().permute(1, 0, 2)  # (n, b, bs)
    node_v = torch.arange(n_v, device=dev)[:, None, None]
    xs_vd, ys_vd = torch.as_tensor(xs_v, device=dev), torch.as_tensor(ys_v, device=dev)
    batch_v = (xs_vd[node_v, idx_v], ys_vd[node_v, idx_v])
    del xs_vd, ys_vd
    outs, round_s = [], []
    for _ in range(3):
        s_copy = copy_state(st_v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_out, _ = rf_v(s_copy, batch_v)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        outs.append(s_out.params)
        del s_copy, s_out
    same = all(torch.equal(outs[0], o) for o in outs[1:])
    del outs
    s_copy = copy_state(st_v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_v, _, _ = local_steps(loss_v, opt_v, s_copy.layout, s_copy.params, s_copy.opt_state, batch_v)
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rf_v.plan.mix(p_v)
    torch.cuda.synchronize()
    mix_s = time.perf_counter() - t0
    # the per-step relayout of the conv weights, HWIO → grouped OIHW in
    # channels-last memory (paper_models.py::_conv): one copy of every conv
    # leaf of the ensemble a forward (0.94 GB at n = 16), its gradient copied
    # back alike in the backward
    conv_w = [st_v.tree[k]["w"] for k in st_v.tree if k.startswith("conv")]
    relayout_bytes = 2 * 4 * sum(w.numel() for w in conv_w)
    relayout_ms = time_ms(lambda: [w.permute(0, 4, 1, 2, 3).contiguous() for w in conv_w], flush=flush)
    print(f"  VGG16 conv weight relayout: {relayout_ms:.4f} ms a forward for {relayout_bytes / 2 / 1e9:.3f} GB "
          f"({relayout_bytes / relayout_ms / 1e6:.0f} GB/s read + written)")
    del conv_w
    sig = {k: float(v) for k, v in sigma_metrics(st_v.params).items()}
    vgg_peak = torch.cuda.max_memory_allocated() / 2**30  # since the int8 run began
    print(f"  VGG16 round (2 local steps of 16 images a node, then the mix), host clock after a sync: "
          f"{', '.join(f'{t * 1e3:.2f}' for t in round_s)} ms; three runs from one state bitwise equal: {same}")
    print(f"  VGG16 one round's parts, host clock after a sync (inferred split): local steps {local_s * 1e3:.2f} ms "
          f"({local_s / (local_s + mix_s):.1%}), mix {mix_s * 1e3:.2f} ms; σ at init {sig}; "
          f"peak device memory since the int8 run began {vgg_peak:.2f} GiB")
    check(same, "VGG16: one round from one state differs between runs")
    del st_v, state_v, s_copy, p_v, batch_v
    torch.cuda.empty_cache()

    # -------------------------------------------------------- 4d. figures
    phase("4d. figures: fig1 quick (complete 8 / 16 / 32, 400 rounds, He vs proposed) and fig3's diffusion model")
    reset_counts()
    fig_common.ROWS.clear()
    t0 = time.perf_counter()
    fig1 = fig1_scaling.run(quick=True, device=dev)
    torch.cuda.synchronize()
    fig1_wall = time.perf_counter() - t0
    fig1_launches = {kern.__name__: kern.launches for kern in kernels}
    print(f"  fig1 quick: {fig1_wall:.1f} s on {smi}; launches " + str({k: v for k, v in fig1_launches.items() if v}))
    check(fig1_launches == {**none_launched, "mix_matmul": 2 * 400 * len(fig1)}, f"fig1 launch counts {fig1_launches}")
    jax_final = {8: 0.5634, 16: 0.3826, 32: 0.3915}  # BENCH_rounds.json, the JAX package on the CPU
    for n_f, (h_he, h_prop) in fig1.items():
        r_he, r_prop = fig_common.rounds_to_loss(h_he, 2.25), fig_common.rounds_to_loss(h_prop, 2.25)
        print(f"  n={n_f}: below 2.25 at round {r_prop} (proposed) and {r_he} (He); proposed final test loss "
              f"{h_prop['test_loss'][-1]:.4f} (the JAX package's, other draws, on the CPU: {jax_final[n_f]})")
        check(all(math.isfinite(v) for h in (h_he, h_prop) for v in h["test_loss"]), f"fig1 n={n_f}: non-finite")
        check(r_prop < r_he, f"fig1 n={n_f}: the proposed init did not leave the plateau before He")
    # The JAX package's fig1 quick on the CPU (other draws): He below 2.25 at
    # round 204 at n = 8, still above it after 400 rounds at n = 16 and 32
    # (final 2.279, 2.297), so its μ fit has one point and is NaN.  The card
    # run is held to the same: the He plateau ends within the 400 rounds at
    # n = 8 only.
    ended = {n_f: math.isfinite(fig_common.rounds_to_loss(h_he, 2.25)) for n_f, (h_he, _) in fig1.items()}
    mu = float(next(r for r in fig_common.ROWS if r.startswith("fig1.scaling_exponent")).split("mu=")[1].split(";")[0])
    print(f"  He plateau ended within 400 rounds: {ended} (the JAX CPU run: n=8 only); fitted μ {mu} (JAX: nan)")
    check(ended == {8: True, 16: False, 32: False}, f"fig1: He plateaus ended {ended}, the JAX run's at n=8 only")
    # fig3's numerical model at the band of tests/test_diffusion.py::
    # test_sigma_ap_approaches_prediction_regular: σ_ap's last value within
    # 5% of σ_init‖v_steady‖; the draws are the CPU generator's on either
    # device, so the card's trajectory is also held to the CPU's, to 1e-6 ·
    # σ_init (σ_an ends near 1e-5: fp32 sums in another order move it by more
    # than 1e-4 of itself)
    res = {d_name: run_diffusion(T.random_k_regular(256, 32, seed=0), d=512, sigma_init=1.0, sigma_noise=1e-5,
                                 rounds=120, seed=0, device=d_name) for d_name in ("cuda", "cpu")}
    r_gpu, r_cpu = res["cuda"], res["cpu"]
    d_ap = float(np.max(np.abs(r_gpu.sigma_ap - r_cpu.sigma_ap)))
    d_an = float(np.max(np.abs(r_gpu.sigma_an - r_cpu.sigma_an)))
    print(f"  diffusion kreg32-256: σ_ap {r_gpu.sigma_ap[0]:.4f} → {r_gpu.sigma_ap[-1]:.6f} against the prediction "
          f"{r_gpu.sigma_ap_prediction:.6f} ({r_gpu.sigma_ap[-1] / r_gpu.sigma_ap_prediction - 1:+.2%}, band ±5%); "
          f"σ_an {r_gpu.sigma_an[0]:.4f} → {r_gpu.sigma_an[-1]:.3e}; card vs CPU max abs diff σ_ap {d_ap:.1e}, "
          f"σ_an {d_an:.1e}")
    check(abs(r_gpu.sigma_ap[-1] / r_gpu.sigma_ap_prediction - 1) <= 0.05, "diffusion: σ_ap off the prediction")
    check(d_ap <= 1e-6 and d_an <= 1e-6, "diffusion: card vs CPU trajectories differ")

    # ------------------------------------------- 4e. uncoordinated init
    phase("4e. uncoordinated init (§4.4): gossip estimation at scale, the warmup at full width, fig4 quick, the CLI")
    # every gossip round is one launch of mix_matmul / mix_bsr over Mᵀ at a
    # payload of d ≤ 4 columns.  Launch counts come from the kernels' own
    # counters, set to 0 before each run (counted); the kernels line's gossip
    # rows take theirs from two named estimator runs (the warmup's and the
    # CLI ring-1024's).  A recording wrapper only collects the (kernel, n, d,
    # bn) of every launch of the phase (a call on CPU tensors, the CPU runs
    # it is compared with, launches nothing), the estimates bench's
    # included, so that each gossip shape is held to phase 3's.
    launched_4e = set()
    real_mm, real_bsr = mix_ops.mix_matmul, mix_ops.mix_bsr

    def recording_mm(m, w):
        if w.is_cuda:
            launched_4e.add(("mix_matmul", *w.shape, 0))
        return real_mm(m, w)

    def recording_bsr(block_cols, tiles, counts, w, n_rows=None):
        if w.is_cuda:
            launched_4e.add(("mix_bsr", *w.shape, tiles.shape[-1]))
        return real_bsr(block_cols, tiles, counts, w, n_rows)

    def counted(fn):
        """fn() with every count set to 0 before; (result, seconds, launches
        by kernel)."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, {kern.__name__: kern.launches for kern in kernels}

    def rel_err(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    mix_ops.mix_matmul, mix_ops.mix_bsr = recording_mm, recording_bsr
    # (a) estimation at scale: power iteration and estimate_all, 32 + 32
    # rounds on kreg4-1024 and heavytail-1024, sparse, link_p 0.9: Σx = n
    # kept, a rerun bitwise, the card equal to the CPU's port for the same
    # seed (the same CPU-generator draws, so the same masks), exactly one
    # launch a round
    fm9 = FailureModel(link_p=0.9)
    for glabel, g in (("kreg4-1024", T.random_k_regular(1024, 4, seed=0)),
                      ("heavytail-1024", T.configuration_heavy_tail(1024, 2.2, seed=0))):
        plan_g = compile_plan(g, "sparse", failures=fm9, device=dev)
        plan_c = compile_plan(g, "sparse", failures=fm9, device="cpu")
        est, pi_s, launches = counted(lambda: G.power_iteration_norm(plan_g, 32, 32, 1))
        check(launches == {**none_launched, "mix_bsr": 64},
              f"{glabel} power iteration: launches {launches}, want 64 on mix_bsr")
        again = G.power_iteration_norm(plan_g, 32, 32, 1)
        cpu = G.power_iteration_norm(plan_c, 32, 32, 1)
        mass = abs(float(est["x"].double().sum()) - g.n) / g.n
        bitwise = all(torch.equal(est[k], again[k]) for k in est)
        errs_cpu = {k: rel_err(est[k], cpu[k]) for k in ("vnorm", "n_hat", "x")}
        same_reached = torch.equal(est["reached"].cpu(), cpu["reached"])
        alle, _, launches_all = counted(lambda: G.estimate_all(plan_g, pi_rounds=32, ps_rounds=32, seed=1))
        alle_c = G.estimate_all(plan_c, pi_rounds=32, ps_rounds=32, seed=1)
        errs_all = {k: rel_err(getattr(alle, k), getattr(alle_c, k)) for k in ("n_hat", "vnorm", "mean_degree")}
        exact = v_steady_norm(g)
        print(f"  {glabel} link_p 0.9, 32 + 32 rounds: power iteration {pi_s * 1e3:.2f} ms ({pi_s / 64 * 1e6:.1f} µs "
              f"a round); |Σx − n|/n {mass:.2e}; rerun bitwise {bitwise}; card vs CPU rel err {errs_cpu}, reached "
              f"equal {same_reached} ({int(est['reached'].sum())} of {g.n}); ‖v̂‖ median "
              f"{float(est['vnorm'].median()):.5f} against the exact {exact:.5f}; estimate_all card vs CPU {errs_all}, "
              f"⟨k̂⟩ median {float(alle.mean_degree.median()):.3f} (true {g.degrees.mean():.3f}); launches "
              f"{launches['mix_bsr']} and {launches_all['mix_bsr']} mix_bsr")
        check(mass <= 1e-5, f"{glabel}: power iteration lost mass ({mass})")
        check(bitwise, f"{glabel}: two runs of the estimator differ")
        check(max(errs_cpu.values()) <= 1e-5 and same_reached, f"{glabel}: card and CPU estimates differ {errs_cpu}")
        check(max(errs_all.values()) <= 1e-5 and torch.equal(alle.reached.cpu(), alle_c.reached),
              f"{glabel}: card and CPU estimate_all differ {errs_all}")
        check(launches_all == {**none_launched, "mix_bsr": 64}, f"{glabel} estimate_all launches {launches_all}")
        del plan_g, plan_c
    # µs a gossip round (host clock after a sync, 32 + 32 power-iteration
    # rounds): dense kreg4-64 and sparse kreg4-1024, without failures and
    # at link_p 0.9 (the round's draws on the CPU generator, copied over)
    round_us = {}
    for glabel, g, backend in (("kreg4-64 dense", T.random_k_regular(64, 4, seed=0), "dense"),
                               ("kreg4-1024 sparse", T.random_k_regular(1024, 4, seed=0), "sparse")):
        for fm in (FailureModel(), fm9):
            plan_g = compile_plan(g, backend, failures=fm, device=dev)
            G.power_iteration_norm(plan_g, 32, 32, 1)  # warm
            walls = [counted(lambda: G.power_iteration_norm(plan_g, 32, 32, 1))[1] for _ in range(3)]
            round_us[(glabel, fm.link_p)] = sorted(walls)[1] / 64 * 1e6
    print("  µs a gossip round, median of 3 × 64 rounds: " + "; ".join(
        f"{k[0]} link_p {k[1]:g}: {v:.1f}" for k, v in round_us.items()))
    # the compressed send form on the card: int8 over Mᵀ, dense and BSR, 8
    # rounds at link_p 0.9, each round also run on the CPU from the card's
    # state before it: the new mirrors bitwise (the quantisation is
    # elementwise the plain version's), the values to 1e-5 · max|v|, the
    # total kept over the 8 rounds.  (Run apart for 8 rounds, the two drift
    # by ulps and a code near a half-integer flips: phase 5 counts those.)
    comp3 = Compression("int8", chunk=3)
    for glabel, g in (("kreg4-16", T.random_k_regular(16, 4, seed=0)), ("ring-1024", T.ring(1024))):
        plan_g, plan_c = (compile_plan(g, failures=fm9, device=d_name) for d_name in ("cuda", "cpu"))
        v0 = torch.as_tensor(np.random.default_rng(0).random((g.n, 3)).astype(np.float32))
        v, h = v0.to(dev), torch.zeros(g.n, 3, device=dev)
        worst, same_h = 0.0, True
        for r in range(8):
            v_c, h_c = plan_c.spread(v.cpu(), G.round_generator(3, r), compression=comp3, residual=h.cpu())
            v, h = plan_g.spread(v, G.round_generator(3, r), compression=comp3, residual=h)
            same_h = same_h and torch.equal(h.cpu(), h_c)
            worst = max(worst, float((v.cpu() - v_c).abs().max()) / (1e-5 * max(float(v_c.abs().max()), 1.0)))
        mass = float(((v.double().sum(0).cpu() - v0.double().sum(0)).abs() / v0.double().sum(0)).max())
        print(f"  compressed spread int8 {glabel} link_p 0.9, 8 rounds: total kept to {mass:.1e}; each round from the "
              f"card's state: mirrors bitwise the CPU's {same_h}, values worst err / (1e-5·max|v|) {worst:.3f}")
        check(mass <= 1e-5 and same_h and worst <= 1.0, f"compressed spread {glabel}: card vs CPU")
    # the port's estimates_bench quick rows (µs a round, push-sum and power
    # iteration, dense and sparse, family × n ∈ {16, 64, 256}); its launch
    # shapes are recorded too
    fig_common.ROWS.clear()
    t0 = time.perf_counter()
    bench = estimates_bench.run(quick=True, device=dev)
    print(f"  estimates_bench quick: {len(bench['records'])} records in {time.perf_counter() - t0:.1f} s, "
          f"written to build/estimates_bench.json")
    for rec in bench["records"]:
        print(f"    {rec['family']:9s} n={rec['n']:4d}: push-sum µs a round dense {rec['us_dense']:.1f}, sparse "
              f"{rec['us_sparse']:.1f}; power iteration dense {rec['us_pi_dense']:.1f}, sparse {rec['us_pi_sparse']:.1f}")

    # (b) the fused warmup at the paper MLP's full width (d = 567,434):
    # the ported example (kreg4-16, link_p 0.8, 40 rounds × 4 local steps;
    # budgets 4 and 32, perfect knowledge, He), then the budget-32 warmup
    # timed alone.  The JAX package's example on the CPU (other draws):
    # gains ∈ [3.26, 5.46] and final test loss 1.498 at budget 4, [3.93,
    # 3.93] and 1.508 at 32, 1.622 at the exact gain 4.00, He 2.302; held
    # here: He within 0.01 of ln 10, budget 32 below 2.0 (phase 4's bounds)
    U = uncoordinated_init
    out_u, wall_u, launches_u = counted(lambda: U.run(device=dev))
    n_gossip_u = 64 + 2 * sum(U.BUDGETS.values())  # the convergence report's 64, then each budget's two phases
    n_train_u = (len(U.BUDGETS) + 2) * U.ROUNDS
    print(f"  example: {wall_u:.1f} s; launches {launches_u} ({n_gossip_u} gossip and {n_train_u} training rounds)")
    check(launches_u == {**none_launched, "mix_matmul": n_gossip_u + n_train_u}, f"example launch counts {launches_u}")
    for label in (*U.BUDGETS, "perfect knowledge", "He baseline (no correction)"):
        hist_u = out_u[label][0]
        check(all(math.isfinite(v) for v in hist_u["test_loss"] + hist_u["train_loss"]), f"{label}: non-finite")
    he_u = out_u["He baseline (no correction)"][0]["test_loss"][-1]
    g32 = out_u["converged budget (32 rounds)"]
    check(abs(he_u - math.log(10)) < 0.01, f"example: He final test loss {he_u} not within 0.01 of ln 10")
    check(g32[0]["test_loss"][-1] < 2.0, f"example: budget-32 final test loss {g32[0]['test_loss'][-1]} not below 2.0")
    q_u = U.setup("cpu")
    gains_c = G.make_gain_estimator(q_u.est_plan, pi_rounds=32, ps_rounds=32)(split_seed(0, 2)[0])
    gain_err = rel_err(torch.as_tensor(g32[1]), gains_c)
    print(f"  budget-32 gains card vs CPU: max rel err {gain_err:.1e} (bound 1e-4)")
    check(gain_err <= 1e-4, f"example: budget-32 gains card vs CPU {gain_err}")
    q_u = U.setup(dev)
    est_u = G.make_gain_estimator(q_u.est_plan, pi_rounds=32, ps_rounds=32)
    # the warmup's estimation alone (the gossip row of mix_matmul in the
    # kernels line takes its launches from this run), then the whole warmup
    gains_e, est_s, launches_e = counted(lambda: est_u(split_seed(0, 2)[0]))
    gossip_launches = {"mix_matmul": launches_e["mix_matmul"]}
    check(launches_e == {**none_launched, "mix_matmul": 64}, f"budget-32 estimation launches {launches_e}")
    (_, _, gains_w), warm_s, launches_w = counted(lambda: run_warmup_trajectory(
        0, q_u.rf, q_u.xs, q_u.ys, q_u.sched, n_nodes=U.N_NODES, init_one=q_u.init_one, optimizer=q_u.opt,
        estimate_gains=est_u, **q_u.common))
    print(f"  budget-32 warmup alone, host clock after a sync: {warm_s:.3f} s, of it the 64 gossip rounds "
          f"{est_s * 1e3:.2f} ms ({est_s / 64 * 1e6:.1f} µs a round), the init and {U.ROUNDS} training rounds "
          f"{(warm_s - est_s) / U.ROUNDS * 1e3:.2f} ms a round; launches {launches_w['mix_matmul']} mix_matmul, "
          f"the estimation alone {launches_e['mix_matmul']}")
    check(launches_w == {**none_launched, "mix_matmul": 64 + U.ROUNDS}, f"budget-32 warmup launches {launches_w}")
    check(np.array_equal(gains_w, g32[1]) and np.array_equal(gains_e.cpu().numpy(), g32[1]),
          "budget-32 warmup: gains differ between runs")
    del q_u

    # (c) fig4 quick through the port's driver: every row finite
    fig_common.ROWS.clear()
    _, wall_f4, launches_f4 = counted(lambda: fig4_estimates.run(quick=True, device=dev))
    rows_f4 = [r for r in fig_common.ROWS if r.startswith("fig4.")]
    nums = [float(r.split(",")[1]) for r in rows_f4] + [float(kv.split("=")[1]) for r in rows_f4
                                                         for kv in r.split(",", 2)[2].split(";")]
    print(f"  fig4 quick: {len(rows_f4)} rows in {wall_f4:.1f} s; launches {launches_f4}")
    check(len(rows_f4) == 13 and all(math.isfinite(x) for x in nums), "fig4 quick: a row is missing or not finite")
    check(launches_f4 == {**none_launched, "mix_matmul": 2 * (4 + 8 + 16) + 13 * 60},
          f"fig4 launch counts {launches_f4}")

    # (d) the CLI: kreg-16 at link_p 0.9, 24 + 24 rounds; ring-1024, 32 + 32
    # rounds, the leader's and the leaderless estimator.  The gains are
    # held to the port's estimator on the CPU (the CLI's seed 0 splits as
    # run_warmup_trajectory splits it).  On ring-1024 (diameter 512) 32
    # rounds carry the leader's mass 32 hops a side: the other nodes fall
    # back to gain 1.0; the reached ones closest to the frontier hold z down
    # to ~(1/3)^32, so gains up to ~4e7, and training diverges.  The JAX
    # package at these settings (no failures, so no draws;
    # tests/test_torch_warmup.py::test_ring1024_leader_gains_match_jax_and_
    # the_frontier_diverges): gains 1.0 at the 959 unreached nodes, up to
    # 43,046,700 (the port's CPU estimator agrees to 2e-7), and one node at
    # that gain goes from a loss of ~1e31 to NaN after one SGD step, so the
    # CLI's losses go NaN in both packages.  Held here: the gains' range to
    # the JAX package's within 1e-4, and that run's round-0 loss non-finite;
    # the leaderless run's losses finite.  After each CLI run its estimator
    # runs again alone on the card, counts set to 0 before: its launches
    # (the gossip row of mix_bsr in the kernels line takes ring-1024's) and
    # its gains, bitwise the CLI's.
    JAX_RING_1024 = dict(min_gain=1.0, max_gain=43046700.0, unreached=959)
    captured = {}

    def capture_warmup(*args, **kwargs):
        result = real_warmup(*args, **kwargs)
        captured.update(gains=result[2], estimate=kwargs["estimate_gains"])
        return result

    real_warmup, cli.run_warmup_trajectory = cli.run_warmup_trajectory, capture_warmup
    est_seed0 = split_seed(0, 2)[0]
    cli_runs = (
        ("kreg-16", ["--topology", "kregular", "--nodes", "16", "--estimate-rounds", "24", "--link-p", "0.9",
                     "--rounds", "20"], "mix_matmul", 48, 20),
        ("ring-1024", ["--topology", "ring", "--nodes", "1024", "--rounds", "3", "--local-batches", "2",
                       "--estimate-rounds", "32"], "mix_bsr", 64, 3),
        ("ring-1024 leaderless", ["--topology", "ring", "--nodes", "1024", "--rounds", "3", "--local-batches", "2",
                                  "--estimate-rounds", "32", "--leaderless"], "mix_bsr", 64, 3),
    )
    for clabel, argv, kname, n_gossip, n_train in cli_runs:
        hist_c, wall_c, launches_c = counted(lambda: cli.main(["--model", "mlp", "--uncoordinated-init", *argv]))
        args_c = dict(zip(argv[::2], argv[1::2]))
        graph_c = cli.build_graph(args_c["--topology"], int(args_c["--nodes"]), 0)
        plan_c = compile_plan(graph_c, failures=FailureModel(link_p=float(args_c.get("--link-p", 1.0))), device="cpu")
        est_c = G.make_gain_estimator(plan_c, pi_rounds=int(args_c["--estimate-rounds"]),
                                      ps_rounds=int(args_c["--estimate-rounds"]), leaderless="--leaderless" in argv)
        gains_cpu = est_c(est_seed0)
        gains_card = torch.as_tensor(captured["gains"])
        reached = captured["estimate"].reached
        gains_alone, _, launches_alone = counted(lambda: captured["estimate"](est_seed0))
        err_c = rel_err(gains_card, gains_cpu)
        losses = {k: hist_c[k] for k in ("train_loss", "test_loss")}
        print(f"  CLI {clabel}: {wall_c:.1f} s incl. data generation; launches {launches_c}, its estimator alone "
              f"{launches_alone[kname]} {kname}; "
              f"gains {float(gains_card.min()):.3g}–{float(gains_card.max()):.3g}, card vs CPU max rel err {err_c:.1e}"
              + ("" if reached is None else f"; reached {int(reached.sum())} of {graph_c.n} (CPU: "
                 f"{int(est_c.reached.sum())})") + f"; losses {losses}")
        check(launches_c == {**none_launched, kname: n_gossip + n_train}, f"CLI {clabel}: launches {launches_c}")
        check(launches_alone == {**none_launched, kname: n_gossip}, f"CLI {clabel}: estimator launches {launches_alone}")
        check(torch.equal(gains_alone.cpu(), gains_card), f"CLI {clabel}: the estimator alone gives other gains")
        check(err_c <= 1e-4, f"CLI {clabel}: gains card vs CPU {err_c}")
        check(len(hist_c["round"]) == min(20, n_train), f"CLI {clabel}: recorded rounds {hist_c['round']}")
        if reached is not None:
            check(torch.equal(reached.cpu(), est_c.reached), f"CLI {clabel}: reached nodes differ from the CPU's")
            check(bool((gains_card[~reached.cpu()] == 1.0).all()), f"CLI {clabel}: an unreached node's gain is not 1")
        if clabel != "ring-1024":
            check(all(math.isfinite(v) for vs in losses.values() for v in vs), f"CLI {clabel}: non-finite losses")
        else:
            gossip_launches["mix_bsr"] = launches_alone["mix_bsr"]
            lo, hi = float(gains_card.min()), float(gains_card.max())
            n_one = int((gains_card == 1.0).sum())
            print(f"  CLI ring-1024 against the JAX package at these settings: gains {lo}–{hi} ({n_one} at 1.0), "
                  f"JAX {JAX_RING_1024['min_gain']}–{JAX_RING_1024['max_gain']} ({JAX_RING_1024['unreached']} at 1.0)")
            check(lo == JAX_RING_1024["min_gain"] and abs(hi / JAX_RING_1024["max_gain"] - 1) <= 1e-4
                  and n_one == JAX_RING_1024["unreached"], "CLI ring-1024: gains off the JAX package's")
            check(not math.isfinite(losses["train_loss"][0]),
                  "CLI ring-1024: round-0 loss finite where the JAX package's frontier node goes NaN")
    cli.run_warmup_trajectory = real_warmup
    mix_ops.mix_matmul, mix_ops.mix_bsr = real_mm, real_bsr
    gossip_keys = {key for key in launched_4e if key[2] <= 4}
    unchecked = gossip_keys - gossip_checked
    check(not unchecked, f"phase 4e launched gossip shapes {sorted(unchecked)} not checked in phase 3")
    print(f"  the phase's gossip launches ran at {len(gossip_keys)} distinct (kernel, n, d, bn), each held against "
          f"the plain version in phase 3; the kernels line's gossip launches: {gossip_launches} (the budget-32 "
          f"estimation, the CLI ring-1024's estimator)")
    torch.cuda.empty_cache()

    # ---------------------------------- 4f. schedules and the colour backend
    phase("4f. time-varying topologies (PlanSchedule, churn, fig 8), the edge-coloured backend, the chunk hook")
    t_4f = time.perf_counter()
    from repro_torch.core import commplan as commplan_mod
    from repro_torch.core.commplan import compile_schedule, cyclic_map

    def gens(active):
        """Two CPU generators in one state (None when nothing draws)."""
        return (torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)) if active else (None, None)

    # (a) a K = 1 schedule is its static plan, bitwise, on the card: a mix and
    # an int8 round at full width, a spread at d = 3, the wire count; clean
    # and at link_p 0.8 (the draws of one generator state on both sides)
    comp_f = Compression("int8")
    for glabel, g, backend in (("complete-16", T.complete(16), "dense"),
                               ("kreg8-256", T.random_k_regular(256, 8, seed=0), "sparse")):
        w = torch.randn(g.n, D_MAIN, generator=gen, device=dev)
        hres = 0.3 * torch.randn(g.n, D_MAIN, generator=gen, device=dev)
        v = torch.rand(g.n, 3, generator=gen, device=dev)
        for fm in (FailureModel(), FailureModel(link_p=0.8)):
            plan_a = compile_plan(g, backend, failures=fm, device=dev)
            sched_a = compile_schedule([g], backend, failures=fm, device=dev)
            same = {}
            g1, g2 = gens(fm.active)
            same["mix"] = torch.equal(plan_a.mix(w, g1), sched_a.mix(w, 3, g2))
            g1, g2 = gens(fm.active)
            same["spread"] = torch.equal(plan_a.spread(v, g1), sched_a.spread(v, 3, g2))
            g1, g2 = gens(fm.active)
            a_q = plan_a.mix(w, g1, compression=comp_f, residual=hres, layout=mlp_layout)
            b_q = sched_a.mix(w, 3, g2, compression=comp_f, residual=hres, layout=mlp_layout)
            same["int8"] = torch.equal(a_q[0], b_q[0]) and torch.equal(a_q[1], b_q[1])
            g1, g2 = gens(fm.active)
            same["wire"] = int(plan_a.wire_messages(g1)) == int(sched_a.wire_messages(3, g2))
            print(f"  K = 1 schedule vs its plan, {glabel} {backend} link_p {fm.link_p:g}: bitwise {same}")
            check(all(same.values()), f"K = 1 schedule at {glabel} link_p {fm.link_p}: {same}")
            del a_q, b_q
        del w, hres
    torch.cuda.empty_cache()

    # (b) the CLI at full width on a churned kreg4-256 (8 snapshots at churn
    # rate 0.2, one a round), the leaderless warmup of 16 + 16 rounds riding
    # the same schedule, 6 training rounds: finite losses, exactly one
    # mix_bsr launch a training and a gossip round (spread_min, the sketches'
    # transport, is plain torch), each plan's Mᵀ built once; then each
    # plan's mix_bsr at full width and over its Mᵀ at the gossip payloads
    # against the plain version, and timed against the static graph's
    send_builds = []
    real_send = commplan_mod.CommPlan._send.func

    def set_send(fn):
        cp = functools.cached_property(fn)
        cp.__set_name__(commplan_mod.CommPlan, "_send")
        commplan_mod.CommPlan._send = cp

    def counting_send(self):
        send_builds.append(id(self))
        return real_send(self)

    set_send(counting_send)
    cli_argv = ["--model", "mlp", "--topology", "kregular", "--nodes", "256", "--topology-schedule", "churn",
                "--plans", "8", "--churn-rate", "0.2", "--uncoordinated-init", "--leaderless", "--estimate-rounds",
                "16", "--rounds", "6"]
    try:
        hist_f, wall_f, launches_f = counted(lambda: cli.main(cli_argv))
    finally:
        set_send(real_send)
    sched_launches = {"mix_bsr": launches_f["mix_bsr"]}
    print(f"  CLI {' '.join(cli_argv)}: {wall_f:.1f} s incl. data generation; launches "
          f"{ {k: n for k, n in launches_f.items() if n} }; Mᵀ built {len(send_builds)} times for "
          f"{len(set(send_builds))} plans; losses {hist_f['train_loss']} / {hist_f['test_loss']}")
    check(all(math.isfinite(x) for k in ("train_loss", "test_loss") for x in hist_f[k]), "churn CLI: non-finite loss")
    check(launches_f == {**none_launched, "mix_bsr": 32 + 6}, f"churn CLI launches {launches_f}, want 38 mix_bsr")
    check(len(send_builds) == len(set(send_builds)) == 8, f"churn CLI built Mᵀ {len(send_builds)} times")
    base_256 = cli.build_graph("kregular", 256, 0)
    churned = compile_schedule(T.churn_sequence(base_256, 8, 0.2, seed=1), "sparse", device=dev)
    errs["mix_bsr_schedule"] = 0.0
    w = torch.randn(256, D_MAIN, generator=gen, device=dev)
    churn_rows = []
    for i, p_c in enumerate(churned.plans):
        e = compare(f"mix_bsr churned kreg4-256 plan {i} d={D_MAIN}", lambda: mix_bsr(*p_c.bsr, w),
                    mix_bsr_ref(*p_c.bsr, w), w)
        rows_bitwise(f"mix_bsr churned kreg4-256 plan {i}", p_c.bsr, w)
        errs["mix_bsr_schedule"] = max(errs["mix_bsr_schedule"], e)
        mt = p_c.send_operator()
        for d_g in (1, 2):
            wg = torch.rand(256, d_g, generator=gen, device=dev)
            compare(f"mix_bsr churned kreg4-256 plan {i} Mᵀ d={d_g}", lambda: mix_bsr(*mt, wg), mix_bsr_ref(*mt, wg), wg)
        nnz_c = p_c.src.numel() + 256
        bn_c = p_c.bsr.tiles.shape[-1]
        stored = int(p_c.bsr.counts.sum()) * bn_c * bn_c * 4  # the real tiles, not the row blocks' padding
        b_c, op_c = bound(8 * 256 * D_MAIN + 8 * nnz_c, 2 * nnz_c * D_MAIN)
        churn_rows.append(dict(plan=i, ms=time_ms(lambda: mix_bsr(*p_c.bsr, w), flush=flush), bound_ms=b_c,
                               bound_by=op_c, stored_tile_bytes=stored, nonzeros=nnz_c, n_edges=p_c.n_edges))
    # the quantised kernels on every plan: the scales pass and the int8 BSR
    # walk against the plain version (scales and H' bitwise), then one int8
    # round a plan through the schedule (round r runs plan r), counted
    x_q, h_q = quant_inputs(256)
    for i, p_c in enumerate(churned.plans):
        errs["quant_mix_bsr"] = max(errs["quant_mix_bsr"], compare_quant(
            f"quant_mix_bsr int8 round churned kreg4-256 plan {i}", bsr_kernel(p_c.bsr),
            lambda hq, op=p_c.bsr: mix_bsr_ref(*op, hq), x_q, h_q, mlp_bounds, codec="int8", gamma=1.0))
    _, _, launches_q = counted(lambda: [churned.mix(x_q, r, compression=comp_f, residual=h_q, layout=mlp_layout)
                                        for r in range(8)])
    sched_launches.update(quant_scales=launches_q["quant_scales"], quant_mix_bsr=launches_q["quant_mix_bsr"])
    print(f"  8 int8 rounds through the churned schedule (plan r at round r): launches "
          f"{ {k: n for k, n in launches_q.items() if n} }")
    check(launches_q == {**none_launched, "quant_scales": 8, "quant_mix_bsr": 8},
          f"churned schedule int8 launches {launches_q}")
    del x_q, h_q
    last = churned.plans[-1]
    csr_last = torch.as_tensor(receive_matrix(last.graph), dtype=torch.float32, device=dev).to_sparse_csr()
    timing["mix_bsr_schedule"] = dict(
        churn_rows[-1], plain_ms=time_ms(lambda: mix_bsr_ref(*last.bsr, w), reps=3, flush=flush),
        library_ms=time_ms(lambda: torch.sparse.mm(csr_last, w), flush=flush),
        shape=f"churned kreg4-256 plan 7 (churn 0.2 a snapshot), bn 32, d={D_MAIN} fp32")
    for row in churn_rows:
        print(f"  mix_bsr kreg4-256 {'static' if row['plan'] == 0 else 'churned'} plan {row['plan']}: "
              f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{row['bound_ms'] / row['ms']:.1%} of it), {row['n_edges']} edges, stored tiles "
              f"{row['stored_tile_bytes']:,} B")
    del w, csr_last
    torch.cuda.empty_cache()

    # (c) card vs CPU: a K = 4 churned BA-16 schedule (cyclic, period 1) at
    # link_p 0.8, 3 rounds from one numpy init (the same CPU-generator draws
    # on both devices), uncompressed and int8, at phase 5's bounds (int8:
    # quantisation-code flips counted, each within one code step)
    ba16 = T.churn_sequence(T.barabasi_albert(16, 3, seed=0), 4, 0.3, seed=1)
    init_rng_f = np.random.default_rng(7)
    dims_f = [784, 512, 256, 128, 10]
    params_f = {f"fc{i}": {"w": (init_rng_f.standard_normal((16, dims_f[i], dims_f[i + 1]))
                                 * math.sqrt(2.0 / dims_f[i])).astype(np.float32),
                           "b": np.zeros((16, dims_f[i + 1]), np.float32)} for i in range(4)}
    ds_f = mnist_like(16 * 64 + 256, seed=2)
    xs_f, ys_f = node_datasets(ds_f, [np.arange(i * 64, (i + 1) * 64) for i in range(16)])
    sched_f = batch_index_schedule(64, 16, 16, 3 * 2, seed=2)
    sched_launches.update(mix_matmul=0, quant_mix_dense=0)
    # each plan's dense mix and int8 round (3 rounds visit plans 0–2 only):
    # the kernels line's schedule rows take their errors from these and
    # their times from plan 3 (its n = 16 gives phase 3's bounds)
    w = torch.randn(16, D_MAIN, generator=gen, device=dev)
    x_q, h_q = quant_inputs(16)
    errs.update(mix_matmul_schedule=0.0, quant_mix_dense_schedule=0.0)
    for i, p_b in enumerate(compile_schedule(ba16, "dense", device=dev).plans):
        errs["mix_matmul_schedule"] = max(errs["mix_matmul_schedule"], compare(
            f"mix_matmul BA-16 schedule plan {i} d={D_MAIN}", lambda: mix_matmul(p_b.receive, w),
            decavg_mix_ref(p_b.receive, w), w))
        errs["quant_mix_dense_schedule"] = max(errs["quant_mix_dense_schedule"], compare_quant(
            f"quant_mix_dense int8 round BA-16 schedule plan {i}", dense_kernel(p_b.receive),
            lambda hq, m=p_b.receive: decavg_mix_ref(m, hq), x_q, h_q, mlp_bounds, codec="int8",
            gamma=1.0, route="staged"))
    m_b = p_b.receive
    b_mb, op_mb = bound(4 * 16 * 16 + 2 * 4 * 16 * D_MAIN, 2 * 16 * 16 * D_MAIN)
    timing["mix_matmul_schedule"] = dict(
        ms=time_ms(lambda: mix_matmul(m_b, w), flush=flush),
        plain_ms=time_ms(lambda: decavg_mix_ref(m_b, w), flush=flush),
        library_ms=time_ms(lambda: torch.matmul(m_b, w), flush=flush),
        bound_ms=b_mb, bound_by=op_mb, shape=f"churned BA-16 schedule plan 3, n=16 d={D_MAIN} fp32",
        dense_route=dense_route(16, D_MAIN, torch.float32))
    b_qb16, op_qb16 = bound(16 * 16 * D_MAIN + 4 * 16 * 16 + 4 * 16 * n_chunks + table_bytes,
                            2 * 16 * 16 * D_MAIN + 12 * 16 * D_MAIN)
    timing["quant_mix_dense_schedule"] = dict(
        ms=time_ms(lambda: quant_mix_dense(m_b, x_q, h_q, mlp_edges, codec="int8", gamma=1.0), flush=flush,
                   hold=True),
        plain_ms=time_ms(lambda: quant_mix_ref(lambda hq: decavg_mix_ref(m_b, hq), x_q, h_q, mlp_bounds,
                                               quant_scales_ref(x_q, h_q, mlp_bounds, codec="int8"),
                                               codec="int8", gamma=1.0), flush=flush),
        library_ms=None,  # no one PyTorch call quantises and mixes
        bound_ms=b_qb16, bound_by=op_qb16,
        shape=f"churned BA-16 schedule plan 3 int8 round, d={D_MAIN}, fp32, scales included")
    for name in ("mix_matmul_schedule", "quant_mix_dense_schedule"):
        t = timing[name]
        print(f"  {name} at {t['shape']}: {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"plain {t['plain_ms']:.4f} ms" + ("" if t["library_ms"] is None
                                                 else f", torch.matmul {t['library_ms']:.4f} ms"))
    del w, x_q, h_q, m_b
    for comp_c in (None, Compression("int8")):
        results, recorded = {}, {"cuda": [], "cpu": []}
        for d_name in ("cuda", "cpu"):
            def recording_round(*args, _d=d_name, **kw):
                out, scales = quant_mix_dense(*args, **kw)
                recorded[_d].append(scales)
                return out, scales

            mix_ops.quant_mix_dense = recording_round
            plan_f = compile_schedule(ba16, "dense", failures=FailureModel(link_p=0.8), device=d_name)
            st = state_from_numpy(params_f, optimizer=opt, device=d_name)
            rf = make_round_fn(loss_fn, opt, plan_f, compression=comp_c)
            run = lambda: run_trajectory(  # noqa: E731
                st, rf, xs_f, ys_f, sched_f, n_rounds=3, eval_every=1, eval_fn=eval_fn,
                eval_batch=(ds_f.x[-256:], ds_f.y[-256:]), track_sigmas=True, b_local=2, device=d_name)
            if d_name == "cuda":
                (st_out, h), _, launches_c = counted(run)
                kname = "mix_matmul" if comp_c is None else "quant_mix_dense"
                sched_launches[kname] += launches_c[kname]
                check(launches_c == {**none_launched, kname: 3}, f"K = 4 BA-16 schedule launches {launches_c}")
            else:
                st_out, h = run()
            mix_ops.quant_mix_dense = quant_mix_dense
            results[d_name] = (h, st_out)
        (h_gpu, st_gpu), (h_cpu, st_cpu) = results["cuda"], results["cpu"]
        tag = "int8" if comp_c else "uncompressed"
        for key in ("train_loss", "test_loss", "sigma_ap", "sigma_an"):
            a, b = np.asarray(h_gpu[key]), np.asarray(h_cpu[key])
            print(f"  K = 4 BA-16 schedule {tag} {key:10s} max abs diff {float(np.max(np.abs(a - b))):.2e}")
            check(np.allclose(a, b, rtol=1e-4, atol=1e-5), f"card vs CPU, schedule {tag}, {key}")
        check(h_gpu["wire_messages"] == h_cpu["wire_messages"], f"card vs CPU, schedule {tag}: wire counts")
        if comp_c is None:
            perr = float((st_gpu.params.cpu() - st_cpu.params).abs().max())
            print(f"  K = 4 BA-16 schedule final params max abs diff {perr:.2e}; wire {h_gpu['wire_messages']}")
            check(perr < 1e-4, "card vs CPU, schedule final params")
        else:
            widths = chunk_bounds(st_cpu.layout.sizes, comp_c.chunk)
            scales_cpu = torch.stack(recorded["cpu"]).cpu()
            step = scales_cpu.amax(dim=(0, 1))[torch.repeat_interleave(
                torch.arange(widths.numel() - 1), widths[1:] - widths[:-1])].numpy()
            for what in ("params", "residual"):
                got, want = getattr(st_gpu, what).cpu().numpy(), getattr(st_cpu, what).numpy()
                off = np.abs(got - want) > 1e-5 + 1e-4 * np.abs(want)
                within = np.abs(got - want) <= 1.01 * np.broadcast_to(step, want.shape) + 1e-5
                print(f"  K = 4 BA-16 schedule int8 final {what}: {int(off.sum())} of {want.size} elements beyond "
                      f"rtol 1e-4 / atol 1e-5 (code flips), {int((off & ~within).sum())} beyond one code step")
                check(bool(np.all(within[off])) and off.sum() <= 1e-3 * want.size,
                      f"card vs CPU, schedule int8 {what}: code flips")

    # (d) the ppermute (edge-coloured) backend at full width: node-axis
    # gathers, one a colour, plain torch on every device (the JAX package
    # has no kernel for it), against the dense kernel, clean and masked,
    # and timed against it
    pp_rows = {}
    for glabel, g in (("complete-16", T.complete(16)), ("heavytail-64", T.configuration_heavy_tail(64, 2.2, seed=0))):
        pc, pd = compile_plan(g, "ppermute", device=dev), compile_plan(g, "dense", device=dev)
        w = torch.randn(g.n, D_MAIN, generator=gen, device=dev)
        masks = dict(active=torch.as_tensor(rng.random(g.n) < 0.8, device=dev),
                     edge_live=torch.as_tensor(rng.random(pc.n_edges) < 0.7, device=dev))
        for mlabel, kw in (("clean", {}), ("masked", masks)):
            got, again, want = pc.mix(w, **kw), pc.mix(w, **kw), pd.mix(w, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            atol = FP32_TOL * max(float(w.abs().max()), 1.0)
            print(f"  ppermute {glabel} {mlabel} ({pc.n_colors} colours) vs the dense kernel: max_abs_err "
                  f"{err:.3e} tol {atol:.1e}; deterministic {torch.equal(got, again)}")
            check(err <= atol and torch.equal(got, again), f"ppermute {glabel} {mlabel}: {err}")
        pp_rows[glabel] = dict(colours=pc.n_colors, ms=time_ms(lambda: pc.mix(w), flush=flush),
                               mix_matmul_ms=time_ms(lambda: pd.mix(w), flush=flush))
        print(f"  ppermute {glabel} d={D_MAIN}: {pp_rows[glabel]['ms']:.4f} ms against mix_matmul's "
              f"{pp_rows[glabel]['mix_matmul_ms']:.4f} ms ({pp_rows[glabel]['ms'] / pp_rows[glabel]['mix_matmul_ms']:.1f}x)")
        del w, got, again, want
    torch.cuda.empty_cache()

    # (e) the chunk hook: run_dfl_mlp(timing=True) splits its time with
    # ChunkTimer; a chunked run of the BA-16 schedule (link_p 0.8, 6 rounds,
    # chunks of 4) is bitwise the unchunked one
    fig_common.ROWS.clear()
    _, split = fig_common.run_dfl_mlp(n_nodes=16, rounds=40, timing=True, device=dev)
    print(f"  run_dfl_mlp(n_nodes=16, rounds=40, timing=True): {split}")
    check(set(split) == {"sec_per_round", "compile_seconds", "us_per_round_steady"}
          and split["us_per_round_steady"] > 0, f"timing split {split}")
    plan_f = compile_schedule(ba16, "dense", failures=FailureModel(link_p=0.8), device=dev)
    rf = make_round_fn(loss_fn, opt, plan_f)
    sched6 = batch_index_schedule(64, 16, 16, 6 * 2, seed=2)
    kw6 = dict(n_rounds=6, eval_every=1, eval_fn=eval_fn, eval_batch=(ds_f.x[-256:], ds_f.y[-256:]), b_local=2,
               device=dev)
    chunks_seen = []
    st_c, h_c = run_trajectory(state_from_numpy(params_f, optimizer=opt, device=dev), rf, xs_f, ys_f, sched6,
                               chunk_size=4, on_chunk=lambda r0, r1, h: chunks_seen.append((r0, r1, h["round"])), **kw6)
    st_u, h_u = run_trajectory(state_from_numpy(params_f, optimizer=opt, device=dev), rf, xs_f, ys_f, sched6, **kw6)
    print(f"  chunked (4) vs unchunked, 6 rounds: params bitwise {torch.equal(st_c.params, st_u.params)}, history "
          f"equal {h_c == h_u}; the hook's chunks {chunks_seen}")
    check(torch.equal(st_c.params, st_u.params) and h_c == h_u, "a chunked run differs from the unchunked one")
    check([c[:2] for c in chunks_seen] == [(0, 4), (4, 6)], f"on_chunk calls {chunks_seen}")

    # (f) fig 8 quick and the rounds bench quick through the port's drivers
    fig_common.ROWS.clear()
    t0 = time.perf_counter()
    f8 = fig8_churn.run(quick=True, device=dev)
    wall_f8 = time.perf_counter() - t0
    print(f"  fig8 quick: {len(f8['records'])} records in {wall_f8:.1f} s, written to build/fig8_churn.json")
    for rec in f8["records"]:
        print(f"    {json.dumps(rec)}")
    check(len(f8["records"]) == 5 and all(math.isfinite(x) for rec in f8["records"] for x in rec.values()
                                          if isinstance(x, float)), "fig8 quick: a record is missing or not finite")
    t0 = time.perf_counter()
    rb = rounds_bench.run(quick=True, device=dev, rounds=40)
    wall_rb = time.perf_counter() - t0
    print(f"  rounds_bench quick: {len(rb['records'])} records in {wall_rb:.1f} s, written to build/rounds_bench.json "
          f"(40 rounds a trajectory, kreg8 20)")
    for rec in rb["records"]:
        print(f"    {json.dumps(rec)}")
    check(len(rb["records"]) == 4 and all(math.isfinite(x) for rec in rb["records"] for x in rec.values()
                                          if isinstance(x, float)), "rounds_bench quick: a record is missing or not finite")
    print(f"  the kernels line's schedule launches: {sched_launches} (the churn CLI; the BA-16 schedule's card "
          f"runs, uncompressed and int8; the churned schedule's 8 int8 rounds)")
    print(f"  phase 4f: {time.perf_counter() - t_4f:.1f} s")
    torch.cuda.empty_cache()

    # ------------------------------------------------ 4g. event-driven gossip
    phase("4g. event-driven gossip: Poisson edge clocks, pairwise DecAvg, the CLI's --async, fig 9")
    t_4g = time.perf_counter()
    from repro_torch.benchmarks import fig9_async
    from repro_torch.core.commplan import draw_event_flags
    from repro_torch.fed import executor as executor_mod
    from repro_torch.fed import run_event_trajectory

    # (a)–(c) the CLI at full width on kreg4-16 over 20 units of virtual time
    # (8 local batches an endpoint and event, the CLI's default; (c) 2): the
    # executor's call timed by a wrapper that waits for the card (what a
    # caller pays), the stream the CLI samples (seed + 2) drawn here too
    kreg16 = cli.build_graph("kregular", 16, 0)
    stream_cli = T.poisson_event_stream(kreg16, 20.0, 1.0, seed=2)
    n_ev = stream_cli.n_events
    run_walls = []
    real_run_event = cli.run_event_trajectory

    def timed_run_event(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_run_event(*a, **kw)
        torch.cuda.synchronize()
        run_walls.append(time.perf_counter() - t0)
        return out

    runs_4g = {}
    base_4g = ["--model", "mlp", "--topology", "kregular", "--nodes", "16", "--async", "--rounds", "20"]
    cli.run_event_trajectory = timed_run_event
    try:
        for label, extra in (("plain", []), ("int8", ["--compress", "int8"]),
                             ("uncoordinated", ["--uncoordinated-init", "--estimate-rounds", "32", "--link-p", "0.8",
                                                "--local-batches", "2"])):
            hist_g, wall_g, launches_g = counted(lambda: cli.main(base_4g + extra))
            runs_4g[label] = dict(hist=hist_g, wall=wall_g, launches=launches_g, run_s=run_walls[-1],
                                  routes=dict(quant_mix_dense.launches_by_route))
    finally:
        cli.run_event_trajectory = real_run_event
    for label, r in runs_4g.items():
        h = r["hist"]
        live_bins = [i for i, c in enumerate(h["events"]) if c]
        print(f"  CLI {label}: {n_ev} events in {r['run_s']:.2f} s ({r['run_s'] / n_ev * 1e6:.0f} µs an event as the "
              f"caller pays, the card finished; {r['wall']:.1f} s with data and init); messages {sum(h['messages'])}; "
              f"launches { {k: n for k, n in r['launches'].items() if n} }; final train {h['train_loss'][-1]:.4f} "
              f"test {h['test_loss'][-1]:.4f}")
        check(sum(h["events"]) == n_ev and h["bin"] == list(range(20)), f"CLI {label}: {sum(h['events'])} events")
        check(all(math.isfinite(h[k][i]) for k in ("train_loss", "test_loss", "staleness") for i in live_bins),
              f"CLI {label}: a non-finite loss")
    check(sum(runs_4g["plain"]["hist"]["messages"]) == 2 * n_ev and runs_4g["plain"]["launches"] == none_launched,
          f"CLI plain: messages / launches {runs_4g['plain']['launches']}")
    check(runs_4g["int8"]["launches"] == {**none_launched, "quant_mix_dense": n_ev}
          and runs_4g["int8"]["routes"] == {"staged": n_ev, "wide": 0},
          f"CLI int8: launches {runs_4g['int8']['launches']} routes {runs_4g['int8']['routes']}, want {n_ev} staged")
    t_plain, t_int8 = runs_4g["plain"]["hist"]["test_loss"][-1], runs_4g["int8"]["hist"]["test_loss"][-1]
    check(abs(t_int8 - t_plain) <= 0.02 * abs(t_plain), f"CLI int8 final test loss {t_int8} vs {t_plain}")
    msgs_u = sum(runs_4g["uncoordinated"]["hist"]["messages"])
    check(0 < msgs_u < 2 * n_ev and runs_4g["uncoordinated"]["launches"] == none_launched,
          f"CLI uncoordinated (link_p 0.8): {msgs_u} messages, launches {runs_4g['uncoordinated']['launches']}")
    event_launches = runs_4g["int8"]["launches"]["quant_mix_dense"]

    # one event step of the CLI's run (kreg4-16, full width, 8 local
    # batches an endpoint), eager against one step captured as a CUDA graph
    # and replayed: the device's time for the step with no host dispatch;
    # the device operations of one eager step from torch.profiler
    st_s = state_from_numpy(params_f, optimizer=opt, device=dev)
    plan_s = compile_plan(kreg16, "dense", device=dev)
    sched_s = torch.as_tensor(executor_mod._as_round_schedule(batch_index_schedule(64, 16, 16, 32, seed=0), 4, 8),
                              dtype=torch.int64, device=dev)
    xs_s, ys_s = torch.as_tensor(xs_f, device=dev), torch.as_tensor(ys_f, device=dev)
    split_rows = {}
    for label, comp_s in (("uncompressed", None), ("int8", Compression("int8"))):
        mirror_s = torch.zeros_like(st_s.params) if comp_s is not None else None
        step_s = executor_mod._make_event_step(loss_fn, opt, plan_s, sched_s, 4, xs_s, ys_s, layout=st_s.layout,
                                               reinit_opt=True, comp=comp_s)
        counts_s, clocks_s = np.zeros(16, np.int32), np.zeros(16, np.float32)

        def one_step():
            return step_s(st_s.params, st_s.opt_state, mirror_s, counts_s, clocks_s, 5, np.float32(1.0), True)

        for _ in range(3):
            one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            one_step()
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / 20 * 1e3
        _, prof_s, _ = traced(one_step)
        dev_ops = [e for e in prof_s.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in dev_ops) / 1e3 if dev_ops else None
        # the host side of the same trace: self CPU time by kind of operator
        # (tools/event_step_profile.py breaks it down further)
        host_by = {"launch calls": 0.0, "cuBLAS calls (aten::bmm)": 0.0, "autograd engine": 0.0,
                   "views and slices": 0.0, "other operators": 0.0}
        for e in prof_s.key_averages():
            kind = ("launch calls" if e.key.startswith(("cudaLaunch", "cuLaunch")) else
                    "cuBLAS calls (aten::bmm)" if e.key == "aten::bmm" else
                    "autograd engine" if e.key.startswith("autograd::") or e.key.endswith("Backward0") else
                    "views and slices" if e.key in ("aten::view", "aten::slice", "aten::slice_backward",
                                                     "aten::reshape", "aten::as_strided", "aten::expand",
                                                     "aten::unsqueeze", "aten::_unsafe_view", "aten::select",
                                                     "aten::squeeze", "aten::t", "aten::transpose") else
                    "other operators")
            host_by[kind] += e.self_cpu_time_total / 1e3
        print(f"  {label} event step, host self time under the profiler: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in host_by.items()))
        graph_ms = None
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(3):
                    one_step()
            torch.cuda.current_stream().wait_stream(side)
            g_step = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g_step):
                one_step()
            graph_ms = time_ms(g_step.replay)
            del g_step
        except RuntimeError as exc:  # a measurement, not a check: reported as not measured
            print(f"  {label} event step: CUDA graph capture failed ({str(exc)[:200]}): device time not measured")
        split_rows[label] = dict(eager_ms=eager_ms, graph_ms=graph_ms, device_ops=len(dev_ops), busy_ms=busy_ms)
        print(f"  one {label} event step (kreg4-16, full width, 8 local batches an endpoint): {eager_ms:.3f} ms "
              f"eager; " + ("graph replay not measured" if graph_ms is None else
                           f"{graph_ms:.3f} ms replayed as a CUDA graph (the device busy {graph_ms / eager_ms:.1%} "
                           f"of an eager step, the host {1 - graph_ms / eager_ms:.1%})")
              + f"; {len(dev_ops)} device operations in one eager step (profiler)"
              + ("" if busy_ms is None else f", {busy_ms:.3f} ms of device time summed"))
        check(all(math.isfinite(float(x)) for x in (eager_ms,)), f"{label} event step timing")
    del st_s, xs_s, ys_s, mirror_s
    torch.cuda.empty_cache()

    # (d) the barrier-free engine at kreg4-1024 (sparse, link_p 0.9, 8 units
    # of virtual time): push-sum and the leaderless sketches, card against
    # CPU on the same host-drawn flags
    k1024 = T.random_k_regular(1024, 4, seed=0)
    stream_1k = T.poisson_event_stream(k1024, 8.0, 1.0, seed=5)
    vals_1k = np.random.default_rng(3).normal(size=(1024, 2)).astype(np.float32)
    eng = {}
    for d_name in ("cuda", "cpu"):
        plan_k = compile_plan(k1024, "sparse", failures=FailureModel(link_p=0.9), device=d_name)
        (ps, (n_hat, mins)), wall_k, launches_k = counted(lambda: (
            G.push_sum_events(plan_k, vals_1k, stream_1k, seed=11),
            G.estimate_size_leaderless_events(plan_k, stream_1k, 11, return_sketches=True)))
        eng[d_name] = (ps.cpu(), n_hat.cpu(), mins.cpu(), wall_k)
        if d_name == "cuda":
            check(launches_k == none_launched, f"engine events launched {launches_k}")
    (ps_g, nh_g, mn_g, wall_g), (ps_c, nh_c, mn_c, wall_c) = eng["cuda"], eng["cpu"]
    ps_err = float((ps_g - ps_c).abs().max())
    print(f"  kreg4-1024, {stream_1k.n_events} events, link_p 0.9: push_sum_events + estimate_size_leaderless_events "
          f"{wall_g:.2f} s on the card ({wall_g / (2 * stream_1k.n_events) * 1e6:.0f} µs an event), {wall_c:.2f} s on "
          f"the CPU; push-sum card vs CPU max abs diff {ps_err:.2e} (bitwise {torch.equal(ps_g, ps_c)}), the "
          f"average's spread {float(ps_g.std(0).max()):.3e}; sketch minima bitwise {torch.equal(mn_g, mn_c)}; n̂ "
          f"median {float(nh_g.median()):.1f} (n = 1024), card vs CPU max rel diff "
          f"{float(((nh_g - nh_c).abs() / nh_c).max()):.2e}")
    check(torch.equal(mn_g, mn_c) and torch.allclose(nh_g, nh_c, rtol=1e-5, atol=0)
          and torch.allclose(ps_g, ps_c, rtol=1e-5, atol=1e-6), "engine events: card vs CPU")
    check(bool(torch.isfinite(ps_g).all()) and bool(torch.isfinite(nh_g).all()), "engine events: non-finite")

    # (e) card vs CPU: a BA-16 event trajectory at link_p 0.8 with int8
    # exchanges (phase 4f's full-width init and data, 2 units of virtual
    # time, 2 local batches), the same host-drawn flags on both devices:
    # integer channels, clocks and staleness equal, losses to rtol 1e-4,
    # quantisation-code flips counted and each held to one code step
    t_e = time.perf_counter()
    ba16_e = T.barabasi_albert(16, 3, seed=0)
    stream_e = T.poisson_event_stream(ba16_e, 2.0, 1.0, seed=4)
    sched_e = batch_index_schedule(64, 16, 16, 2 * 2, seed=2)
    res_e, scales_e = {}, {"cuda": [], "cpu": []}
    for d_name in ("cuda", "cpu"):
        def recording_pair(*a, _d=d_name, **kw):
            out, sc = quant_mix_pair(*a, **kw)
            scales_e[_d].append(sc)
            return out, sc

        executor_mod.quant_mix_pair = recording_pair
        try:
            st_e = state_from_numpy(params_f, optimizer=opt, device=d_name)
            plan_e = compile_plan(ba16_e, "dense", failures=FailureModel(link_p=0.8), device=d_name)

            def run_e():
                return run_event_trajectory(st_e, loss_fn, opt, plan_e, stream_e, xs_f, ys_f, sched_e, b_local=2,
                                            n_bins=4, eval_fn=eval_fn, eval_batch=(ds_f.x[-256:], ds_f.y[-256:]),
                                            compression=Compression("int8"), device=d_name)

            if d_name == "cuda":
                res_e[d_name], wall_e, launches_e = counted(run_e)
            else:
                res_e[d_name] = run_e()
        finally:
            executor_mod.quant_mix_pair = quant_mix_pair
    (fin_g, h_g, aux_g), (fin_c, h_c, aux_c) = res_e["cuda"], res_e["cpu"]
    delivered_e = sum(h_g["messages"]) // 2
    check(launches_e == {**none_launched, "quant_mix_dense": delivered_e} and len(scales_e["cpu"]) == delivered_e,
          f"BA-16 int8 events: launches {launches_e}, {delivered_e} delivered")
    for key in ("events", "messages", "wire_bytes", "staleness"):
        check(h_g[key] == h_c[key], f"BA-16 events card vs CPU: {key} {h_g[key]} vs {h_c[key]}")
    check(np.array_equal(aux_g["node_clock"], aux_c["node_clock"]) and np.array_equal(aux_g["node_events"],
                                                                                      aux_c["node_events"]),
          "BA-16 events card vs CPU: clocks")
    for key in ("train_loss", "test_loss"):
        a, b = np.asarray(h_g[key]), np.asarray(h_c[key])
        print(f"  BA-16 int8 events {key:10s} card vs CPU max abs diff {float(np.max(np.abs(a - b))):.2e}")
        check(np.allclose(a, b, rtol=1e-4, atol=1e-5), f"BA-16 events card vs CPU, {key}")
    widths_e = chunk_bounds(fin_c.layout.sizes, 2048)
    step_e = torch.stack(scales_e["cpu"]).amax(dim=(0, 1))[torch.repeat_interleave(
        torch.arange(widths_e.numel() - 1), widths_e[1:] - widths_e[:-1])].numpy()
    for what in ("params", "residual"):
        got, want = getattr(fin_g, what).cpu().numpy(), getattr(fin_c, what).numpy()
        off = np.abs(got - want) > 1e-5 + 1e-4 * np.abs(want)
        within = np.abs(got - want) <= 1.01 * np.broadcast_to(step_e, want.shape) + 1e-5
        print(f"  BA-16 int8 events ({stream_e.n_events} events, {delivered_e} delivered; card {wall_e:.1f} s, "
              f"both {time.perf_counter() - t_e:.1f} s) final {what}: "
              f"{int(off.sum())} of {want.size} elements beyond rtol 1e-4 / atol 1e-5 (code flips), "
              f"{int((off & ~within).sum())} beyond one code step")
        check(bool(np.all(within[off])) and off.sum() <= 2e-2 * want.size, f"BA-16 events card vs CPU: {what} flips")
    del fin_g, fin_c, res_e

    # (f) a colour step on the card: event_mix_batch over the batches of a
    # kreg4-16 stream (link_p 0.8) bitwise the sequential event_mix calls,
    # and the sequential calls bitwise the CPU's
    plan_b = compile_plan(kreg16, "dense", failures=FailureModel(link_p=0.8), device=dev)
    plan_bc = compile_plan(kreg16, "dense", failures=FailureModel(link_p=0.8), device="cpu")
    stream_b = T.poisson_event_stream(kreg16, 2.0, 1.0, seed=6)
    flags_b = draw_event_flags(plan_b.failures, 3, stream_b.envelope)
    batches_b = T.batch_events_by_color(stream_b, kreg16)
    w_b = torch.randn(16, D_MAIN, generator=gen, device=dev)
    seq_b, seq_c, bat_b = w_b, w_b.cpu(), w_b
    for i in range(stream_b.n_events):
        seq_b = plan_b.event_mix(seq_b, int(stream_b.edges[i]), bool(flags_b[i]))
        seq_c = plan_bc.event_mix(seq_c, int(stream_b.edges[i]), bool(flags_b[i]))
    for b in range(batches_b.n_batches):
        idx = batches_b.event_index[b]
        bat_b = plan_b.event_mix_batch(bat_b, batches_b.edges[b], flags_b[np.maximum(idx, 0)] & (idx >= 0))
    same_b, same_c = torch.equal(seq_b, bat_b), torch.equal(seq_b.cpu(), seq_c)
    print(f"  event_mix_batch over {batches_b.n_batches} colour steps ({stream_b.n_events} events, width "
          f"{batches_b.width}) bitwise the sequential event_mix {same_b}; the card's sequence bitwise the CPU's {same_c}")
    check(same_b and same_c, "event_mix_batch on the card")
    del w_b, seq_b, seq_c, bat_b

    # (g) fig 9 quick through the port's fig9_async (build/fig9_async.json):
    # on clean links every event delivers, so the executor's wire bytes
    # (its delivered messages, summed over the bins) are the stream's
    # 2 · n_events messages at the synchronous run's bytes a message.  The
    # ring family alone (2 of its 6 records): the script's time limit
    fig_common.ROWS.clear()
    t0 = time.perf_counter()
    families_f9 = fig9_async.FAMILIES
    fig9_async.FAMILIES = {"ring": families_f9["ring"]}
    try:
        f9 = fig9_async.run(quick=True, device=dev)
    finally:
        fig9_async.FAMILIES = families_f9
    wall_f9 = time.perf_counter() - t0
    print(f"  fig9 quick, ring family: {len(f9['records'])} records in {wall_f9:.1f} s, written to build/fig9_async.json")
    for rec in f9["records"]:
        print(f"    {json.dumps(rec)}")
    check(len(f9["records"]) == 2 and all(
        rec["wire_bytes_event_total"] * 2 * rec["n_edges"] == rec["messages_event"] * rec["wire_bytes_per_round_sync"]
        for rec in f9["records"])
          and all(math.isfinite(x) for rec in f9["records"] for x in rec.values() if isinstance(x, float)),
          "fig9 quick: a record is missing, miscounted or not finite")
    print(f"  phase 4g: {time.perf_counter() - t_4g:.1f} s")
    torch.cuda.empty_cache()

    # ---------------------------------------------- 4h. live serving
    phase("4h. live serving under gossip: the serve CLI, bitwise training under load, fig 13, the consensus example")
    t_4h = time.perf_counter()
    from repro_torch.benchmarks import fig13_serve
    from repro_torch.examples import serve_consensus
    from repro_torch.fed import make_router, poisson_query_stream, run_serve_trajectory, serve_summary
    from repro_torch.launch import serve as serve_cli

    # (a) the serve CLI at its defaults (ring-16, the full-width MLP, 30
    # units of virtual time, qps 4, consensus router), after a warm-up run
    # at qps 0; then three pairs of runs at qps 0 and qps 64 (~1,900
    # queries), in turns.  Each executor call is timed by a wrapper that
    # waits for the card before and after it (what a caller pays), and the
    # host time inside its gossip events (``_EventRun.gossip``, no sync
    # inside) is summed within the same call.  µs an event: a qps-0 call
    # over its events.  µs a query, inside each call: the call's time
    # outside its gossip events at qps 64 less that at qps 0 (set-up, the
    # merge, the last sync), over the queries; beside it the difference of
    # the two calls' walls, which carries the gossip steps' spread
    from repro_torch.fed import executor as fed_executor

    stream_h = T.poisson_event_stream(serve_cli.build_graph("ring", 16, 0), 30.0, 1.0, seed=1)
    calls_h = []  # (wall, host seconds inside gossip events) a call
    real_serve, real_gossip = serve_cli.run_serve_trajectory, fed_executor._EventRun.gossip
    gossip_s = [0.0]

    def timed_gossip(self, i):
        t0 = time.perf_counter()
        real_gossip(self, i)
        gossip_s[0] += time.perf_counter() - t0

    def timed_serve(*a, **kw):
        torch.cuda.synchronize()
        gossip_s[0] = 0.0
        t0 = time.perf_counter()
        out = real_serve(*a, **kw)
        torch.cuda.synchronize()
        calls_h.append((time.perf_counter() - t0, gossip_s[0]))
        return out

    serve_cli.run_serve_trajectory, fed_executor._EventRun.gossip = timed_serve, timed_gossip
    try:
        _, _, launches_w = counted(lambda: serve_cli.main(["--qps", "0"]))
        (hist_h, summ_h), wall_cli, launches_h = counted(lambda: serve_cli.main([]))
        pairs_h, launches_pairs = [], []
        for _ in range(3):
            (hist_0, _), _, launches_0 = counted(lambda: serve_cli.main(["--qps", "0"]))
            (_, summ_64), _, launches_64 = counted(lambda: serve_cli.main(["--qps", "64"]))
            pairs_h.append((calls_h[-2], calls_h[-1], summ_64["served"]))
            launches_pairs += [launches_0, launches_64]
    finally:
        serve_cli.run_serve_trajectory, fed_executor._EventRun.gossip = real_serve, real_gossip
    us_event = [w0 / stream_h.n_events * 1e6 for (w0, _), _, _ in pairs_h]
    us_gossip = [g0 / stream_h.n_events * 1e6 for (_, g0), _, _ in pairs_h]
    us_query = [((w64 - g64) - (w0 - g0)) / max(nq, 1) * 1e6 for (w0, g0), (w64, g64), nq in pairs_h]
    us_query_walls = [(w64 - w0) / max(nq, 1) * 1e6 for (w0, _), (w64, _), nq in pairs_h]
    print(f"  serve CLI (defaults): {stream_h.n_events} events, {summ_h['served']} queries served in "
          f"{calls_h[1][0]:.2f} s ({wall_cli:.1f} s with data and init); p50 latency {summ_h['p50_latency']:.4f}, p95 "
          f"{summ_h['p95_latency']:.4f}, mean staleness {summ_h['mean_staleness']:.4f}, mean hops "
          f"{summ_h['mean_hops']:.3f}; final train {summ_h['train_loss_final']:.4f} test "
          f"{summ_h['test_loss_final']:.4f}")
    print(f"  as a caller pays (host clock after a sync), three qps-0 / qps-64 pairs in turns: µs an event "
          f"{[round(v) for v in us_event]} (of it inside the gossip step {[round(v) for v in us_gossip]}); "
          f"µs a query inside each qps-64 call {[round(v) for v in us_query]} over "
          f"{[nq for _, _, nq in pairs_h]} queries (median {sorted(us_query)[1]:.0f}); from the two calls' walls "
          f"{[round(v) for v in us_query_walls]}; walls (qps 0, qps 64) "
          f"{[(round(w0, 3), round(w64, 3)) for (w0, _), (w64, _), _ in pairs_h]} s")
    check(all(n == none_launched for n in [launches_w, launches_h, *launches_pairs]),
          f"serve CLI launched {[launches_w, launches_h, *launches_pairs]}: the live path runs no kernel")
    check(summ_h["served"] == sum(hist_h["queries"]) > 0 and sum(hist_h["events"]) == stream_h.n_events,
          f"serve CLI: {summ_h['served']} served, {sum(hist_h['events'])} events")
    check(all(math.isfinite(summ_h[k]) for k in ("p50_latency", "p95_latency", "mean_staleness", "train_loss_final",
                                                  "test_loss_final")), "serve CLI: a non-finite summary")
    check(hist_0["train_loss"] == hist_h["train_loss"] and hist_0["test_loss"] == hist_h["test_loss"],
          "serve CLI: training differs between qps 0 and qps 4")

    # (b) on the card, ring-16 at full width, link_p 0.8, 6 units of virtual
    # time: qps 0 is run_event_trajectory bit for bit, and qps 5 (consensus
    # router with a budget, answers) changes no bit of training
    from repro_torch.fed import run_event_trajectory

    ring16 = T.ring(16)
    gain16 = gain_from_graph(ring16)
    init_h = init_fl_state(7, 16, lambda g, gains: init_mlp(InitConfig("he_normal", gains), g), sgd(1e-3, 0.5),
                           gains=gain16, device=dev)
    ds_h = mnist_like(16 * 64 + 256, seed=0)
    xs_h, ys_h = node_datasets(ds_h, [np.arange(i * 64, (i + 1) * 64) for i in range(16)])
    test_h = (ds_h.x[-256:], ds_h.y[-256:])

    def loss_h(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    def answer_h(p, x):
        return torch.argmax(mlp_forward(p, x[None]), dim=-1)[0]

    plan_h = compile_plan(ring16, failures=FailureModel(link_p=0.8), device=dev)
    stream_b = T.poisson_event_stream(ring16, 6.0, 1.0, seed=1)
    sched_h = batch_index_schedule(64, 16, 16, 12, seed=0)
    common_h = dict(b_local=2, n_bins=6, eval_fn=make_eval_fn(loss_h), eval_batch=test_h, device=dev)
    router_h = make_router(ring16, "consensus", staleness_budget=1.0)
    ev_h = run_event_trajectory(init_h, loss_h, sgd(1e-3, 0.5), plan_h, stream_b, xs_h, ys_h, sched_h, **common_h)
    srv_h = {}
    for qps in (0.0, 5.0):
        srv_h[qps] = run_serve_trajectory(init_h, loss_h, sgd(1e-3, 0.5), plan_h, stream_b,
                                          poisson_query_stream(16, 6.0, qps, seed=3, pool=256), router_h, xs_h,
                                          ys_h, sched_h, serve_fn=answer_h, query_xs=test_h[0], **common_h)

    def same_training(a, b):
        return (torch.equal(a[0].params, b[0].params) and all(torch.equal(x, y) for x, y in
                                                              zip(a[0].opt_state, b[0].opt_state))
                and all(json.dumps(a[1][k]) == json.dumps(b[1][k]) for k in ev_h[1])
                and np.array_equal(a[-1]["node_clock"], b[-1]["node_clock"]))

    same0, same5 = same_training(ev_h, srv_h[0.0]), same_training(srv_h[0.0], srv_h[5.0])
    served5 = serve_summary(srv_h[5.0][2])["served"]
    print(f"  ring-16 full width, link_p 0.8, {stream_b.n_events} events: qps 0 bitwise run_event_trajectory "
          f"{same0}; qps 5 ({served5} queries answered) bitwise qps 0's training {same5}")
    check(same0 and same5 and served5 > 0, "serving changed training on the card")
    del ev_h, srv_h, init_h

    # (c) card vs CPU at a small size: ring-6, the full-width MLP from one
    # CPU init, link_p 0.8, 8 units of virtual time, qps 5, consensus router
    # with a budget: routing arrays and answers equal, the integer channels,
    # clocks and busy times equal, losses to rtol 1e-4 (the trainer's bound)
    ring6 = T.ring(6)
    init_c = init_fl_state(5, 6, lambda g, gains: init_mlp(InitConfig("he_normal", gains), g), sgd(1e-3, 0.5),
                           gains=gain_from_graph(ring6), device="cpu")
    np_params = to_numpy(init_c)[0]
    stream_c = T.poisson_event_stream(ring6, 8.0, 1.0, seed=1)
    queries_c = poisson_query_stream(6, 8.0, 5.0, seed=3, pool=256)
    runs_c = {}
    for d_name in ("cuda", "cpu"):
        opt_c = sgd(1e-3, 0.5)
        runs_c[d_name] = run_serve_trajectory(
            state_from_numpy(np_params, optimizer=opt_c, device=d_name), loss_h, opt_c,
            compile_plan(ring6, "dense", failures=FailureModel(link_p=0.8), device=d_name), stream_c, queries_c,
            make_router(ring6, "consensus", staleness_budget=0.5), xs_h[:6], ys_h[:6],
            batch_index_schedule(64, 6, 16, 16, seed=0), b_local=2, n_bins=4, eval_fn=make_eval_fn(loss_h),
            eval_batch=test_h, serve_fn=answer_h, query_xs=test_h[0], device=d_name)
    (_, hc_g, sc_g, ac_g), (_, hc_c, sc_c, ac_c) = runs_c["cuda"], runs_c["cpu"]
    routing_same = all(np.array_equal(sc_g[k], sc_c[k]) for k in ("node", "latency", "staleness", "hops"))
    answers_same = np.array_equal(sc_g["answer"], sc_c["answer"])
    ints_same = all(hc_g[k] == hc_c[k] for k in ("events", "messages", "staleness", "queries", "serve_latency",
                                                   "serve_staleness"))
    clocks_same = all(np.array_equal(ac_g[k], ac_c[k]) for k in ("node_clock", "node_events", "node_busy"))
    loss_diff = {k: float(np.max(np.abs(np.asarray(hc_g[k]) - np.asarray(hc_c[k])))) for k in ("train_loss",
                                                                                                 "test_loss")}
    print(f"  ring-6 card vs CPU ({stream_c.n_events} events, {sc_g['node'].size} queries): routing arrays equal "
          f"{routing_same}, answers equal {answers_same}, channels / clocks equal {ints_same} / {clocks_same}; "
          f"loss max abs diff {loss_diff}")
    check(routing_same and answers_same and ints_same and clocks_same, "serving card vs CPU: routing differs")
    check(all(np.allclose(hc_g[k], hc_c[k], rtol=1e-4, atol=1e-5) for k in ("train_loss", "test_loss")),
          "serving card vs CPU: losses")

    # (d) fig 13 quick through the port's fig13_serve (build/fig13_serve.json),
    # its acceptance assertion (consensus beats uniform on served staleness
    # at ≤ 1.05× p50 latency on some family) inside run(); its ring family
    # alone (6 of its 12 records): the script's time limit
    fig_common.ROWS.clear()
    families_f13 = fig13_serve.FAMILIES
    fig13_serve.FAMILIES = {"ring": families_f13["ring"]}
    try:
        (f13, wall_f13, launches_f13) = counted(lambda: fig13_serve.run(quick=True, device=dev))
    finally:
        fig13_serve.FAMILIES = families_f13
    print(f"  fig13 quick, ring family: {len(f13['records'])} records in {wall_f13:.1f} s, consensus wins on "
          f"{f13['consensus_wins']}, written to build/fig13_serve.json")
    for rec in f13["records"]:
        print(f"    {json.dumps(rec)}")
    check(len(f13["records"]) == 6 and launches_f13 == none_launched
          and all(math.isfinite(x) for rec in f13["records"] for x in rec.values() if isinstance(x, float)),
          f"fig13 quick: records missing or not finite, or launches {launches_f13}")

    # (e) the consensus example as a user runs it (30 AdamW DecAvg rounds of
    # the reduced qwen2.5-3b on kreg4-8, consensus and routed serving): one
    # mix_matmul launch a round at (8, d), one flash launch a prefill layer
    # (fp32: the wgmma_tf32x3 route); every flash key among phase 3's.  Then
    # 3 rounds card vs CPU from the same CPU init: greedy tokens equal
    lm_keys = set()

    def recording_flash_h(q, k, v, *, causal=True, window=0):
        lm_keys.add(flash_key(q, k, causal, window))
        return flash_mha(q, k, v, causal=causal, window=window)

    red_q = get_reduced_config("qwen2.5-3b")
    flash_ops.flash_mha = recording_flash_h
    try:
        ex_h, wall_ex, lm_launches = counted(lambda: serve_consensus.run(device=dev))
        lm_routes = dict(flash_mha.launches_by_route)
    finally:
        flash_ops.flash_mha = flash_mha
    n_prefill = 1 + len(ex_h["assignments"])
    want_lm = {**none_launched, "mix_matmul": serve_consensus.ROUNDS, "flash_mha": n_prefill * red_q.n_layers}
    losses_ex = ex_h["hist"]["train_loss"]
    print(f"  consensus example: {serve_consensus.ROUNDS} rounds (d = {ex_h['state'].layout.size:,} a node) and "
          f"serving in {wall_ex:.1f} s; train loss {losses_ex[0]:.4f} → {losses_ex[-1]:.4f}; launches "
          f"{ {k: n for k, n in lm_launches.items() if n} } (flash by route {lm_routes}); flash keys "
          f"{sorted(lm_keys, key=str)}")
    check(lm_launches == want_lm and lm_routes == {"wgmma": 0, "wgmma_tf32x3": want_lm["flash_mha"]},
          f"consensus example: launches {lm_launches} routes {lm_routes}, want {want_lm}")
    check(lm_keys <= flash_checked, f"consensus example launched flash at {sorted(lm_keys - flash_checked, key=str)}, "
          "not checked in phase 3")
    check(ex_h["state"].layout.size == D_LM and all(math.isfinite(v) for v in losses_ex)
          and losses_ex[-1] < losses_ex[0], f"consensus example: d {ex_h['state'].layout.size}, losses {losses_ex}")
    toks_ex = {}
    for d_name in ("cuda", "cpu"):
        q_ex = serve_consensus.setup(d_name)
        st_ex, hist_ex = serve_consensus.train(q_ex, 3)
        toks_ex[d_name] = (serve_consensus.serve(q_ex, st_ex), hist_ex, st_ex.params.cpu())
    (got_g, hist_g, p_g), (got_c, hist_c, p_c) = toks_ex["cuda"], toks_ex["cpu"]
    same_toks = (np.array_equal(got_g["consensus"], got_c["consensus"])
                 and np.array_equal(got_g["nodes"], got_c["nodes"]))
    p_diff = float((p_g - p_c).abs().max())
    print(f"  consensus example, 3 rounds card vs CPU: greedy tokens equal {same_toks} (consensus and the 4 routed "
          f"queries, {serve_consensus.N_NEW} new each); train losses {hist_g['train_loss']} vs {hist_c['train_loss']}; "
          f"params max abs diff {p_diff:.2e}")
    check(same_toks, "consensus example: greedy tokens differ between the card and the CPU after 3 rounds")
    check(np.allclose(hist_g["train_loss"], hist_c["train_loss"], rtol=1e-4), "consensus example: losses differ")

    # (f) one decoder training step on the card: the loss and its gradient
    # (reduced qwen2.5-3b, fp32, 2 × 48 tokens) against the CPU, no flash
    # launch under grad; a grad-recording kernel call raises
    base_f = TF.init_params(0, red_q, InitConfig("trunc_normal"), device="cpu")
    rng_f = np.random.default_rng(0)
    x_f = torch.as_tensor(rng_f.integers(0, red_q.vocab_size, (2, 48)).astype(np.int32))
    y_f = torch.as_tensor(rng_f.integers(0, red_q.vocab_size, (2, 48)).astype(np.int32))
    grads_f = {}
    for d_name in ("cuda", "cpu"):
        p_f = tree_map(lambda t: t.detach().to(d_name, copy=True).requires_grad_(True), base_f)
        reset_counts()
        hidden_f, _ = TF.forward(p_f, red_q, x_f.to(d_name))
        loss_f = TF.lm_loss(p_f, red_q, hidden_f, y_f.to(d_name))
        loss_f.backward()
        leaves_f = []
        tree_map(leaves_f.append, p_f)
        grads_f[d_name] = (float(loss_f.detach()), [t.grad.cpu() for t in leaves_f], flash_mha.launches)
    (l_g, g_g, fl_g), (l_c, g_c, _) = grads_f["cuda"], grads_f["cpu"]
    g_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(g_g, g_c))
    q_r = torch.randn(1, 4, 40, 32, device=dev, requires_grad=True)
    kv_r = torch.randn(1, 2, 40, 32, device=dev)
    raised = []
    for name_r, call in (("flash_mha", lambda: flash_mha(q_r, kv_r, kv_r)),
                         ("rwkv6_chunked", lambda: rwkv6_chunked(*(torch.randn(1, 40, 2, 32, device=dev),) * 3,
                                                                  torch.full((1, 40, 2, 32), 0.9, device=dev),
                                                                  torch.randn(2, 32, device=dev, requires_grad=True)))):
        try:
            call()
        except RuntimeError as exc:
            raised.append(name_r if "no backward" in str(exc) else f"{name_r}: {exc}")
    print(f"  one decoder training step (reduced qwen2.5-3b, 2 × 48): loss card {l_g:.6f} CPU {l_c:.6f}, gradient "
          f"max diff {g_rel:.2e} of the largest element, flash launches under grad {fl_g}; grad-recording kernel "
          f"calls raised: {raised}")
    check(fl_g == 0 and abs(l_g - l_c) <= 1e-5 * abs(l_c) and g_rel <= 1e-4, "decoder training step card vs CPU")
    check(raised == ["flash_mha", "rwkv6_chunked"], f"grad-recording kernel calls: {raised}")
    print(f"  phase 4h: {time.perf_counter() - t_4h:.1f} s")
    torch.cuda.empty_cache()

    # ------------------------------ 4i. elastic membership and checkpoints
    phase("4i. elastic membership, fault injection and preemption-safe checkpoints: --elastic, SIGKILL and "
          "resume, fig 11")
    t_4i = time.perf_counter()
    import signal
    import shutil

    from repro_torch.benchmarks import fig11_elastic
    from repro_torch.checkpoint import restore_train_state
    from repro_torch.core.faults import crash_burst, scenario
    from repro_torch.core.membership import membership_schedule
    from repro_torch.fed import CheckpointPolicy, run_elastic_trajectory
    from repro_torch.fed import executor as elastic_executor

    # (a), (b) the CLI at its defaults (complete-16, the full-width MLP, 100
    # rounds of 8 local batches): 4 of the 16 slots arrive at round 50 and
    # initialise at 58 from their own sketches, a crash burst takes 2 nodes
    # down over rounds 33-42; then the same with int8 exchanges.  The
    # executor's call is timed by a wrapper that waits for the card before
    # and after it (what a caller pays)
    real_elastic = cli.run_elastic_trajectory
    elastic_walls, elastic_aux = [], []

    def timed_elastic(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_elastic(*a, **kw)
        torch.cuda.synchronize()
        elastic_walls.append(time.perf_counter() - t0)
        elastic_aux.append(out[2])
        return out

    runs_4i = {}
    base_4i = ["--model", "mlp", "--elastic", "--join-nodes", "4", "--fault-scenario", "crash"]
    cli.run_elastic_trajectory = timed_elastic
    try:
        for label, extra in (("plain", []), ("int8", ["--compress", "int8"])):
            hist_i, wall_i, launches_i = counted(lambda: cli.main(base_4i + extra))
            runs_4i[label] = dict(hist=hist_i, wall=wall_i, launches=launches_i, run_s=elastic_walls[-1],
                                  n_hat=elastic_aux[-1]["n_hat"], routes=dict(quant_mix_dense.launches_by_route))
    finally:
        cli.run_elastic_trajectory = real_elastic
    # the masks the CLI lowers at its defaults (100 rounds, seed 0)
    mem_cli = membership_schedule(16, 100, initial=12, arrivals={50: list(range(12, 16))}, join_warmup=8)
    graph_cli = cli.build_graph("full", 16, 0)
    faults_cli = scenario("crash", graph_cli, 100, seed=0)
    live_cli = mem_cli.active & faults_cli.node_up
    for label, r in runs_4i.items():
        h, nh = r["hist"], r["n_hat"]
        print(f"  CLI {label}: 100 rounds in {r['run_s']:.2f} s ({r['run_s'] / 100 * 1e3:.2f} ms a round as the "
              f"caller pays, the card finished; {r['wall']:.1f} s with data and init); launches "
              f"{ {k: n for k, n in r['launches'].items() if n} }; final train {h['train_loss'][-1]:.4f} test "
              f"{h['test_loss'][-1]:.4f}; n_active {h['n_active']}; online n̂ mean {nh.mean():.3f} range "
              f"[{nh.min():.3f}, {nh.max():.3f}] (true 16)")
        check(h["n_active"] == [int(live_cli[x].sum()) for x in h["round"]], f"CLI {label}: n_active {h['n_active']}")
        check(all(math.isfinite(v) for k in ("train_loss", "test_loss") for v in h[k]), f"CLI {label}: non-finite loss")
        check(abs(float(nh.mean()) - 16) / 16 < 0.5, f"CLI {label}: online n̂ {nh.mean()} far from 16")
    check(runs_4i["plain"]["launches"] == {**none_launched, "mix_matmul": 100},
          f"elastic CLI plain: launches {runs_4i['plain']['launches']}, want 100 mix_matmul")
    check(runs_4i["int8"]["launches"] == {**none_launched, "quant_mix_dense": 100}
          and runs_4i["int8"]["routes"] == {"staged": 100, "wide": 0},
          f"elastic CLI int8: launches {runs_4i['int8']['launches']} routes {runs_4i['int8']['routes']}")
    t_plain, t_int8 = runs_4i["plain"]["hist"]["test_loss"][-1], runs_4i["int8"]["hist"]["test_loss"][-1]
    print(f"  int8 final test loss {t_int8:.4f} against {t_plain:.4f} uncompressed ({t_int8 / t_plain - 1:+.2%})")
    check(abs(t_int8 - t_plain) <= 0.05 * abs(t_plain), f"elastic CLI int8 final test loss {t_int8} vs {t_plain}")
    elastic_launches = {"mix_matmul": runs_4i["plain"]["launches"]["mix_matmul"],
                        "quant_mix_dense": runs_4i["int8"]["launches"]["quant_mix_dense"]}

    # the kernels line's dense elastic rows: a crash-window round's masked,
    # renormalised operator (round 35: the 12 members less the victims,
    # identity rows for the rest), the plain mix and the int8 round with the
    # members' keep mask, against the plain versions and timed
    plan_cli = compile_plan(graph_cli, "dense", device=dev)
    act_35 = torch.as_tensor(live_cli[35], device=dev)
    m_el = plan_cli.round_operator(active=act_35, edge_live=torch.as_tensor(faults_cli.edge_up[35], device=dev))
    check(torch.equal(m_el[~act_35], torch.eye(16, device=dev)[~act_35]), "elastic operator: a non-member's row is "
          "not the identity")
    w = torch.randn(16, D_MAIN, generator=gen, device=dev)
    errs["mix_matmul_elastic"] = max(errs["mix_matmul_elastic"], compare(
        f"mix_matmul elastic round 35 ({int(act_35.sum())} of 16 live) d={D_MAIN}", lambda: mix_matmul(m_el, w),
        decavg_mix_ref(m_el, w), w))
    b_el, op_el = bound(4 * 16 * 16 + 2 * 4 * 16 * D_MAIN, 2 * 16 * 16 * D_MAIN)
    timing["mix_matmul_elastic"] = dict(
        ms=time_ms(lambda: mix_matmul(m_el, w), flush=flush),
        plain_ms=time_ms(lambda: decavg_mix_ref(m_el, w), flush=flush),
        library_ms=time_ms(lambda: torch.matmul(m_el, w), flush=flush),
        bound_ms=b_el, bound_by=op_el, shape=f"complete-16 round 35 of the elastic CLI (masked), n=16 d={D_MAIN} fp32",
        dense_route=dense_route(16, D_MAIN, torch.float32))
    del w
    x_q, h_q = quant_inputs(16)
    errs["quant_mix_dense_elastic"] = compare_quant(
        "quant_mix_dense int8 elastic round 35, members' keep", dense_kernel(m_el),
        lambda hq: decavg_mix_ref(m_el, hq), x_q, h_q, mlp_bounds, codec="int8", gamma=1.0, route="staged",
        keep=act_35)
    b_qe, op_qe = bound(16 * 16 * D_MAIN + 4 * 16 * 16 + 4 * 16 * n_chunks + table_bytes,
                        2 * 16 * 16 * D_MAIN + 12 * 16 * D_MAIN)
    timing["quant_mix_dense_elastic"] = dict(
        ms=time_ms(lambda: quant_mix_dense(m_el, x_q, h_q, mlp_edges, codec="int8", gamma=1.0, keep=act_35),
                   flush=flush, hold=True),
        plain_ms=time_ms(lambda: quant_mix_ref(lambda hq: decavg_mix_ref(m_el, hq), x_q, h_q, mlp_bounds,
                                               quant_scales_ref(x_q, h_q, mlp_bounds, codec="int8"),
                                               codec="int8", gamma=1.0, keep=act_35), flush=flush),
        library_ms=None,  # no one PyTorch call quantises and mixes
        bound_ms=b_qe, bound_by=op_qe,
        shape=f"complete-16 round 35 of the elastic CLI, int8 round with the members' keep mask, d={D_MAIN}, "
              "fp32, scales included")
    del x_q, h_q
    torch.cuda.empty_cache()

    # (c) preemption: run_trajectory, run_event_trajectory and
    # run_elastic_trajectory at full width on kreg4-16 (link_p 0.8; 12
    # rounds in chunks of 4 / 64 events in chunks of 16 / a join and a crash
    # burst in chunks of 4), each killed by SIGKILL right after chunk 0's
    # checkpoint in a child process of its own (the three at once), then one
    # child resumes each from its directory and runs it uninterrupted:
    # params, optimizer state, generator and history bitwise
    child_4i = r'''
import json
import sys
import time

import numpy as np
import torch

sys.path.insert(0, @SRC@)
from repro_torch import fed
from repro_torch.core import topology as T
from repro_torch.core.commplan import FailureModel, compile_plan
from repro_torch.core.faults import crash_burst
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.core.membership import membership_schedule
from repro_torch.data import batch_index_schedule, mnist_like, node_datasets
from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
from repro_torch.optim import sgd

N, PER, BL, R = 16, 64, 2, 12
graph = T.random_k_regular(N, 4, seed=0)
ds = mnist_like(N * PER + 256, seed=0)
xs, ys = node_datasets(ds, [np.arange(i * PER, (i + 1) * PER) for i in range(N)])
test = (ds.x[-256:], ds.y[-256:])


def loss_fn(p, b):
    return classifier_loss(mlp_forward(p, b[0]), b[1])


def init_one(g, gains):
    return init_mlp(InitConfig("he_normal", gains), g)


def run(kind, checkpoint=None, resume_from=None):
    opt = sgd(1e-3, 0.5)
    state = fed.init_fl_state(0, N, init_one, opt, gains=gain_from_graph(graph), device="cuda")
    plan = compile_plan(graph, "dense", failures=FailureModel(link_p=0.8), device="cuda")
    kw = dict(checkpoint=checkpoint, resume_from=resume_from, device="cuda")
    eval_fn = fed.make_eval_fn(loss_fn)
    if kind == "trajectory":
        sched = batch_index_schedule(PER, N, 16, R * BL, seed=0)
        return fed.run_trajectory(state, fed.make_round_fn(loss_fn, opt, plan), xs, ys, sched, n_rounds=R,
                                  eval_every=3, eval_fn=eval_fn, eval_batch=test, track_sigmas=True, chunk_size=4,
                                  **kw)
    if kind == "event":
        stream = T.poisson_event_stream(graph, 2.0, 1.0, seed=2)
        sched = batch_index_schedule(PER, N, 16, 2 * BL, seed=0)
        state, hist, _ = fed.run_event_trajectory(state, loss_fn, opt, plan, stream, xs, ys, sched, b_local=BL,
                                                  n_bins=4, eval_fn=eval_fn, eval_batch=test, chunk_events=16, **kw)
        return state, hist
    sched = batch_index_schedule(PER, N, 16, R * BL, seed=0)
    mem = membership_schedule(N, R, initial=N - 2, arrivals={1: [N - 2, N - 1]}, join_warmup=3)
    state, hist, aux = fed.run_elastic_trajectory(
        state, loss_fn, opt, plan, mem, xs, ys, sched, n_rounds=R, eval_every=3, eval_fn=eval_fn, eval_batch=test,
        chunk_size=4, init_one=init_one, faults=crash_burst(graph, R, at=5, size=2, duration=3, seed=1), **kw)
    hist["n_hat"] = [float(v) for v in aux["n_hat"]]
    return state, hist


def same(a, b):
    (sa, ha), (sb, hb) = a, b
    return (torch.equal(sa.params, sb.params) and all(torch.equal(x, y) for x, y in zip(sa.opt_state, sb.opt_state))
            and torch.equal(sa.generator.get_state(), sb.generator.get_state()) and sa.round == sb.round
            and json.dumps(ha) == json.dumps(hb))


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


if __name__ == "__main__":
    mode, root = sys.argv[1], sys.argv[2]
    if mode == "kill":
        run(sys.argv[3], checkpoint=fed.CheckpointPolicy(f"{root}/{sys.argv[3]}", every=1, kill_after=0))
        raise SystemExit("still alive after the kill")
    out = {}
    for kind in ("trajectory", "event", "elastic"):
        ref = run(kind)
        sync()
        t0 = time.perf_counter()
        res = run(kind, resume_from=f"{root}/{kind}")
        sync()
        out[kind] = {"bitwise": same(ref, res), "resumed_s": time.perf_counter() - t0,
                     "final_train_loss": ref[1]["train_loss"][-1]}
    print(json.dumps(out))
'''.replace("@SRC@", repr(str(ROOT / "src")))
    d_4i = ROOT / "build" / "phase4i"
    shutil.rmtree(d_4i, ignore_errors=True)
    d_4i.mkdir(parents=True)
    script_4i = d_4i / "preempt.py"
    script_4i.write_text(child_4i)
    kinds_4i = ("trajectory", "event", "elastic")
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, str(script_4i), "kill", str(d_4i), k], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k in kinds_4i}
    killed = {}
    try:
        for k, pr in procs.items():
            _, err = pr.communicate(timeout=300)
            killed[k] = (pr.returncode, err[-2000:])
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    kill_s = time.perf_counter() - t0
    for k, (rc, err) in killed.items():
        check(rc == -signal.SIGKILL, f"preempted {k} child: exit {rc}, want SIGKILL; {err}")
        check(restore_train_state(str(d_4i / k))[1]["chunk"] == 0, f"preempted {k}: LATEST is not chunk 0")
    t0 = time.perf_counter()
    res_4i = subprocess.run([sys.executable, str(script_4i), "resume", str(d_4i)], capture_output=True, text=True,
                            timeout=600)
    resume_s = time.perf_counter() - t0
    check(res_4i.returncode == 0, f"resume child failed: {res_4i.stderr[-3000:]}")
    resumed_4i = json.loads(res_4i.stdout.strip().splitlines()[-1])
    print(f"  three children killed by SIGKILL after chunk 0 ({kill_s:.1f} s together), one child resumed each "
          f"and ran it whole ({resume_s:.1f} s): {resumed_4i}")
    check(all(v["bitwise"] for v in resumed_4i.values()), f"a resumed run differs from the uninterrupted one: "
          f"{resumed_4i}")
    # what a checkpoint costs at this width: restore of each kind's file,
    # and a save as the run pays it (the carry read back from the card,
    # written, fsynced): the chunked trajectory with a checkpoint every
    # chunk against the same run without, in turns
    ns_4i = {"__name__": "phase4i"}
    exec(child_4i, ns_4i)
    for k in kinds_4i:
        path = d_4i / k / "step_00000000.ckpt"
        t0 = time.perf_counter()
        for _ in range(3):
            restore_train_state(str(d_4i / k))
        print(f"  {k} checkpoint: {path.stat().st_size:,} B, restore {(time.perf_counter() - t0) / 3 * 1e3:.1f} ms")
    walls_ck = {"none": [], "every chunk": []}
    for _ in range(2):
        for label in walls_ck:
            ck_dir = d_4i / "timed"
            shutil.rmtree(ck_dir, ignore_errors=True)
            policy = None if label == "none" else CheckpointPolicy(str(ck_dir), every=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ns_4i["run"]("trajectory", checkpoint=policy)
            torch.cuda.synchronize()
            walls_ck[label].append(time.perf_counter() - t0)
    ckpt_bytes = (d_4i / "trajectory" / "step_00000000.ckpt").stat().st_size
    save_ms = (min(walls_ck["every chunk"]) - min(walls_ck["none"])) / 3 * 1e3
    chunk_ms = min(walls_ck["none"]) / 3 * 1e3
    print(f"  full-width run_trajectory (kreg4-16, 12 rounds in 3 chunks of 4): walls without / with a checkpoint "
          f"every chunk {[round(v, 3) for v in walls_ck['none']]} / {[round(v, 3) for v in walls_ck['every chunk']]} "
          f"s in turns: {save_ms:.1f} ms a save of {ckpt_bytes:,} B against {chunk_ms:.1f} ms a chunk "
          f"({save_ms / chunk_ms:.0%}; a chunk of 25 rounds: {save_ms / (chunk_ms * 25 / 4):.0%})")
    shutil.rmtree(d_4i, ignore_errors=True)

    # (d) the sparse backend: the CLI's elastic run on kreg4-256 (full
    # width, 20 rounds of 2 local batches, 16 slots arriving at round 4 with
    # a warmup of 4, crash+partition), one mix_bsr launch a round; then a
    # partition-window round's masked BSR operator against the plain walk
    argv_d = ["--model", "mlp", "--topology", "kregular", "--nodes", "256", "--rounds", "20", "--items-per-node",
              "64", "--local-batches", "2", "--join-nodes", "16", "--join-round", "4", "--join-warmup", "4",
              "--fault-scenario", "crash+partition"]
    hist_d, wall_d, launches_d = counted(lambda: cli.main(argv_d))
    g_d = cli.build_graph("kregular", 256, 0)
    mem_d = membership_schedule(256, 20, initial=240, arrivals={4: list(range(240, 256))}, join_warmup=4)
    faults_d = scenario("crash+partition", g_d, 20, seed=0)
    live_d = mem_d.active & faults_d.node_up
    print(f"  CLI {' '.join(argv_d)}: {wall_d:.1f} s with data and init; launches "
          f"{ {k: n for k, n in launches_d.items() if n} }; n_active {hist_d['n_active']}; final train "
          f"{hist_d['train_loss'][-1]:.4f} test {hist_d['test_loss'][-1]:.4f}")
    check(launches_d == {**none_launched, "mix_bsr": 20}, f"sparse elastic CLI launches {launches_d}, want 20 mix_bsr")
    check(hist_d["n_active"] == [int(live_d[x].sum()) for x in hist_d["round"]], "sparse elastic CLI: n_active")
    check(all(math.isfinite(v) for k in ("train_loss", "test_loss") for v in hist_d[k]),
          "sparse elastic CLI: non-finite loss")
    elastic_launches["mix_bsr"] = launches_d["mix_bsr"]
    r_cut = int(np.nonzero(~faults_d.edge_up.all(axis=1))[0][0])  # the partition's first round
    plan_d = compile_plan(g_d, "sparse", device=dev)
    act_d = torch.as_tensor(live_d[r_cut], device=dev)
    eup_d = torch.as_tensor(faults_d.edge_up[r_cut], device=dev)
    op_d = plan_d.round_operator(active=act_d, edge_live=eup_d)
    w = torch.randn(256, D_MAIN, generator=gen, device=dev)
    errs["mix_bsr_elastic"] = compare(
        f"mix_bsr elastic kreg4-256 round {r_cut} ({int(act_d.sum())} live, {int((~eup_d).sum())} edges cut)",
        lambda: mix_bsr(*op_d, w), mix_bsr_ref(*op_d, w), w)
    rows_bitwise("mix_bsr elastic kreg4-256", op_d, w)
    m_dense_d = compile_plan(g_d, "dense", device=dev).round_operator(active=act_d, edge_live=eup_d)
    nnz_d = int((m_dense_d != 0).sum())
    csr_d = m_dense_d.to_sparse_csr()
    b_bd, op_bd = bound(sum(t.numel() * 4 for t in op_d) + 2 * 4 * 256 * D_MAIN, 2 * nnz_d * D_MAIN)
    timing["mix_bsr_elastic"] = dict(
        ms=time_ms(lambda: mix_bsr(*op_d, w), flush=flush),
        plain_ms=time_ms(lambda: mix_bsr_ref(*op_d, w), reps=3, flush=flush),
        library_ms=time_ms(lambda: torch.sparse.mm(csr_d, w), flush=flush),
        bound_ms=b_bd, bound_by=op_bd,
        shape=f"kreg4-256 round {r_cut} of the elastic CLI (crash+partition, masked), bn 32, d={D_MAIN} fp32")
    del w, csr_d, m_dense_d
    torch.cuda.empty_cache()

    # (e) card vs CPU at a small size: kreg4-8, the MLP at hidden (64, 32),
    # link_p 0.8, a join and a crash burst, 12 rounds in chunks of 4; one
    # numpy init, the same host failure draws, the forked draws (sketches,
    # the joiners' trees) made on the CPU and moved to the run's device
    real_draws = elastic_executor.elastic_draws

    def cpu_draws(kind, seed, r, *, n, device, **kw):
        kw = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
        out = real_draws(kind, seed, r, n=n, device="cpu", **kw)
        return out.to(device) if kind == "sketches" else tree_map(lambda t: t.to(device), out)

    def loss_4i(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    g8e = T.random_k_regular(8, 4, seed=0)
    init_rng_e = np.random.default_rng(11)
    dims_e = [784, 64, 32, 10]
    params_e = {f"fc{i}": {"w": (init_rng_e.standard_normal((8, dims_e[i], dims_e[i + 1]))
                                 * math.sqrt(2.0 / dims_e[i])).astype(np.float32),
                           "b": np.zeros((8, dims_e[i + 1]), np.float32)} for i in range(3)}
    ds_e = mnist_like(8 * 64 + 256, seed=3)
    xs_e, ys_e = node_datasets(ds_e, [np.arange(i * 64, (i + 1) * 64) for i in range(8)])
    runs_e = {}
    elastic_executor.elastic_draws = cpu_draws
    try:
        for where in ("cpu", "cuda"):
            opt_e = sgd(1e-3, 0.5)
            runs_e[where] = run_elastic_trajectory(
                state_from_numpy(params_e, optimizer=opt_e, device=where), loss_4i, opt_e,
                compile_plan(g8e, "dense", failures=FailureModel(link_p=0.8), device=where),
                membership_schedule(8, 12, initial=6, arrivals={1: [6, 7]}, join_warmup=3), xs_e, ys_e,
                batch_index_schedule(64, 8, 16, 24, seed=3), n_rounds=12, eval_every=3,
                eval_fn=make_eval_fn(loss_4i), eval_batch=(ds_e.x[-256:], ds_e.y[-256:]), chunk_size=4,
                init_one=lambda g, gains: init_mlp(InitConfig("he_normal", gains), g, hidden=(64, 32)),
                faults=crash_burst(g8e, 12, at=5, size=2, duration=3, seed=1), device=where)
    finally:
        elastic_executor.elastic_draws = real_draws
    (f_ec, h_ec, a_ec), (f_eg, h_eg, a_eg) = runs_e["cpu"], runs_e["cuda"]
    rel_e = rel_err(f_eg.params, f_ec.params)
    loss_rel_e = max(abs(a - b) / abs(b) for k in ("train_loss", "test_loss") for a, b in zip(h_eg[k], h_ec[k]))
    print(f"  card vs CPU (kreg4-8, hidden (64, 32), link_p 0.8, a join and a crash, 12 rounds): n_active "
          f"{h_eg['n_active']} equal {h_eg['n_active'] == h_ec['n_active']}, wire equal "
          f"{h_eg['wire_messages'] == h_ec['wire_messages']}, n̂ equal {np.array_equal(a_eg['n_hat'], a_ec['n_hat'])}; "
          f"largest relative loss difference {loss_rel_e:.2e}, params {rel_e:.2e}")
    check(h_eg["n_active"] == h_ec["n_active"] and h_eg["wire_messages"] == h_ec["wire_messages"]
          and np.array_equal(a_eg["n_hat"], a_ec["n_hat"]), "elastic card vs CPU: integer channels or n̂ differ")
    check(loss_rel_e <= 1e-4 and bool(torch.allclose(f_eg.params.cpu(), f_ec.params, rtol=1e-4, atol=1e-5)),
          f"elastic card vs CPU: losses {loss_rel_e:.2e}, params {rel_e:.2e}")

    # (f) fig11 quick through the port's driver (build/fig11_elastic.json):
    # every launch one dense mix (n 32 / 64 / 16), 4 × 40 + 2 × 96 + 3 × 12
    out_11 = ROOT / "build" / "fig11_elastic.json"
    res_11, wall_11, launches_11 = counted(lambda: fig11_elastic.run(quick=True, device=dev, out_path=out_11))
    for rec in res_11["records"]:
        print("  fig11 " + json.dumps({k: (round(v, 6) if isinstance(v, float) else v) for k, v in rec.items()
                                       if not k.startswith("curve_")}))
    print(f"  fig11 quick: {wall_11:.1f} s; launches { {k: n for k, n in launches_11.items() if n} }")
    recs_11 = {r["scenario"]: r for r in res_11["records"]}
    check(sorted(recs_11) == ["ckpt-overhead", "crash", "hub", "join", "none", "resume-parity"],
          f"fig11 records {sorted(recs_11)}")
    check(all(math.isfinite(recs_11[s]["final_test_loss"]) for s in ("none", "crash", "hub", "join")),
          "fig11: a non-finite final test loss")
    check(recs_11["resume-parity"]["parity_bitexact"] is True, "fig11: the resume-parity record is not bit-exact")
    check(launches_11 == {**none_launched, "mix_matmul": 4 * 40 + 2 * 96 + 3 * 12}, f"fig11 launches {launches_11}")
    print(f"  phase 4i: {time.perf_counter() - t_4i:.1f} s")
    torch.cuda.empty_cache()

    # ------------------------------------- 4j. telemetry and the training CLI
    phase("4j. telemetry, profiler traces and the rest of the training CLI: --telemetry, --profile-trace, "
          "--model transformer, --arch --legacy-loop")
    t_4j = time.perf_counter()
    from repro_torch.fed.trainer import DFLState
    from repro_torch.launch import serve as serve_cli_4j
    from repro_torch.obs import read_run_log, validate_run_log

    out_4j = ROOT / "build" / "phase4j"
    shutil.rmtree(out_4j, ignore_errors=True)
    out_4j.mkdir(parents=True)
    # the CLI's gossip-health report spreads over the plan's Mᵀ (kernels 1g /
    # 2g): a wrapper counts its launches apart from the training rounds'
    real_health = cli.gossip_health
    health_launches = []

    def counted_health(*a, **kw):
        before = {kern.__name__: kern.launches for kern in kernels}
        out = real_health(*a, **kw)
        health_launches.append({k: kern.launches - before[k] for k, kern in
                                ((kern.__name__, kern) for kern in kernels)})
        return out

    def cli_log(label, argv):
        """One CLI run with --telemetry into build/phase4j: (history, records,
        launches of the training rounds, launches of the health report, s)."""
        path = out_4j / f"{label}.jsonl"
        health_launches.clear()
        hist_j, wall_j, launches_j = counted(lambda: cli.main([*argv, "--telemetry", str(path)]))
        recs_j = read_run_log(path)
        problems = validate_run_log(recs_j)
        check(not problems, f"4j {label}: the run log fails validate_run_log: {problems}")
        health_j = health_launches[0] if health_launches else dict(none_launched)
        train_j = {k: launches_j[k] - health_j[k] for k in launches_j}
        kinds = [r["kind"] for r in recs_j]
        print(f"  {label}: {wall_j:.1f} s; {len(recs_j)} records {dict(collections.Counter(kinds))}; training "
              f"launches { {k: v for k, v in train_j.items() if v} }, the health report's "
              f"{ {k: v for k, v in health_j.items() if v} }")
        return hist_j, recs_j, train_j, health_j

    def mlp_row_bytes(comp=None):
        sizes = FlatLayout.of(init_mlp(InitConfig("he_normal", torch.ones(1)), torch.Generator().manual_seed(0))).sizes
        if comp is None:
            return 4 * sum(sizes)
        return int(round(sum(float(comp.leaf_row_bytes(sz, torch.float32)) for sz in sizes)))

    # every launch at a gossip payload (d ≤ 4: the health reports' spreads)
    # and every flash launch (the transformer's eval) is recorded and held
    # to phase 3's shapes
    launched_4j, flash_4j = set(), set()
    real_mm_4j, real_bsr_4j = mix_ops.mix_matmul, mix_ops.mix_bsr

    def recording_mm_4j(m, w):
        if w.is_cuda:
            launched_4j.add(("mix_matmul", w.shape[0], w.shape[1] if w.ndim > 1 else 1, 0))
        return real_mm_4j(m, w)

    def recording_bsr_4j(block_cols, tiles, counts, w, n_rows=None):
        if w.is_cuda:
            launched_4j.add(("mix_bsr", w.shape[0], w.shape[1] if w.ndim > 1 else 1, tiles.shape[-1]))
        return real_bsr_4j(block_cols, tiles, counts, w, n_rows)

    def recording_flash_4j(q, k, v, *, causal=True, window=0):
        if q.is_cuda:
            flash_4j.add(flash_key(q, k, causal, window))
        return flash_mha(q, k, v, causal=causal, window=window)

    cli.gossip_health = counted_health
    mix_ops.mix_matmul, mix_ops.mix_bsr, flash_ops.flash_mha = recording_mm_4j, recording_bsr_4j, recording_flash_4j
    try:
        # (a) complete-16, the full-width MLP: 20 rounds, then 20 int8 rounds
        base_a = ["--model", "mlp", "--rounds", "20"]
        logs_a = {}
        for label, extra, kname in (("plain", [], "mix_matmul"), ("int8", ["--compress", "int8"], "quant_mix_dense")):
            hist_a, recs_a, train_a, health_a = cli_log(f"complete16-{label}", base_a + extra)
            comp_a = None if label == "plain" else Compression(codec="int8", chunk=2048)
            row_a = mlp_row_bytes(comp_a)
            rows_a = recs_a[1:-2]
            check([r["kind"] for r in recs_a] == ["manifest", *["round"] * 20, "summary", "gossip_health"],
                  f"4j complete-16 {label}: record kinds {[r['kind'] for r in recs_a]}")
            check(recs_a[0]["jax_version"] is None and recs_a[0]["backend"] == "cuda"
                  and recs_a[0]["device_name"] == torch.cuda.get_device_name(0), f"4j {label}: manifest {recs_a[0]}")
            check(all(r["wire_messages"] == 240 for r in rows_a), f"4j {label}: wire {[r['wire_messages'] for r in rows_a]}")
            check(all(r["wire_bytes"] == r["wire_messages"] * row_a for r in rows_a),
                  f"4j {label}: wire bytes {rows_a[0]['wire_bytes']} vs 240 × {row_a}")
            check(train_a == {**none_launched, kname: 20}, f"4j complete-16 {label}: training launches {train_a}")
            check(health_a == {**none_launched, "mix_matmul": 64}, f"4j complete-16 {label}: health launches {health_a}")
            check(all(math.isfinite(v) for v in hist_a["train_loss"] + hist_a["test_loss"]),
                  f"4j complete-16 {label}: non-finite loss")
            logs_a[label] = recs_a
            print(f"    {label}: {row_a} bytes a row, final test {hist_a['test_loss'][-1]:.4f}, gossip health "
                  f"fitted {recs_a[-1]['fitted_rate']} predicted {recs_a[-1]['predicted_rate']}")

        # (b) ring-1024, sparse, link_p 0.9: each round's count is the number
        # of off-diagonal entries of the masked operator the round mixed
        # with, replayed from the CLI's generator (seeded --seed 0) on a
        # dense plan of the same graph and failure model (the same draws)
        hist_b, recs_b, train_b, health_b = cli_log("ring1024", [
            "--model", "mlp", "--topology", "ring", "--nodes", "1024", "--rounds", "3", "--local-batches", "2",
            "--link-p", "0.9"])
        dense_b = compile_plan(T.ring(1024), "dense", failures=FailureModel(link_p=0.9), device=dev)
        gen_b = torch.Generator().manual_seed(0)
        eye_b = torch.eye(1024, dtype=torch.bool, device=dev)
        kept_b = [int(((dense_b.round_operator(gen_b) != 0) & ~eye_b).sum()) for _ in range(3)]
        wire_b = [r["wire_messages"] for r in recs_b if r["kind"] == "round"]
        drift_b = recs_b[-1]["mass_drift_max"]
        print(f"    ring-1024: wire {wire_b}, the masked operators' off-diagonal entries {kept_b} (of 2048); gossip "
              f"health mass_drift_max {drift_b:.3e} (fp32 level 1e-05), fitted {recs_b[-1]['fitted_rate']}")
        check(wire_b == kept_b and all(k < 2048 for k in kept_b), f"4j ring-1024: wire {wire_b} vs operators {kept_b}")
        check(train_b == {**none_launched, "mix_bsr": 3}, f"4j ring-1024: training launches {train_b}")
        check(health_b == {**none_launched, "mix_bsr": 128}, f"4j ring-1024: health launches {health_b}")
        check(0.0 <= drift_b < 1e-5, f"4j ring-1024: mass drift {drift_b}")
        del dense_b, eye_b

        # (c) --async and --elastic on kreg4-16
        kreg_c = ["--model", "mlp", "--topology", "kregular", "--nodes", "16", "--local-batches", "2"]
        hist_c, recs_c, train_c, _ = cli_log("kreg16-async", [*kreg_c, "--rounds", "4", "--async", "--link-p", "0.8"])
        bins_c = [r for r in recs_c if r["kind"] == "bin"]
        row_c = mlp_row_bytes()
        check(len(bins_c) == 20 and all("messages" in r and r["wire_bytes"] == r["messages"] * row_c for r in bins_c),
              "4j async: bin rows without messages or with other bytes")
        check(recs_c[-2]["recorded_wire_messages"] == sum(hist_c["messages"]) < 2 * sum(hist_c["events"]),
              f"4j async: delivered {sum(hist_c['messages'])} of {2 * sum(hist_c['events'])} (link_p 0.8)")
        hist_e, recs_e, train_e, _ = cli_log("kreg16-elastic", [*kreg_c, "--rounds", "12", "--join-nodes", "2",
                                                                 "--join-round", "4", "--join-warmup", "2",
                                                                 "--fault-scenario", "crash"])
        g_e = cli.build_graph("kregular", 16, 0)
        mem_e = membership_schedule(16, 12, initial=14, arrivals={4: [14, 15]}, join_warmup=2)
        faults_e = scenario("crash", g_e, 12, seed=0)
        live_e = mem_e.active & faults_e.node_up
        uv_e = g_e.edge_list()
        want_e = [2 * int(sum(bool(faults_e.edge_up[r, i] and live_e[r, u] and live_e[r, v])
                              for i, (u, v) in enumerate(uv_e))) for r in hist_e["round"]]
        print(f"    elastic: wire {hist_e['wire_messages']}, the masks' live edges × 2 {want_e}, n_active "
              f"{hist_e['n_active']}")
        check(hist_e["wire_messages"] == want_e and min(want_e) < 2 * len(uv_e), f"4j elastic: wire {hist_e['wire_messages']}")
        check(train_e == {**none_launched, "mix_matmul": 12}, f"4j elastic: training launches {train_e}")

        # (f) the token models: --model transformer (reduced qwen2.5-3b on
        # token windows through the executor, int8 rounds; each recorded
        # round's eval runs fp32 flash, 2 layers × 8 nodes) and --arch
        # --reduced --legacy-loop (host-fed train_loop, no eval)
        hist_f, recs_f, train_f, _ = cli_log("transformer-int8", [
            "--model", "transformer", "--nodes", "8", "--rounds", "3", "--items-per-node", "64", "--local-batches", "1",
            "--compress", "int8"])
        check(train_f == {**none_launched, "quant_mix_dense": 3, "flash_mha": 3 * 8 * 2},
              f"4j transformer: training launches {train_f}")
        check(all(math.isfinite(v) for v in hist_f["train_loss"] + hist_f["test_loss"]), "4j transformer: loss")
        hist_l, recs_l, train_l, _ = cli_log("arch-legacy", [
            "--arch", "qwen2.5-3b", "--reduced", "--legacy-loop", "--nodes", "8", "--rounds", "3", "--local-batches",
            "1"])
        check(train_l == {**none_launched, "mix_matmul": 3}, f"4j --arch --legacy-loop: training launches {train_l}")
        check(all(math.isfinite(v) for v in hist_l["train_loss"]) and "wire_messages" not in recs_l[1],
              "4j --arch --legacy-loop: loss or channels")
        print(f"    transformer int8 final train {hist_f['train_loss'][-1]:.4f} test {hist_f['test_loss'][-1]:.4f}; "
              f"--arch legacy final train {hist_l['train_loss'][-1]:.4f}")

        # (g) card vs CPU: one kreg4-8 log each way (full width, link_p 0.8),
        # both from one init drawn on the CPU and moved (the CLI draws on
        # the run's device); the failure draws are the CPU generator's in both
        real_init = cli.init_fl_state

        def cpu_init(seed, n, init_one, opt, gains=None, device=None):
            s_cpu = real_init(seed, n, init_one, opt, gains=gains, device="cpu")
            return DFLState(params=s_cpu.params.to(device), opt_state=type(s_cpu.opt_state)(
                *(f.to(device) for f in s_cpu.opt_state)), layout=s_cpu.layout, round=0, generator=s_cpu.generator)

        cli.init_fl_state = cpu_init
        try:
            logs_g = {}
            for where in ("cpu", "cuda"):
                path = out_4j / f"kreg8-{where}.jsonl"
                hist_g = cli.main(["--model", "mlp", "--topology", "kregular", "--nodes", "8", "--rounds", "3",
                                   "--items-per-node", "64", "--local-batches", "2", "--link-p", "0.8",
                                   "--device", where, "--telemetry", str(path)])
                logs_g[where] = (hist_g, read_run_log(path))
        finally:
            cli.init_fl_state = real_init
        (h_gc, r_gc), (h_gg, r_gg) = logs_g["cpu"], logs_g["cuda"]
        same_shape = ([r["kind"] for r in r_gc] == [r["kind"] for r in r_gg]
                      and all(sorted(a) == sorted(b) for a, b in zip(r_gc, r_gg)))
        loss_rel_g = max(abs(a - b) / abs(b) for k in ("train_loss", "test_loss") for a, b in zip(h_gg[k], h_gc[k]))
        print(f"    card vs CPU (kreg4-8, link_p 0.8, 3 rounds): kinds and keys equal {same_shape}, wire "
              f"{h_gg['wire_messages']} / {h_gc['wire_messages']}, largest relative loss difference {loss_rel_g:.2e}")
        check(same_shape and validate_run_log(r_gc) == [] and r_gc[0]["backend"] == "cpu", "4j card vs CPU: records")
        check(h_gg["wire_messages"] == h_gc["wire_messages"] and h_gg["wire_bytes"] == h_gc["wire_bytes"],
              "4j card vs CPU: wire channels differ")
        check(all(np.allclose(h_gg[k], h_gc[k], rtol=1e-4, atol=1e-5) for k in ("train_loss", "test_loss")),
              f"4j card vs CPU: losses {loss_rel_g:.2e}")
    finally:
        cli.gossip_health = real_health
        mix_ops.mix_matmul, mix_ops.mix_bsr, flash_ops.flash_mha = real_mm_4j, real_bsr_4j, flash_mha
    gossip_4j = {key for key in launched_4j if key[2] <= 4}
    print(f"  the phase's gossip launches ran at {sorted(gossip_4j)}, its flash launches at {sorted(flash_4j, key=str)}")
    check(gossip_4j <= gossip_checked, f"phase 4j launched gossip shapes {sorted(gossip_4j - gossip_checked)} not "
          "checked in phase 3")
    check(bool(flash_4j) and flash_4j <= flash_checked, f"phase 4j launched flash at "
          f"{sorted(flash_4j - flash_checked, key=str)}, not checked in phase 3")

    # (d) the serve CLI at its defaults with a run log of 16 query records
    path_d = out_4j / "serve.jsonl"
    (hist_d, summ_d), wall_d, launches_d = counted(lambda: serve_cli_4j.main(["--telemetry", str(path_d),
                                                                               "--log-queries", "16"]))
    recs_d = read_run_log(path_d)
    kinds_d = [r["kind"] for r in recs_d]
    print(f"  serve CLI: {wall_d:.1f} s, {len(recs_d)} records {dict(collections.Counter(kinds_d))}")
    check(validate_run_log(recs_d) == [] and kinds_d == ["manifest", *["bin"] * 10, *["query"] * min(16, summ_d["served"]),
                                                         "summary"], f"4j serve log kinds {kinds_d}")
    check(summ_d["served"] >= 16, f"4j serve: {summ_d['served']} queries served")

    # (e) --profile-trace of (a)'s plain run, and of 3 ring-1024 rounds, each
    # in a child process (after a profiler session in-process later launches
    # took more host time: PR 19).  Every mix kernel launch must lie inside a
    # dfl_mix range; each phase's device time is its launches' kernels' time
    split_4j = {}
    for label, argv in (("complete-16", base_a), ("ring-1024", ["--model", "mlp", "--topology", "ring", "--nodes",
                                                               "1024", "--rounds", "3", "--local-batches", "2"])):
        tdir = out_4j / f"trace-{label}"
        t0 = time.perf_counter()
        run_e = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv, "--profile-trace", str(tdir)],
                               cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, capture_output=True,
                               text=True, timeout=600)
        check(run_e.returncode == 0, f"4j --profile-trace {label}: exit {run_e.returncode}: {run_e.stderr[-2000:]}")
        events = json.loads((tdir / "trace.json").read_text())["traceEvents"]
        n_rounds_e = int(argv[argv.index("--rounds") + 1])
        scopes = {name: [(e["ts"], e["ts"] + e["dur"]) for e in events
                         if e.get("cat") == "user_annotation" and e.get("name") == name]
                  for name in ("dfl_local", "dfl_mix", "dfl_eval")}
        launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                     if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
        kern_ev = [e for e in events if e.get("cat") == "kernel"]

        def inside(ts, spans):
            return any(a <= ts <= b for a, b in spans)

        mix_name = "mix_wide_kernel" if label == "complete-16" else "mix_bsr_kernel"
        mix_k = [e for e in kern_ev if mix_name in e["name"]]
        mix_in = [inside(launch_ts.get(e["args"].get("correlation"), -1.0), scopes["dfl_mix"]) for e in mix_k]
        split = {}
        for name, spans in scopes.items():
            dev_us = sum(e["dur"] for e in kern_ev if inside(launch_ts.get(e["args"].get("correlation"), -1.0), spans))
            host_us = sum(b - a for a, b in spans)
            split[name] = dict(n=len(spans), device_ms=dev_us / n_rounds_e / 1e3, host_ms=host_us / n_rounds_e / 1e3)
        split_4j[label] = split
        print(f"  --profile-trace {label} ({n_rounds_e} rounds, child process {time.perf_counter() - t0:.1f} s): "
              f"{len(mix_k)} {mix_name} launches, {sum(mix_in)} inside a dfl_mix range; a round's split, traced: "
              + "; ".join(f"{k} device {v['device_ms']:.4f} ms host {v['host_ms']:.4f} ms ({v['n']} ranges)"
                          for k, v in split.items()))
        check(len(mix_k) == n_rounds_e and all(mix_in), f"4j trace {label}: {len(mix_k)} {mix_name}, "
              f"{sum(mix_in)} inside dfl_mix")
        check(all(v["n"] == n_rounds_e for v in split.values()), f"4j trace {label}: ranges {split}")
    print(f"  phase 4j: {time.perf_counter() - t_4j:.1f} s")

    # ------------------------------- 4k. --model moe and the measurement drivers
    phase("4k. --model moe on the card, fig12 and kernels_bench through benchmarks.run, run_mixing")
    t_4k = time.perf_counter()
    from repro_torch.benchmarks import kernels_bench

    out_4k = ROOT / "build" / "phase4k"
    shutil.rmtree(out_4k, ignore_errors=True)
    out_4k.mkdir(parents=True)
    # (a) the CLI's --model moe: the reduced granite-moe-1b-a400m through the
    # executor at n = 8, 3 rounds, plain and int8; each recorded round's
    # eval runs fp32 flash (2 layers × 8 nodes); every mix and flash launch's
    # shape is among phase 3's
    flash_4k, mix_4k = set(), set()
    real_mm_4k = mix_ops.mix_matmul

    def recording_mm_4k(m, w):
        mix_4k.add(tuple(w.shape))
        return real_mm_4k(m, w)

    def recording_flash_4k(q, k, v, *, causal=True, window=0):
        flash_4k.add(flash_key(q, k, causal, window))
        return flash_mha(q, k, v, causal=causal, window=window)

    moe_argv = ["--model", "moe", "--nodes", "8", "--rounds", "3", "--items-per-node", "64", "--local-batches", "1"]
    moe_launches = {}
    mix_ops.mix_matmul, flash_ops.flash_mha = recording_mm_4k, recording_flash_4k
    try:
        for label, extra in (("plain", []), ("int8", ["--compress", "int8"])):
            hist_k, wall_k, launches_k = counted(lambda: cli.main([*moe_argv, *extra]))
            moe_launches[label] = launches_k
            want_k = {**none_launched, ("quant_mix_dense" if extra else "mix_matmul"): 3, "flash_mha": 3 * 8 * 2}
            print(f"  --model moe {label}: {wall_k:.1f} s; launches { {k: v for k, v in launches_k.items() if v} }; "
                  f"train {[round(x, 4) for x in hist_k['train_loss']]} test {[round(x, 4) for x in hist_k['test_loss']]}")
            check(launches_k == want_k, f"4k --model moe {label}: launches {launches_k}, want {want_k}")
            check(all(math.isfinite(x) for x in hist_k["train_loss"] + hist_k["test_loss"]), f"4k moe {label}: loss")
    finally:
        mix_ops.mix_matmul, flash_ops.flash_mha = real_mm_4k, flash_mha
    print(f"  mix shapes {sorted(mix_4k)}, flash shapes {sorted(flash_4k, key=str)}")
    check(mix_4k == {(8, D_MOE)}, f"4k --model moe mixed at {sorted(mix_4k)}, phase 3 checked (8, {D_MOE})")
    check(bool(flash_4k) and flash_4k <= flash_checked,
          f"4k launched flash at {sorted(flash_4k - flash_checked, key=str)}, not checked in phase 3")
    # a run log card vs CPU, both from one init drawn on the CPU and moved
    # (the CLI draws on the run's device); the token windows and failure
    # draws are the CPU's on both
    real_init_4k = cli.init_fl_state

    def cpu_init_4k(seed, n, init_one, opt, gains=None, device=None):
        s_cpu = real_init_4k(seed, n, init_one, opt, gains=gains, device="cpu")
        return DFLState(params=s_cpu.params.to(device), opt_state=type(s_cpu.opt_state)(
            *(f.to(device) for f in s_cpu.opt_state)), layout=s_cpu.layout, round=0, generator=s_cpu.generator)

    cli.init_fl_state = cpu_init_4k
    try:
        logs_k = {}
        for where in ("cpu", "cuda"):
            path = out_4k / f"moe-{where}.jsonl"
            logs_k[where] = (cli.main([*moe_argv, "--device", where, "--telemetry", str(path)]), read_run_log(path))
    finally:
        cli.init_fl_state = real_init_4k
    (h_kc, r_kc), (h_kg, r_kg) = logs_k["cpu"], logs_k["cuda"]
    same_k = ([r["kind"] for r in r_kc] == [r["kind"] for r in r_kg]
              and all(sorted(a) == sorted(b) for a, b in zip(r_kc, r_kg)))
    loss_rel_k = max(abs(a - b) / abs(b) for key in ("train_loss", "test_loss") for a, b in zip(h_kg[key], h_kc[key]))
    print(f"  --model moe card vs CPU (one CPU init, 3 rounds): kinds and keys equal {same_k}, wire "
          f"{h_kg['wire_bytes']} / {h_kc['wire_bytes']}, largest relative loss difference {loss_rel_k:.2e}")
    check(same_k and validate_run_log(r_kg) == [] and validate_run_log(r_kc) == [], "4k card vs CPU: records")
    check(h_kg["wire_bytes"] == h_kc["wire_bytes"], "4k card vs CPU: wire bytes differ")
    check(all(np.allclose(h_kg[key], h_kc[key], rtol=1e-4, atol=1e-5) for key in ("train_loss", "test_loss")),
          f"4k card vs CPU: losses {loss_rel_k:.2e}")

    # (b) fig12 and the kernel benchmarks through the harness, in a child
    # process: exit 0; fig12's wire bytes and reductions the JAX package's
    # records codec by codec (shapes only, no draws); each kernel's error
    # within phase 3's tolerance for its kernel and route
    t0 = time.perf_counter()
    run_b = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", "--quick", "fig12", "kernels"],
                           cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, capture_output=True,
                           text=True, timeout=900)
    harness_s = time.perf_counter() - t0
    (out_4k / "benchmarks_run.log").write_text(run_b.stdout + run_b.stderr)
    print(f"  benchmarks.run --quick fig12 kernels: exit {run_b.returncode} in {harness_s:.1f} s")
    check(run_b.returncode == 0, f"benchmarks.run exit {run_b.returncode}: {run_b.stderr[-3000:]}")
    rows_b = {}
    for line in run_b.stdout.splitlines():
        if line.startswith(("fig12.", "kernels.")):
            name, us, derived = line.split(",", 2)
            rows_b[name] = (float(us), derived)
            print(f"    {line}")
    fig12_out = json.loads((ROOT / "build" / "fig12_compress.json").read_text())
    jax_records = {(r["kind"], r["family"], r["codec"]): r
                   for r in json.loads((ROOT / "BENCH_compress.json").read_text())["records"]}
    check(len(fig12_out["records"]) == len(jax_records) == 12, f"fig12 wrote {len(fig12_out['records'])} records")
    for r in fig12_out["records"]:
        j = jax_records[(r["kind"], r["family"], r["codec"])]
        check(r["wire_bytes_per_round"] == j["wire_bytes_per_round"]
              and r["bytes_reduction_vs_fp32"] == j["bytes_reduction_vs_fp32"] and sorted(r) == sorted(j),
              f"fig12 {r['kind']} {r['family']} {r['codec']}: wire {r['wire_bytes_per_round']} x"
              f"{r['bytes_reduction_vs_fp32']}, the JAX records' {j['wire_bytes_per_round']} "
              f"x{j['bytes_reduction_vs_fp32']}")
    print(f"  fig12: {len(fig12_out['records'])} records, wire bytes and reductions the JAX records' codec by codec; "
          f"{rows_b.get('fig12.acceptance', ('', 'no acceptance row'))[1]} (not gated: the torch draws differ)")
    for r in fig12_out["records"]:
        print(f"    {r['kind']:11s} {r['family']:8s} {r['codec']:5s} final test loss {r['final_test_loss']:.4f} "
              f"(the JAX record's {jax_records[(r['kind'], r['family'], r['codec'])]['final_test_loss']:.4f}), "
              f"delta {r['loss_delta_vs_fp32_pct']:+.2f}%, {r['us_per_round_steady']:.0f} µs a round")
    for name in ("kernels.mix", "kernels.flash", "kernels.flash_swa", "kernels.rwkv6"):
        fields = dict(item.split("=") for item in rows_b[name][1].split(";"))
        err, scale = float(fields["max_abs_err"]), float(fields["ref_scale"])
        tol = 5e-5 * scale if name == "kernels.rwkv6" else FP32_TOL * max(scale, 1.0)
        print(f"  {name}: {rows_b[name][0]:.1f} µs, route {fields['route']}, max_abs_err {err:.3e} tol {tol:.3e}")
        check(err <= tol, f"{name}: error {err} above phase 3's tolerance {tol}")

    # (c) run_mixing at its defaults: the three backends over ring / kreg /
    # ba / heavytail at n = 16 … 1024, d = 4096
    t0 = time.perf_counter()
    mixing = kernels_bench.run_mixing(out_path=ROOT / "build" / "kernels_mixing.json")
    print(f"  run_mixing: {len(mixing['records'])} rows in {time.perf_counter() - t0:.1f} s")
    for r in mixing["records"]:
        print(f"    {r['family']:9s} n={r['n']:5d} dense {r['us_dense']:9.1f} µs sparse {r['us_sparse']:9.1f} µs "
              f"ppermute {r['us_ppermute']:9.1f} µs")
    check(len(mixing["records"]) == 16 and all(math.isfinite(r[f"us_{b}"]) for r in mixing["records"]
                                               for b in ("dense", "sparse", "ppermute")), "run_mixing rows")
    print(f"  phase 4k: {time.perf_counter() - t_4k:.1f} s")
    torch.cuda.empty_cache()

    # ------------------------------- 4l. RWKV training, mamba and frontend configs
    phase("4l. --model rwkv and --arch jamba-1.5-large-398b / rwkv6-3b / llava-next-mistral-7b --reduced on the card")
    t_4l = time.perf_counter()
    # (a) each run on the card, counted: the recorded forwards reach no
    # kernel (a recorded call would raise in the wrapper, and the counts
    # show none), one DecAvg launch a round at a width phase 3 checked, and
    # --model rwkv's evals through the rwkv kernel, a layer a node an eval,
    # at a key phase 3 checked
    rwkv_4l, mix_4l = set(), set()
    real_rwkv_4l, real_mm_4l = rwkv_ops.rwkv6_chunked, mix_ops.mix_matmul

    def recording_rwkv_4l(r, k, v, w, u, state=None):
        rwkv_4l.add(rwkv_key(r, state))
        return real_rwkv_4l(r, k, v, w, u, state)

    def recording_mm_4l(m, w):
        mix_4l.add(tuple(w.shape))
        return real_mm_4l(m, w)

    runs_4l = {
        "--model rwkv": ["--model", "rwkv", "--items-per-node", "64"],
        "--arch jamba": ["--arch", "jamba-1.5-large-398b", "--reduced"],
        "--arch rwkv6-3b": ["--arch", "rwkv6-3b", "--reduced"],
        "--arch llava": ["--arch", "llava-next-mistral-7b", "--reduced"],
    }
    common_4l = ["--nodes", "8", "--rounds", "3", "--local-batches", "1"]
    zoo_launches = dict(none_launched)
    rwkv_eval_launches = 0
    rwkv_ops.rwkv6_chunked, mix_ops.mix_matmul = recording_rwkv_4l, recording_mm_4l
    try:
        for label, argv in runs_4l.items():
            hist_l, wall_l, launches_l = counted(lambda: cli.main([*argv, *common_4l]))
            n_eval = len(hist_l["test_loss"])
            want_l = {**none_launched, "mix_matmul": 3,
                      "rwkv6_chunked": n_eval * 8 * get_reduced_config("rwkv6-3b").n_layers if "--model" in argv else 0}
            print(f"  {label}: {wall_l:.1f} s; launches { {k: v for k, v in launches_l.items() if v} }; train "
                  f"{[round(x, 4) for x in hist_l['train_loss']]} test {[round(x, 4) for x in hist_l['test_loss']]}")
            check(launches_l == want_l, f"4l {label}: launches {launches_l}, want {want_l}")
            check(all(math.isfinite(x) for x in hist_l["train_loss"] + hist_l["test_loss"]), f"4l {label}: loss")
            check(("--model" in argv) == (n_eval == 3), f"4l {label}: {n_eval} evals")
            zoo_launches = {k: zoo_launches[k] + launches_l[k] for k in zoo_launches}
            rwkv_eval_launches += launches_l["rwkv6_chunked"]
    finally:
        rwkv_ops.rwkv6_chunked, mix_ops.mix_matmul = real_rwkv_4l, real_mm_4l
    print(f"  mix shapes {sorted(mix_4l)}, rwkv shapes {sorted(rwkv_4l, key=str)}")
    check(mix_4l == {(8, d) for d in D_ZOO.values()}, f"4l mixed at {sorted(mix_4l)}, phase 3 checked "
          f"{sorted((8, d) for d in D_ZOO.values())}")
    check(bool(rwkv_4l) and rwkv_4l <= rwkv_checked,
          f"4l launched rwkv at {sorted(rwkv_4l - rwkv_checked, key=str)}, not checked in phase 3")
    # (b) card against CPU, both from one init drawn on the CPU and moved
    # (the CLI draws on the run's device): the train and test losses to
    # rtol 1e-4 (the card's fp32 sums in other orders, its fp32 rwkv evals
    # on the TF32-split route)
    real_init_4l = cli.init_fl_state

    def cpu_init_4l(seed, n, init_one, opt, gains=None, device=None):
        s_cpu = real_init_4l(seed, n, init_one, opt, gains=gains, device="cpu")
        return DFLState(params=s_cpu.params.to(device), opt_state=type(s_cpu.opt_state)(
            *(f.to(device) for f in s_cpu.opt_state)), layout=s_cpu.layout, round=0, generator=s_cpu.generator)

    cli.init_fl_state = cpu_init_4l
    try:
        for label, argv in runs_4l.items():
            h_c = cli.main([*argv, *common_4l, "--device", "cpu"])
            h_g = cli.main([*argv, *common_4l, "--device", "cuda"])
            rel = max((abs(a - b) / abs(b) for key in ("train_loss", "test_loss") for a, b in zip(h_g[key], h_c[key])),
                      default=0.0)
            print(f"  {label} card vs CPU (one CPU init, 3 rounds): largest relative loss difference {rel:.2e}")
            check(all(np.allclose(h_g[key], h_c[key], rtol=1e-4, atol=1e-5) for key in ("train_loss", "test_loss"))
                  and len(h_g["train_loss"]) == 3, f"4l {label} card vs CPU: losses {rel:.2e}")
    finally:
        cli.init_fl_state = real_init_4l
    print(f"  phase 4l: {time.perf_counter() - t_4l:.1f} s")
    torch.cuda.empty_cache()

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

    # the same run with int8 gossip (chunk 2048, the MLP's 281-chunk table).
    # A new mirror is x − h through a rounding, so an ulp of summation-order
    # drift (cuBLAS against the CPU) can flip a code where x/scale lies within
    # an ulp of a half-integer.  Elements beyond the tolerance are counted, and
    # each must lie within one code step: the largest scale of its chunk over
    # rows and rounds, recorded on the CPU.  Each round's scales are the ones
    # the dense round returns (it computes them in its one launch).
    comp8 = Compression("int8")
    results = {}
    for d_name in ("cuda", "cpu"):
        recorded = []

        def recording_round(*args, **kw):
            out, scales = quant_mix_dense(*args, **kw)
            recorded.append(scales)
            return out, scales

        mix_ops.quant_mix_dense = recording_round
        st = state_from_numpy(params_np, optimizer=opt, device=d_name)
        rf = make_round_fn(loss_fn, opt, g8, device=d_name, compression=comp8)
        st, h = run_trajectory(
            st, rf, xs8, ys8, sched8, n_rounds=r8, eval_every=1, eval_fn=eval_fn,
            eval_batch=(ds8.x[-256:], ds8.y[-256:]), track_sigmas=True, b_local=b8, device=d_name,
        )
        mix_ops.quant_mix_dense = quant_mix_dense
        check(len(recorded) == r8, f"{d_name}: {len(recorded)} dense rounds' scales in {r8} compressed rounds")
        results[d_name] = (h, st, torch.stack(recorded).cpu())
    (h_gpu, st_gpu, _), (h_cpu, st_cpu, scales_cpu) = results["cuda"], results["cpu"]
    for key in ("train_loss", "test_loss", "sigma_ap", "sigma_an"):
        a, b = np.asarray(h_gpu[key]), np.asarray(h_cpu[key])
        print(f"  int8 {key:10s} max abs diff {float(np.max(np.abs(a - b))):.2e}")
        check(np.allclose(a, b, rtol=1e-4, atol=1e-5), f"card vs CPU, int8, {key}")
    widths = chunk_bounds(st_cpu.layout.sizes, comp8.chunk)
    step = scales_cpu.amax(dim=(0, 1))[torch.repeat_interleave(torch.arange(widths.numel() - 1),
                                                               widths[1:] - widths[:-1])].numpy()
    flips = {}
    for what in ("params", "residual"):
        got, want = getattr(st_gpu, what).cpu().numpy(), getattr(st_cpu, what).numpy()
        off = np.abs(got - want) > 1e-5 + 1e-4 * np.abs(want)
        within = np.abs(got - want) <= 1.01 * np.broadcast_to(step, want.shape) + 1e-5
        flips[what] = int(off.sum())
        print(f"  int8 final {what}: max abs diff {float(np.abs(got - want).max()):.2e}; {flips[what]} of "
              f"{want.size} elements beyond rtol 1e-4 / atol 1e-5 (quantisation-code flips), "
              f"{int((off & ~within).sum())} of them beyond one code step")
        check(bool(np.all(within[off])), f"card vs CPU, int8 {what}: a difference beyond one code step")
        check(flips[what] <= 1e-3 * want.size, f"card vs CPU, int8 {what}: {flips[what]} code flips")

    # the paper CNN (cfg B, d = 198,897) from one numpy He init, complete-8, 3
    # rounds on each device: grouped cuDNN convolutions (deterministic
    # algorithms, fp32, no TF32) against the CPU's.  History to rtol 1e-4 /
    # atol 1e-5, each parameter leaf to rtol 1e-4 / atol 1e-5 · max|leaf|, the
    # CPU tests' CNN trajectory bounds (tests/test_torch_paper_train.py).  Gain
    # 1: at the corrected gain the CNN's first losses are in the tens and
    # softmax saturation amplifies summation-order differences (as there).
    cnn_np = params_to_numpy(init_cnn(InitConfig("he_normal", torch.ones(n8)), torch.Generator().manual_seed(6)))
    ds_c = so2sat_like(n8 * per8 + 256, seed=1)
    xs_c, ys_c = node_datasets(ds_c, [np.arange(i * per8, (i + 1) * per8) for i in range(n8)])

    def loss_c(p, b):
        return classifier_loss(cnn_forward(p, b[0]), b[1])

    results = {}
    for d_name in ("cuda", "cpu"):
        st = state_from_numpy(cnn_np, optimizer=opt, device=d_name)
        rf = make_round_fn(loss_c, opt, g8, device=d_name)
        st, h = run_trajectory(
            st, rf, xs_c, ys_c, sched8, n_rounds=r8, eval_every=1, eval_fn=make_eval_fn(loss_c),
            eval_batch=(ds_c.x[-256:], ds_c.y[-256:]), track_sigmas=True, b_local=b8, device=d_name,
        )
        results[d_name] = (h, to_numpy(st)[0])
    (h_gpu, p_gpu), (h_cpu, p_cpu) = results["cuda"], results["cpu"]
    for key in ("train_loss", "test_loss", "sigma_ap", "sigma_an"):
        a, b = np.asarray(h_gpu[key]), np.asarray(h_cpu[key])
        print(f"  CNN {key:10s} cuda {np.array2string(a, precision=6)} cpu {np.array2string(b, precision=6)} "
              f"max abs diff {float(np.max(np.abs(a - b))):.2e}")
        check(np.allclose(a, b, rtol=1e-4, atol=1e-5), f"card vs CPU, CNN, {key}")
    worst = 0.0
    for layer in p_cpu:
        for leaf in ("w", "b"):
            got, want = p_gpu[layer][leaf], p_cpu[layer][leaf]
            scale = float(np.abs(want).max())
            worst = max(worst, float(np.max(np.abs(got - want) / (1e-5 * scale + 1e-4 * np.abs(want)))))
    print(f"  CNN final params: worst err / (1e-5·max|leaf| + 1e-4·|p|) {worst:.3f}")
    check(worst <= 1.0, "card vs CPU, CNN final params")

    # ------------------------------------------------------- 6. CLI, sparse
    phase("6. CLI: ring-1024, sparse backend")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = cli.main([
        "--model", "mlp", "--topology", "ring", "--nodes", "1024", "--rounds", "3",
        "--local-batches", "2", "--no-gain-correction",
    ])
    torch.cuda.synchronize()
    cli_launches = {kern.__name__: kern.launches for kern in kernels}
    print(f"  {time.perf_counter() - t0:.1f} s incl. data generation; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {cli_launches}")
    check(all(math.isfinite(v) for k in ("train_loss", "test_loss", "sigma_ap", "sigma_an") for v in hist[k]),
          "CLI history not finite")
    check(len(hist["round"]) == 3, "CLI recorded rounds")
    check(cli_launches == {**none_launched, "mix_bsr": 3},
          f"CLI launch counts {cli_launches}")

    # the same CLI with int8 gossip: every round one scales pass and one
    # quantised block-sparse walk, no plain block-sparse launch
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = cli.main([
        "--model", "mlp", "--topology", "ring", "--nodes", "1024", "--rounds", "3",
        "--local-batches", "2", "--no-gain-correction", "--compress", "int8",
    ])
    torch.cuda.synchronize()
    cli_c_launches = {kern.__name__: kern.launches for kern in kernels}
    print(f"  --compress int8: {time.perf_counter() - t0:.1f} s incl. data generation; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          + str({k: v for k, v in cli_c_launches.items() if v}))
    check(all(math.isfinite(v) for k in ("train_loss", "test_loss", "sigma_ap", "sigma_an") for v in hist[k]),
          "compressed CLI history not finite")
    check(len(hist["round"]) == 3, "compressed CLI recorded rounds")
    check(cli_c_launches == {**none_launched, "quant_scales": 3, "quant_mix_bsr": 3},
          f"compressed CLI launch counts {cli_c_launches}")
    torch.cuda.empty_cache()

    # --------------------- 6b. the node-sharded rendering at one NCCL rank
    phase("6b. node-sharded rendering at one NCCL rank: run_sharded_trajectory, gossip, fig10 quick")
    import torch.distributed as dist

    from repro_torch.benchmarks import fig10_scaling
    from repro_torch.fed import run_sharded_trajectory
    from repro_torch.launch.mesh import node_group

    t_6b = time.perf_counter()
    node_group(1, device=dev)  # world size 1 through a real NCCL group
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "6b: not a world-size-1 NCCL group")
    ring_n, ring_per, ring_rounds = 1024, 16, 3
    ring_ds = mnist_like(ring_n * ring_per + 256, seed=0)
    ring_xs, ring_ys = node_datasets(ring_ds, [np.arange(i * ring_per, (i + 1) * ring_per) for i in range(ring_n)])
    ring_sched = batch_index_schedule(ring_per, ring_n, 8, ring_rounds * 2, seed=0)
    mlp_loss = lambda p, b: classifier_loss(mlp_forward(p, b[0]), b[1])  # noqa: E731
    ring_state = init_fl_state(0, ring_n, lambda g, gains: init_mlp(InitConfig("he_normal", gains), g), sgd(1e-3, 0.5),
                               device=dev)
    # (a) the quickstart's complete-16 (dense, kernel 1) and the CLI's
    # ring-1024 (sparse, kernel 2), clean and with a failure model: the
    # sharded trajectory at one rank against the unsharded one, the same
    # inputs and generator seed: params and losses bit for bit
    shard_launches, shard_rounds = {}, {}
    for label, g_6b, backend, st, xs_6b, ys_6b, sched_6b, rounds, b_6b, loss_6b, opt_6b, ev_6b, test_6b in (
        ("complete-16", graph, "dense", states[1], xs, ys, schedule[: 5 * B_LOCAL], 5, B_LOCAL, loss_fn, opt,
         eval_fn, test),
        ("ring-1024", T.ring(ring_n), "sparse", ring_state, ring_xs, ring_ys, ring_sched, ring_rounds, 2, mlp_loss,
         sgd(1e-3, 0.5), make_eval_fn(mlp_loss), (ring_ds.x[-256:], ring_ds.y[-256:])),
    ):
        for fm in (FailureModel(), FailureModel(link_p=0.8)):
            tag = f"{label} {'link_p 0.8' if fm.active else 'clean'}"
            plan_6b = compile_plan(g_6b, backend, failures=fm, device=dev)
            common_6b = dict(n_rounds=rounds, eval_every=rounds - 1, eval_fn=ev_6b, eval_batch=test_6b, b_local=b_6b)
            fin_u, h_u = run_trajectory(st, make_round_fn(loss_6b, opt_6b, plan_6b), xs_6b, ys_6b, sched_6b,
                                        device=dev, **common_6b)
            sp_6b = plan_6b.shard(n_shards=1)
            reset_counts()
            fin_s, h_s = run_sharded_trajectory(st, loss_6b, opt_6b, sp_6b, xs_6b, ys_6b, sched_6b, **common_6b)
            launched = {kern.__name__: kern.launches for kern in kernels}
            kern_6b = "mix_matmul" if backend == "dense" else "mix_bsr"
            shard_launches[kern_6b] = shard_launches.get(kern_6b, 0) + launched[kern_6b]
            check(launched == {**none_launched, kern_6b: rounds}, f"6b {tag}: launches {launched}")
            same = bool(torch.equal(fin_s.params, fin_u.params))
            check(same and all(h_s[k] == h_u[k] for k in ("round", "train_loss", "test_loss")),
                  f"6b {tag}: sharded at one rank not bitwise the unsharded run (params {same})")
            check(h_s["wire_bytes"] == [0] * len(h_s["round"]) and h_s["wire_collectives"][0] == 0,
                  f"6b {tag}: wire constants {h_s['wire_bytes']}")
            # what the group and the layout cost at one rank: whole runs as
            # the caller pays (host clock after a sync), both paths warm
            # (each ran once above), in turns u s s u u s, the median of
            # three each; then one mix alone
            def run_6b(sharded: bool) -> float:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if sharded:
                    run_sharded_trajectory(st, loss_6b, opt_6b, sp_6b, xs_6b, ys_6b, sched_6b, **common_6b)
                else:
                    run_trajectory(st, make_round_fn(loss_6b, opt_6b, plan_6b), xs_6b, ys_6b, sched_6b, device=dev,
                                   **common_6b)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) / rounds * 1e3

            walls_6b = {False: [], True: []}
            for sharded in (False, True, True, False, False, True):
                walls_6b[sharded].append(run_6b(sharded))
            round_u, round_s = (sorted(walls_6b[k])[1] for k in (False, True))
            w_6b = fin_u.params
            gen_6b = (lambda: torch.Generator().manual_seed(1)) if fm.active else (lambda: None)  # noqa: E731
            mix_u = time_ms(lambda: plan_6b.mix(w_6b, gen_6b()), flush=flush)
            mix_s = time_ms(lambda: sp_6b.local_mix(w_6b, gen_6b()), flush=flush)
            shard_rounds[tag] = dict(round_ms_unsharded=round_u, round_ms_sharded=round_s, mix_ms_unsharded=mix_u,
                                     mix_ms_sharded=mix_s, round_ms_turns=walls_6b)
            print(f"  {tag}: {rounds} rounds, sharded at one NCCL rank bitwise the unsharded run (params, "
                  f"train / test loss); a round {round_s:.2f} ms sharded vs {round_u:.2f} ms unsharded (eval rounds "
                  f"included, both warm, median of 3 in turns; sharded {[f'{v:.2f}' for v in walls_6b[True]]}, "
                  f"unsharded {[f'{v:.2f}' for v in walls_6b[False]]}); one mix {mix_s:.4f} ms vs {mix_u:.4f} ms; "
                  f"launches {kern_6b} {launched[kern_6b]}")
            del fin_u, fin_s, w_6b
            torch.cuda.empty_cache()
    del ring_state
    # (c) gossip over the sharded plan: the estimator's gains bitwise the
    # unsharded plan's, its spread rounds on kernel 2 over Mᵀ
    plan_g = compile_plan(T.ring(ring_n), "sparse", failures=FailureModel(link_p=0.8), device=dev)
    sp_g = plan_g.shard(n_shards=1)
    check(G.as_plan(sp_g) is sp_g, "6b: as_plan re-made a sharded plan without data sizes")
    reset_counts()
    gains_u = G.make_gain_estimator(plan_g, pi_rounds=16, ps_rounds=16)(3)
    gossip_u = mix_bsr.launches
    reset_counts()
    gains_s = G.make_gain_estimator(sp_g, pi_rounds=16, ps_rounds=16)(3)
    gossip_s = {kern.__name__: kern.launches for kern in kernels}
    check(bool(torch.equal(gains_s, gains_u)), "6b: sharded gossip gains not bitwise the unsharded")
    check(gossip_s == {**none_launched, "mix_bsr": gossip_u} and gossip_u == 32, f"6b gossip launches {gossip_s}")
    print(f"  gossip over the sharded ring-1024 (link_p 0.8, 16 + 16 rounds): gains bitwise the unsharded "
          f"estimator's, mean {float(gains_s.mean()):.4f}; launches mix_bsr {gossip_s['mix_bsr']}")
    # (d) fig10 quick at one shard on the card
    doc10 = fig10_scaling.run(quick=True, device=dev, shards=(1,))
    check(all(r["parity_bitexact"] and r["collective_backend"] == "nccl" for r in doc10["records"]),
          f"6b fig10: {doc10['records']}")
    print("  fig10 quick S=1 on the card: " + ", ".join(
        f"{r['family']} {r['us_per_round_serialized']:.1f} µs a round" for r in doc10["records"]))
    # a point with more ranks than cards raises: no gloo point in a cuda document
    if torch.cuda.device_count() < 2:
        try:
            fig10_scaling.run(quick=True, device=dev, shards=(1, 2))
            check(False, "6b fig10: S = 2 on one card did not raise")
        except ValueError as exc:
            print(f"  fig10 S = 2 on one card raises: {exc}")
    print(f"  phase 6b in {time.perf_counter() - t_6b:.1f} s")
    dist.destroy_process_group()

    # ------------------------------------------------- 7. serve, full width
    phase("7. serve, full width: qwen2.5-3b 4-node ring ensemble, gemma3-4b, rwkv6-3b 4-node ensemble (bf16)")

    def since(t0: float) -> float:
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def leaves(tree) -> list:
        out = []
        tree_map(out.append, tree)
        return out

    def n_elements(tree) -> int:
        return sum(t.numel() for t in leaves(tree))

    def tokens(n_prompts, length, vocab, seed):
        stream = make_token_stream(n_prompts * length, vocab, seed=seed)
        return torch.as_tensor(stream.reshape(n_prompts, length), device=dev)

    # the decoder reaches the kernel through flash_attention: record the key
    # of every launch it makes, to hold against the shapes phase 3 checked
    flash_launched = set()

    def recording_flash_mha(q, k, v, *, causal=True, window=0):
        flash_launched.add(flash_key(q, k, causal, window))
        return flash_mha(q, k, v, causal=causal, window=window)

    flash_ops.flash_mha = recording_flash_mha
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen_p = torch.Generator(device=dev).manual_seed(0)
    ring4 = T.ring(4)
    t0 = time.perf_counter()
    ens = TF.init_params(gen_p, qcfg, InitConfig("trunc_normal", torch.full((4,), gain_from_graph(ring4))), device=dev)
    init_s = since(t0)
    n_el = n_elements(ens)
    print(f"  qwen2.5-3b: 4 nodes × {n_el // 4:,} bf16 parameters (ring-4 gain {gain_from_graph(ring4):.2f}), "
          f"drawn in {init_s:.1f} s")
    check(n_el == 4 * (qcfg.n_params() + qcfg.d_model), f"ensemble holds {n_el} parameters")
    t0 = time.perf_counter()
    cons = consensus_params(ens)
    cons_s = since(t0)
    engine = ServeEngine(qcfg, cache_len=4096, device=dev)
    prompts = tokens(4, 2048, qcfg.vocab_size, seed=0)
    t0 = time.perf_counter()
    toks = engine.generate(cons, prompts, 32)
    gen_s = since(t0)
    t0 = time.perf_counter()
    logits = prefill(cons, qcfg, prompts)
    pre_s = since(t0)
    check(toks.shape == (4, 32) and int(toks.min()) >= 0 and int(toks.max()) < qcfg.vocab_size, "qwen tokens")
    check(bool(torch.isfinite(logits).all()), "qwen prefill logits not finite")
    check(torch.equal(logits.argmax(-1).to(toks.dtype), toks[:, 0]), "prefill argmax differs from generate's first token")
    # one decode step timed on its own: 8 steps against a 4096-slot cache
    cache = TF.init_cache(qcfg, (4,), 4096, device=dev)
    step_tok = toks[:, :1]
    decode_one(cons, qcfg, cache, step_tok, 2048)
    t0 = time.perf_counter()
    for i in range(8):
        step_logits, cache = decode_one(cons, qcfg, cache, step_tok, 2049 + i)
    dec_ms = since(t0) / 8 * 1e3
    check(bool(torch.isfinite(step_logits).all()), "qwen decode logits not finite")
    # the same step captured once as a CUDA graph and replayed: the device's
    # time for it with no host dispatch between its kernels (the replays
    # rewrite one cache slot with the same values)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager_logits = decode_one(cons, qcfg, cache, step_tok, 2057)[0]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graph_logits = decode_one(cons, qcfg, cache, step_tok, 2057)[0]
    graph_ms = time_ms(graph.replay)
    graph_err = float((graph_logits.float() - eager_logits.float()).abs().max())
    check(graph_err <= 1e-2 * float(eager_logits.float().abs().max()), f"graph-replayed decode differs by {graph_err}")
    del cache, graph, graph_logits, eager_logits
    t0 = time.perf_counter()
    served = engine.serve(ens, [0, 1, 2, 3], tokens(4, 512, qcfg.vocab_size, seed=1), 8)
    serve_s = since(t0)
    check(served.shape == (4, 8) and int(served.min()) >= 0 and int(served.max()) < qcfg.vocab_size,
          "qwen served tokens")
    qwen_flash = flash_mha.launches
    qwen_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  consensus in {cons_s:.2f} s; generate 4 × 2048 → 32 tokens in {gen_s:.2f} s; prefill 4 × 2048 "
          f"{pre_s * 1e3:.1f} ms; decode {dec_ms:.2f} ms per step (4 sequences), {graph_ms:.2f} ms as a "
          f"replayed CUDA graph (device busy {graph_ms / dec_ms:.1%} of an eager step); serve 4 nodes × 512 → 8 "
          f"in {serve_s:.2f} s; peak device memory {qwen_peak:.2f} GiB")
    print(f"  first tokens {toks[:, :6].tolist()}; node answers {served[:, :4].tolist()}")
    # every layer attends: one flash launch per layer per prefill (36 for qwen2.5-3b), 6 prefills
    check(qwen_flash == qcfg.n_layers * (1 + 4 + 1), f"qwen flash launches {qwen_flash}, want 6 × {qcfg.n_layers}")
    del ens, cons, logits, step_logits
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    gparams = TF.init_params(gen_p, gcfg, InitConfig("trunc_normal", 1.0), device=dev)
    init_s = since(t0)
    check(n_elements(gparams) == gcfg.n_params() + gcfg.d_model, "gemma parameter count")
    g_prompts = tokens(2, 2048, gcfg.vocab_size, seed=2)
    t0 = time.perf_counter()
    g_toks = ServeEngine(gcfg, cache_len=4096, device=dev).generate(gparams, g_prompts, 16)
    gen_s = since(t0)
    t0 = time.perf_counter()
    g_logits = prefill(gparams, gcfg, g_prompts)
    pre_s = since(t0)
    check(g_toks.shape == (2, 16) and int(g_toks.min()) >= 0 and int(g_toks.max()) < gcfg.vocab_size,
          "gemma tokens")
    check(bool(torch.isfinite(g_logits).all()), "gemma prefill logits not finite")
    check(torch.equal(g_logits.argmax(-1).to(g_toks.dtype), g_toks[:, 0]), "gemma prefill argmax differs")
    print(f"  gemma3-4b: {gcfg.n_params():,} parameters drawn in {init_s:.1f} s; generate 2 × 2048 (window "
          f"{gcfg.sliding_window}) → 16 tokens in {gen_s:.2f} s; prefill {pre_s * 1e3:.1f} ms; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    serve_launches = {kern.__name__: kern.launches for kern in kernels}
    print(f"  launches {serve_launches}")
    check(serve_launches == {**none_launched, "flash_mha": qwen_flash + 2 * gcfg.n_layers},
          f"serve launch counts {serve_launches}, want 2 gemma prefills × {gcfg.n_layers} more")
    # bf16 at hd 128 and 256: every prefill launch took the wgmma route
    check(flash_mha.launches_by_route == {"wgmma": serve_launches["flash_mha"], "wgmma_tf32x3": 0},
          f"flash routes {flash_mha.launches_by_route}, want every launch on wgmma")
    print(f"  flash routes {flash_mha.launches_by_route}")
    flash_ops.flash_mha = flash_mha
    check(flash_launched <= flash_checked,
          f"phase 7 launched flash at {sorted(flash_launched - flash_checked, key=str)}, not checked in phase 3")
    print(f"  flash launch shapes: {len(flash_launched)} distinct, each held against the plain version in phase 3")
    del gparams, g_logits
    torch.cuda.empty_cache()

    # rwkv6-3b: attention-free, an O(1) recurrent state instead of a KV
    # cache.  The decoder reaches the kernel through rwkv6_attention: record
    # the key of every launch, to hold against the shapes phase 3 checked.
    rwkv_launched = set()

    def recording_rwkv6_chunked(r, k, v, w, u, state=None):
        rwkv_launched.add(rwkv_key(r, state))
        return rwkv6_chunked(r, k, v, w, u, state)

    rwkv_ops.rwkv6_chunked = recording_rwkv6_chunked
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ens = TF.init_params(gen_p, rcfg, InitConfig("trunc_normal", torch.full((4,), gain_from_graph(ring4))), device=dev)
    init_s = since(t0)
    n_el = n_elements(ens)
    # the JAX package's tree holds 3,089,290,240 elements (jax.eval_shape of
    # its init_params; tests/test_torch_rwkv.py); n_params() counts fewer
    print(f"  rwkv6-3b: 4 nodes × {n_el // 4:,} parameters (bf16, decay base / bonus / output norm fp32), "
          f"drawn in {init_s:.1f} s")
    check(n_el == 4 * 3_089_290_240, f"rwkv ensemble holds {n_el} parameters")
    t0 = time.perf_counter()
    cons = consensus_params(ens)
    cons_s = since(t0)
    check(cons["stack"][0]["rwkv"]["tmix"]["decay_base"].dtype == torch.float32, "consensus changed an fp32 leaf")
    r_engine = ServeEngine(rcfg, cache_len=4096, device=dev)  # the rwkv cache ignores cache_len
    prompts = tokens(4, 2048, rcfg.vocab_size, seed=3)
    t0 = time.perf_counter()
    toks = r_engine.generate(cons, prompts, 32)
    gen_s = since(t0)
    t0 = time.perf_counter()
    logits = prefill(cons, rcfg, prompts)
    pre_s = since(t0)
    check(toks.shape == (4, 32) and int(toks.min()) >= 0 and int(toks.max()) < rcfg.vocab_size, "rwkv tokens")
    check(bool(torch.isfinite(logits).all()), "rwkv prefill logits not finite")
    check(torch.equal(logits.argmax(-1).to(toks.dtype), toks[:, 0]), "rwkv prefill argmax differs from generate's")
    long_prompt = tokens(1, 16384, rcfg.vocab_size, seed=4)
    t0 = time.perf_counter()
    long_logits = prefill(cons, rcfg, long_prompt)
    long_s = since(t0)
    check(bool(torch.isfinite(long_logits).all()), "rwkv long-prompt logits not finite")
    # decode: 8 eager steps from a zeroed state, then one step captured as a
    # CUDA graph.  The step updates the state in place, so the replays
    # advance it: the comparison restores the state, replays once and holds
    # the logits against one eager step from the same state.
    cache = TF.init_cache(rcfg, (4,), 0, device=dev)
    step_tok = toks[:, :1]
    decode_one(cons, rcfg, cache, step_tok, 0)
    t0 = time.perf_counter()
    for i in range(8):
        step_logits, cache = decode_one(cons, rcfg, cache, step_tok, 1 + i)
    r_dec_ms = since(t0) / 8 * 1e3
    check(bool(torch.isfinite(step_logits).all()), "rwkv decode logits not finite")
    snapshot = tree_map(torch.clone, cache)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager_logits = decode_one(cons, rcfg, cache, step_tok, 9)[0].clone()
    torch.cuda.current_stream().wait_stream(side)
    for dst, src_t in zip(leaves(cache), leaves(snapshot)):
        dst.copy_(src_t)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graph_logits = decode_one(cons, rcfg, cache, step_tok, 9)[0]
    r_graph_ms = time_ms(graph.replay)
    for dst, src_t in zip(leaves(cache), leaves(snapshot)):
        dst.copy_(src_t)
    graph.replay()
    torch.cuda.synchronize()
    # same state, same inputs, same plain-torch ops: the replay must give
    # the eager step's bits
    graph_err = float((graph_logits.float() - eager_logits.float()).abs().max())
    check(torch.equal(graph_logits, eager_logits), f"rwkv graph-replayed decode differs by {graph_err}")
    del cache, snapshot, graph, graph_logits, eager_logits
    t0 = time.perf_counter()
    served = r_engine.serve(ens, [0, 1, 2, 3], tokens(4, 512, rcfg.vocab_size, seed=5), 8)
    serve_s = since(t0)
    check(served.shape == (4, 8) and int(served.min()) >= 0 and int(served.max()) < rcfg.vocab_size,
          "rwkv served tokens")
    rwkv_ops.rwkv6_chunked = rwkv6_chunked
    rwkv_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  consensus in {cons_s:.2f} s; generate 4 × 2048 → 32 tokens in {gen_s:.2f} s; prefill 4 × 2048 "
          f"{pre_s * 1e3:.1f} ms; prefill 1 × 16384 {long_s * 1e3:.1f} ms; decode {r_dec_ms:.2f} ms per step "
          f"(4 sequences), {r_graph_ms:.2f} ms as a replayed CUDA graph (device busy {r_graph_ms / r_dec_ms:.1%} "
          f"of an eager step; replay bitwise the eager step); serve 4 nodes × 512 → 8 in {serve_s:.2f} s; "
          f"peak device memory {rwkv_peak:.2f} GiB")
    print(f"  first tokens {toks[:, :6].tolist()}; node answers {served[:, :4].tolist()}")
    serve_launches = {kern.__name__: kern.launches for kern in kernels}
    print(f"  launches {serve_launches}")
    # one rwkv launch per layer per prefill: generate, prefill, the long
    # prompt and 4 node answers; no attention layer
    check(serve_launches == {**none_launched, "flash_mha": qwen_flash + 2 * gcfg.n_layers,
                             "rwkv6_chunked": 7 * rcfg.n_layers},
          f"serve launch counts {serve_launches}, want 7 rwkv prefills × {rcfg.n_layers}")
    # bf16: every full-width rwkv launch took the tc route
    check(rwkv6_chunked.launches_by_route == {"tc": 7 * rcfg.n_layers, "tc_fp32": 0},
          f"rwkv routes {rwkv6_chunked.launches_by_route}, want every launch on tc")
    print(f"  rwkv routes {rwkv6_chunked.launches_by_route}")
    check(rwkv_launched <= rwkv_checked,
          f"phase 7 launched rwkv at {sorted(rwkv_launched - rwkv_checked, key=str)}, not checked in phase 3")
    print(f"  rwkv launch shapes: {len(rwkv_launched)} distinct, each held against the plain version in phase 3")
    del ens, cons, logits, long_logits, step_logits
    torch.cuda.empty_cache()

    # ----------------------------------------------- 7b. traced prefills
    # in a process of its own: late in this long process the profiler lost
    # a whole layer's device events (every kernel of it, ours and cuBLAS's)
    # from every trace of these prefills, retried or not, while the early
    # traces of phase 3 were complete; a fresh process traces from a clean
    # profiler state
    phase("7b. traced prefills: qwen2.5-3b and rwkv6-3b 4 × 2048 under torch.profiler, in a child process")
    t0 = time.perf_counter()
    run_7b = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--traced-prefills"], cwd=ROOT,
                            capture_output=True, text=True, timeout=600)
    print(run_7b.stdout.rstrip(), flush=True)
    print(f"  phase 7b (child): exit {run_7b.returncode} in {time.perf_counter() - t0:.1f} s")
    check(run_7b.returncode == 0, f"traced prefills exit {run_7b.returncode}: {run_7b.stderr[-3000:]}")

    # ------------------------------------ 7c. serve, full width: the new configs
    # granite-moe-1b-a400m, qwen1.5-4b, stablelm-12b and the swa variant of
    # qwen2.5-3b (after 7b, whose traces keep the conditions they had), one
    # model at a time, each freed before the next: one flash
    # launch a prefill attention layer, every key among phase 3's, no other
    # listed kernel (the MoE FFN's dispatch and combine are plain torch, as
    # the JAX package's are XLA)
    phase("7c. serve, full width: granite-moe-1b-a400m 4-node ring ensemble, qwen1.5-4b 4-node ensemble, "
          "stablelm-12b, qwen2.5-3b-swa (bf16)")
    flash_launched.clear()
    flash_ops.flash_mha = recording_flash_mha
    new_serve = {}

    def serve_start(name):
        # collect the earlier phases' reference cycles first (a CUDA graph
        # and its outputs among them): when the collector last ran is not
        # this model's peak (two runs of this script on an NVIDIA H100 80GB
        # HBM3 at 700 W read 7c's peaks 8.7 GiB apart, phase 7 the same)
        reset_counts()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        new_serve[name] = {"t0": time.perf_counter()}

    def serve_end(name, want_flash):
        launches_s = {kern.__name__: kern.launches for kern in kernels}
        peak = torch.cuda.max_memory_allocated() / 2**30
        new_serve[name].update(flash=launches_s["flash_mha"], peak_gib=peak, s=time.perf_counter() - new_serve[name]["t0"])
        print(f"  {name}: launches { {k: v for k, v in launches_s.items() if v} }, routes {flash_mha.launches_by_route}; "
              f"peak device memory {peak:.2f} GiB; {new_serve[name]['s']:.1f} s")
        check(launches_s == {**none_launched, "flash_mha": want_flash}
              and flash_mha.launches_by_route == {"wgmma": want_flash, "wgmma_tf32x3": 0},
              f"{name}: launches {launches_s}, routes {flash_mha.launches_by_route}, want {want_flash} flash on wgmma")

    def decode_ms(params, cfg, first_tok, pos, steps=8):
        cache = TF.init_cache(cfg, (first_tok.shape[0],), 4096, device=dev)
        decode_one(params, cfg, cache, first_tok, pos)
        t0 = time.perf_counter()
        for i in range(steps):
            out, cache = decode_one(params, cfg, cache, first_tok, pos + 1 + i)
        check(bool(torch.isfinite(out).all()), f"{cfg.name} decode logits not finite")
        return since(t0) / steps * 1e3, cache

    # granite-moe-1b-a400m: a 4-node ring ensemble (MoE FFN at every layer,
    # 32 experts, top 8); consensus generate 4 × 2048 → 32, per-node serve
    # 4 × 512 → 8, prefill twice (bitwise: the combine adds in a fixed
    # order, no atomics), one decode step eager and replayed as a CUDA graph
    serve_start("granite-moe-1b-a400m")
    t0 = time.perf_counter()
    ens = TF.init_params(gen_p, mcfg, InitConfig("trunc_normal", torch.full((4,), gain_from_graph(ring4))), device=dev)
    init_s = since(t0)
    n_el = n_elements(ens)
    check(n_el == 4 * (mcfg.n_params() + mcfg.d_model), f"granite ensemble holds {n_el} parameters")
    cons = consensus_params(ens)
    m_engine = ServeEngine(mcfg, cache_len=4096, device=dev)
    prompts = tokens(4, 2048, mcfg.vocab_size, seed=6)
    t0 = time.perf_counter()
    toks = m_engine.generate(cons, prompts, 32)
    gen_s = since(t0)
    t0 = time.perf_counter()
    logits = prefill(cons, mcfg, prompts)
    pre_s = since(t0)
    t0 = time.perf_counter()
    logits_again = prefill(cons, mcfg, prompts)
    pre2_s = since(t0)
    check(toks.shape == (4, 32) and int(toks.min()) >= 0 and int(toks.max()) < mcfg.vocab_size, "granite tokens")
    check(bool(torch.isfinite(logits).all()), "granite prefill logits not finite")
    check(torch.equal(logits, logits_again), "two granite prefills differ: the MoE combine is not deterministic")
    check(torch.equal(logits.argmax(-1).to(toks.dtype), toks[:, 0]), "granite prefill argmax differs from generate's")
    m_dec_ms, cache = decode_ms(cons, mcfg, toks[:, :1], 2048)
    step_tok = toks[:, :1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager_logits = decode_one(cons, mcfg, cache, step_tok, 2057)[0]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graph_logits = decode_one(cons, mcfg, cache, step_tok, 2057)[0]
    m_graph_ms = time_ms(graph.replay)
    graph_err = float((graph_logits.float() - eager_logits.float()).abs().max())
    check(graph_err <= 1e-2 * float(eager_logits.float().abs().max()),
          f"granite graph-replayed decode differs by {graph_err}")
    m_graph_bitwise = bool(torch.equal(graph_logits, eager_logits))
    del cache, graph, graph_logits, eager_logits
    t0 = time.perf_counter()
    served = m_engine.serve(ens, [0, 1, 2, 3], tokens(4, 512, mcfg.vocab_size, seed=7), 8)
    serve_s = since(t0)
    check(served.shape == (4, 8) and int(served.min()) >= 0 and int(served.max()) < mcfg.vocab_size,
          "granite served tokens")
    print(f"  granite-moe-1b-a400m: 4 nodes × {n_el // 4:,} bf16 parameters ({mcfg.n_active_params():,} active a "
          f"token), drawn in {init_s:.1f} s; generate 4 × 2048 → 32 tokens in {gen_s:.2f} s; prefill 4 × 2048 "
          f"{pre_s * 1e3:.1f} ms, again {pre2_s * 1e3:.1f} ms (bitwise equal); decode {m_dec_ms:.2f} ms per step "
          f"(4 sequences), {m_graph_ms:.2f} ms as a replayed CUDA graph (device busy {m_graph_ms / m_dec_ms:.1%}; "
          f"bitwise the eager step {m_graph_bitwise}); serve 4 nodes × 512 → 8 in {serve_s:.2f} s")
    print(f"  first tokens {toks[:, :6].tolist()}; node answers {served[:, :4].tolist()}")
    serve_end("granite-moe-1b-a400m", mcfg.n_layers * (1 + 2 + 4))
    new_serve["granite-moe-1b-a400m"].update(prefill_ms=pre2_s * 1e3, decode_ms=m_dec_ms, graph_ms=m_graph_ms)
    del ens, cons, logits, logits_again, toks, served
    torch.cuda.empty_cache()

    # qwen1.5-4b: a 4-node ensemble (MHA 20 / 20, qkv bias): consensus
    # generate 4 × 2048 → 32, a prefill, 8 decode steps
    serve_start("qwen1.5-4b")
    ens = TF.init_params(gen_p, q15cfg, InitConfig("trunc_normal", torch.full((4,), gain_from_graph(ring4))),
                         device=dev)
    n_el = n_elements(ens)
    check(n_el == 4 * (q15cfg.n_params() + q15cfg.d_model), f"qwen1.5 ensemble holds {n_el} parameters")
    cons = consensus_params(ens)  # the ensemble stays beside the consensus and the caches
    prompts = tokens(4, 2048, q15cfg.vocab_size, seed=8)
    t0 = time.perf_counter()
    toks = ServeEngine(q15cfg, cache_len=4096, device=dev).generate(cons, prompts, 32)
    gen_s = since(t0)
    t0 = time.perf_counter()
    logits = prefill(cons, q15cfg, prompts)
    pre_s = since(t0)
    check(bool(torch.isfinite(logits).all()) and torch.equal(logits.argmax(-1).to(toks.dtype), toks[:, 0]),
          "qwen1.5 prefill logits")
    q_dec_ms, cache = decode_ms(cons, q15cfg, toks[:, :1], 2048)
    del cache
    print(f"  qwen1.5-4b: 4 nodes × {n_el // 4:,} bf16 parameters; generate 4 × 2048 → 32 tokens in {gen_s:.2f} s; "
          f"prefill 4 × 2048 {pre_s * 1e3:.1f} ms; decode {q_dec_ms:.2f} ms per step; first tokens "
          f"{toks[:, :6].tolist()}")
    serve_end("qwen1.5-4b", 2 * q15cfg.n_layers)
    new_serve["qwen1.5-4b"].update(prefill_ms=pre_s * 1e3, decode_ms=q_dec_ms)
    del ens, cons, logits, toks
    torch.cuda.empty_cache()

    # stablelm-12b: one parameter set (24.3 GB; four nodes would take ~97
    # GB), layernorm, hd 160 run zero-padded to 256: a prefill 4 × 2048,
    # generate 4 × 2048 → 16, 8 decode steps
    serve_start("stablelm-12b")
    sparams = TF.init_params(gen_p, scfg, InitConfig("trunc_normal", 1.0), device=dev)
    check(n_elements(sparams) == scfg.n_params() + scfg.d_model * (2 + 2 * scfg.n_layers),
          "stablelm parameter count (n_params counts no layernorm bias and no final norm)")
    prompts = tokens(4, 2048, scfg.vocab_size, seed=9)
    t0 = time.perf_counter()
    logits = prefill(sparams, scfg, prompts)
    pre_s = since(t0)
    t0 = time.perf_counter()
    toks = ServeEngine(scfg, cache_len=4096, device=dev).generate(sparams, prompts, 16)
    gen_s = since(t0)
    check(bool(torch.isfinite(logits).all()) and torch.equal(logits.argmax(-1).to(toks.dtype), toks[:, 0]),
          "stablelm prefill logits")
    s_dec_ms, cache = decode_ms(sparams, scfg, toks[:, :1], 2048)
    del cache
    print(f"  stablelm-12b: {n_elements(sparams):,} bf16 parameters; prefill 4 × 2048 {pre_s * 1e3:.1f} ms; generate "
          f"4 × 2048 → 16 tokens in {gen_s:.2f} s; decode {s_dec_ms:.2f} ms per step; first tokens "
          f"{toks[:, :6].tolist()}")
    serve_end("stablelm-12b", 2 * scfg.n_layers)
    new_serve["stablelm-12b"].update(prefill_ms=pre_s * 1e3, decode_ms=s_dec_ms)
    del sparams, logits, toks
    torch.cuda.empty_cache()

    # the swa variant of qwen2.5-3b (every layer windowed at 8192): one
    # prefill of a 16,384-token prompt
    serve_start("qwen2.5-3b-swa")
    wparams = TF.init_params(gen_p, swacfg, InitConfig("trunc_normal", 1.0), device=dev)
    long_prompt = tokens(1, 16384, swacfg.vocab_size, seed=10)
    t0 = time.perf_counter()
    logits = prefill(wparams, swacfg, long_prompt)
    swa_s = since(t0)
    check(bool(torch.isfinite(logits).all()), "swa prefill logits not finite")
    print(f"  qwen2.5-3b-swa (window {swacfg.sliding_window}): prefill 1 × 16384 {swa_s * 1e3:.1f} ms")
    serve_end("qwen2.5-3b-swa", swacfg.n_layers)
    new_serve["qwen2.5-3b-swa"].update(prefill_ms=swa_s * 1e3)
    del wparams, logits, long_prompt
    torch.cuda.empty_cache()
    flash_ops.flash_mha = flash_mha
    check(flash_launched <= flash_checked,
          f"phase 7c launched flash at {sorted(flash_launched - flash_checked, key=str)}, not checked in phase 3")
    print(f"  flash launch shapes: {len(flash_launched)} distinct in phase 7c, each held against the plain version "
          "in phase 3")

    # ------------------------- 7d. serve, full width: mamba and the frontends
    # jamba-1.5-large-398b cut to 5 layers (every kind of layer it has),
    # llava-next-mistral-7b (seeded random patch embeddings before the
    # text), musicgen-large (conditioning embeddings before the tokens) and
    # llama4-scout-17b-a16e cut to 8 layers, one model at a time in bf16,
    # each freed before the next: a cached prefill and a forward prefill on
    # the same inputs that agree, 8 greedy decode steps from the cache,
    # peak memory; one flash launch a prefill attention layer, every key
    # among phase 3's, all on wgmma, no other listed kernel (the mamba scan
    # and the frontend projector are plain torch, as the JAX package's are
    # XLA).  jamba and musicgen also replay a decode step as a CUDA graph
    # (bitwise the eager step), and jamba's mamba scans are timed on their
    # own in a third prefill (host clock after a sync around each scan).
    phase(f"7d. serve, full width: jamba-1.5-large-398b ({JAMBA_LAYERS} layers), llava-next-mistral-7b 2-node "
          f"ensemble, musicgen-large 4-node ring ensemble, llama4-scout-17b-a16e ({LLAMA4_LAYERS} layers) (bf16)")
    t_7d = time.perf_counter()
    from repro_torch.models import mamba as mamba_mod

    flash_launched.clear()
    flash_ops.flash_mha = recording_flash_mha

    def graph_step(params, cfg, cache, tok, pos):
        """One decode step eager, then captured as a CUDA graph and replayed
        from the same cache (restored before each): (ms a replay, whether
        the replay's logits and cache are the eager step's bit for bit).
        The timing replays advance the cache, which is not read after."""
        cache_leaves = leaves(cache)
        snapshot = [t.clone() for t in cache_leaves]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager = decode_one(params, cfg, cache, tok, pos)[0].clone()
        torch.cuda.current_stream().wait_stream(side)
        eager_cache = [t.clone() for t in cache_leaves]
        for t, s0 in zip(cache_leaves, snapshot):
            t.copy_(s0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = decode_one(params, cfg, cache, tok, pos)[0]
        for t, s0 in zip(cache_leaves, snapshot):
            t.copy_(s0)
        graph.replay()
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(replayed, eager)) and all(torch.equal(t, e) for t, e in zip(cache_leaves,
                                                                                             eager_cache))
        ms = time_ms(graph.replay)
        del graph, snapshot, eager_cache
        return ms, bitwise

    def serve_7d(name, cfg, params, prompts, embeds=None, graph=False, scan_ms=False):
        """The two prefills (agreeing; the forward first, so the cached one is
        timed warm), 8 decode steps, and the optional graph replay and scan
        timing; returns the record's numbers."""
        n_front = 0 if embeds is None else embeds.shape[-2]
        s_len = n_front + prompts.shape[-1]
        t0 = time.perf_counter()
        logits_f = prefill(params, cfg, prompts, embeds)  # the model's first call: its allocations
        fwd_ms = since(t0) * 1e3
        t0 = time.perf_counter()
        logits_c, cache = TF.prefill_cache(params, cfg, prompts, s_len + 16, frontend_embeds=embeds)
        pre_ms = since(t0) * 1e3
        diff = float((logits_c.float() - logits_f.float()).abs().max())
        scale = float(logits_f.float().abs().max())
        check(bool(torch.isfinite(logits_c).all()) and diff <= 1e-2 * scale,
              f"{name}: the cached prefill's logits differ from the forward's by {diff} (max {scale})")
        toks = [logits_c.argmax(-1)[:, None].to(prompts.dtype)]
        step_logits, cache = decode_one(params, cfg, cache, toks[-1], s_len)  # untimed: the first step allocates
        toks.append(step_logits[:, -1].argmax(-1)[:, None].to(prompts.dtype))
        t0 = time.perf_counter()
        for i in range(8):
            step_logits, cache = decode_one(params, cfg, cache, toks[-1], s_len + 1 + i)
            toks.append(step_logits[:, -1].argmax(-1)[:, None].to(prompts.dtype))
        dec_ms = since(t0) / 8 * 1e3
        check(bool(torch.isfinite(step_logits).all()), f"{name} decode logits not finite")
        rec = dict(prefill_ms=pre_ms, forward_prefill_ms=fwd_ms, decode_ms=dec_ms, prefill_bitwise=bool(
            torch.equal(logits_c, logits_f)), first_tokens=torch.cat(toks, 1)[:, :6].tolist(), tokens=s_len)
        if graph:
            rec["graph_ms"], rec["graph_bitwise"] = graph_step(params, cfg, cache, toks[-1], s_len + 10)
            check(rec["graph_bitwise"], f"{name}: the graph-replayed decode step differs from the eager step")
        del cache
        if scan_ms:
            real_scan, spans = mamba_mod._selective_scan, []

            def timed_scan(p, c, xc):
                torch.cuda.synchronize()
                t_s = time.perf_counter()
                out = real_scan(p, c, xc)
                spans.append(since(t_s) * 1e3)
                return out

            mamba_mod._selective_scan = timed_scan
            try:
                t0 = time.perf_counter()
                prefill(params, cfg, prompts, embeds)
                rec["scan_prefill_ms"] = since(t0) * 1e3
            finally:
                mamba_mod._selective_scan = real_scan
            rec["scan_ms"] = spans
        print(f"  {name}: prefill {prompts.shape[0]} × {s_len}"
              + (f" ({n_front} frontend embeddings + {prompts.shape[-1]} tokens)" if n_front else "")
              + f" {pre_ms:.1f} ms cached, {fwd_ms:.1f} ms forward (the first call; logits max abs diff {diff:.3e} "
              f"of {scale:.2f}, "
              f"bitwise {rec['prefill_bitwise']}); decode {dec_ms:.2f} ms a step ({prompts.shape[0]} sequences)"
              + (f", {rec['graph_ms']:.2f} ms replayed as a CUDA graph (bitwise the eager step)" if graph else "")
              + (f"; the {len(rec['scan_ms'])} mamba scans {sum(rec['scan_ms']):.1f} ms of a synced prefill's "
                 f"{rec['scan_prefill_ms']:.1f} ms ({[round(x, 1) for x in rec['scan_ms']]})" if scan_ms else "")
              + f"; first tokens {rec['first_tokens']}")
        return rec

    # jamba (5 layers): one parameter set, 2 × 2048
    serve_start("jamba-1.5-large-398b")
    t0 = time.perf_counter()
    jparams = TF.init_params(gen_p, jcfg, InitConfig("trunc_normal", 1.0), device=dev)
    init_s = since(t0)
    n_el = n_elements(jparams)
    print(f"  jamba-1.5-large-398b ({JAMBA_LAYERS} of 72 layers): {n_el:,} parameters "
          f"({sum(t.numel() * t.element_size() for t in leaves(jparams)) / 2**30:.2f} GiB), drawn in {init_s:.1f} s")
    check(n_el == 24_045_707_264, f"jamba ({JAMBA_LAYERS} layers) holds {n_el} parameters")
    rec = serve_7d("jamba-1.5-large-398b", jcfg, jparams, tokens(2, 2048, jcfg.vocab_size, seed=11), graph=True,
                   scan_ms=True)
    serve_end("jamba-1.5-large-398b", 3)
    new_serve["jamba-1.5-large-398b"].update(rec, init_s=init_s)
    check(new_serve["jamba-1.5-large-398b"]["peak_gib"] <= 75.0, "jamba: peak memory above 75 GiB")
    del jparams
    torch.cuda.empty_cache()

    # llava: the consensus of a 2-node ensemble, 2 × (2880 + 1216)
    serve_start("llava-next-mistral-7b")
    ring2 = T.complete(2)
    ens = TF.init_params(gen_p, lcfg, InitConfig("trunc_normal", torch.full((2,), gain_from_graph(ring2))), device=dev)
    cons = consensus_params(ens)
    del ens
    patches = torch.randn(2, LLAVA_PATCHES, lcfg.frontend_embed_dim, generator=gen_p, device=dev).to(torch.bfloat16)
    rec = serve_7d("llava-next-mistral-7b", lcfg, cons, tokens(2, LLAVA_TEXT, lcfg.vocab_size, seed=12), patches)
    serve_end("llava-next-mistral-7b", 2 * lcfg.n_layers)
    new_serve["llava-next-mistral-7b"].update(rec)
    del cons, patches
    torch.cuda.empty_cache()

    # musicgen: a 4-node ring ensemble's consensus, 4 × (256 + 1792)
    serve_start("musicgen-large")
    ens = TF.init_params(gen_p, mgcfg, InitConfig("trunc_normal", torch.full((4,), gain_from_graph(ring4))),
                         device=dev)
    cons = consensus_params(ens)
    del ens
    cond = torch.randn(4, MUSICGEN_COND, mgcfg.frontend_embed_dim, generator=gen_p, device=dev).to(torch.bfloat16)
    rec = serve_7d("musicgen-large", mgcfg, cons, tokens(4, MUSICGEN_TEXT, mgcfg.vocab_size, seed=13), cond,
                   graph=True)
    serve_end("musicgen-large", 2 * mgcfg.n_layers)
    new_serve["musicgen-large"].update(rec)
    del cons, cond
    torch.cuda.empty_cache()

    # llama4-scout (8 layers): one parameter set, 2 × 2048 text tokens
    serve_start("llama4-scout-17b-a16e")
    l4params = TF.init_params(gen_p, l4cfg, InitConfig("trunc_normal", 1.0), device=dev)
    check(n_elements(l4params) == 18_686_371_840, f"llama4-scout ({LLAMA4_LAYERS} layers) parameter count")
    rec = serve_7d("llama4-scout-17b-a16e", l4cfg, l4params, tokens(2, 2048, l4cfg.vocab_size, seed=14))
    serve_end("llama4-scout-17b-a16e", 2 * l4cfg.n_layers)
    new_serve["llama4-scout-17b-a16e"].update(rec)
    del l4params
    torch.cuda.empty_cache()
    flash_ops.flash_mha = flash_mha
    check(flash_launched <= flash_checked,
          f"phase 7d launched flash at {sorted(flash_launched - flash_checked, key=str)}, not checked in phase 3")
    print(f"  flash launch shapes: {len(flash_launched)} distinct in phase 7d, each held against the plain version "
          f"in phase 3; peak memory "
          + ", ".join(f"{k} {new_serve[k]['peak_gib']:.2f} GiB" for k in NEW_ARCHS)
          + f"; phase 7d: {time.perf_counter() - t_7d:.1f} s")

    # ------------------------------------------------- 8. serve, card vs CPU
    phase("8. serve, card vs CPU (reduced qwen2.5-3b, gemma3-4b, rwkv6-3b, granite-moe-1b-a400m, stablelm-12b, "
          "qwen1.5-4b, jamba-1.5-large-398b, llava-next-mistral-7b, musicgen-large and llama4-scout-17b-a16e, fp32, "
          "one init)")
    reset_counts()
    from repro_torch.models import moe as moe_mod

    # every MoE routing call's probabilities and top-k experts, by device:
    # the choices that differ between the card and the CPU, each with its
    # top-k margin (the k-th probability less the next one)
    real_route = moe_mod.route
    routing = collections.defaultdict(list)

    def recording_route(probs, k, cap):
        r = real_route(probs, k, cap)
        routing[probs.device.type].append((probs.detach().cpu(), r.idx.cpu()))
        return r

    flash_by_arch = {}

    def greedy_with_frontend(p, cfg, prompt_d, emb_d, n_new):
        """Greedy tokens after the frontend embeddings and the prompt: the
        cached prefill, then one decode step a token from position F + S."""
        logits, cache = TF.prefill_cache(p, cfg, prompt_d, 64, frontend_embeds=emb_d)
        toks = [logits.argmax(-1)[:, None]]
        pos = emb_d.shape[-2] + prompt_d.shape[-1]
        for i in range(n_new - 1):
            step, cache = TF.decode_step(p, cfg, cache, toks[-1].to(prompt_d.dtype), pos + i)
            toks.append(step[:, -1].argmax(-1)[:, None])
        return torch.cat(toks, 1)

    def n_attn(arch):
        return sum(k in ("attn", "swa") for k in TF.layer_kinds(get_reduced_config(arch)))

    moe_mod.route = recording_route
    try:
        for arch in ("qwen2.5-3b", "gemma3-4b", "rwkv6-3b", "granite-moe-1b-a400m", "stablelm-12b", "qwen1.5-4b",
                     *NEW_ARCHS):
            rcfg = get_reduced_config(arch)
            init = TF.init_params(torch.Generator().manual_seed(3), rcfg, InitConfig("trunc_normal", 1.0), device="cpu")
            p_np = params_to_numpy(init)
            prompt = make_token_stream(2 * 40, rcfg.vocab_size, seed=3).reshape(2, 40)  # past gemma's window 16
            # llava and musicgen: 8 frontend embeddings before the prompt, in
            # the prefill and in a greedy decode from its cache
            emb = (np.random.default_rng(3).standard_normal((2, rcfg.n_frontend_tokens, rcfg.frontend_embed_dim))
                   .astype(np.float32) if rcfg.n_frontend_tokens else None)
            out = {}
            before = flash_mha.launches
            for d_name in ("cuda", "cpu"):
                p = params_from_numpy(p_np, device=d_name)
                prompt_d = torch.as_tensor(prompt, device=d_name)
                emb_d = None if emb is None else torch.as_tensor(emb, device=d_name)
                out[d_name] = (
                    ServeEngine(rcfg, cache_len=64, device=d_name).generate(p, prompt, 8).cpu().numpy()
                    if emb is None else greedy_with_frontend(p, rcfg, prompt_d, emb_d, 8).cpu().numpy(),
                    prefill(p, rcfg, prompt_d, emb_d).cpu().numpy(),
                )
            flash_by_arch[arch] = flash_mha.launches - before
            (t_gpu, l_gpu), (t_cpu, l_cpu) = out["cuda"], out["cpu"]
            print(f"  {arch}: tokens cuda {t_gpu.tolist()} cpu {t_cpu.tolist()}; prefill logits max abs diff "
                  f"{float(np.abs(l_gpu - l_cpu).max()):.2e} (max abs {float(np.abs(l_cpu).max()):.2f})")
            if rcfg.is_moe:
                calls = list(zip(routing["cuda"], routing["cpu"]))
                check(len(routing["cuda"]) == len(routing["cpu"]) > 0, f"{arch}: routing calls "
                      f"{len(routing['cuda'])} on the card, {len(routing['cpu'])} on the CPU")
                flips, margins, n_tokens = 0, [], 0
                for (p_g, i_g), (p_c, i_c) in calls:
                    n_tokens += i_c.shape[0]
                    differ = (i_g.sort(-1).values != i_c.sort(-1).values).any(-1)
                    flips += int(differ.sum())
                    top = p_c.sort(-1, descending=True).values
                    margins += (top[differ, rcfg.experts_per_token - 1] - top[differ, rcfg.experts_per_token]).tolist()
                print(f"    routing: {flips} of {n_tokens} token choices (over {len(calls)} MoE calls) differ card vs "
                      f"CPU; their top-{rcfg.experts_per_token} margins {[f'{m:.2e}' for m in margins]}")
            check(np.array_equal(t_gpu, t_cpu), f"{arch}: card and CPU greedy tokens differ")
            check(np.allclose(l_gpu, l_cpu, rtol=1e-4, atol=1e-5), f"{arch}: card vs CPU prefill logits")
    finally:
        moe_mod.route = real_route
    # fp32: every attention layer of a generate's prefill and of a prefill
    # went through the flash kernel's fp32 route (hd 40 and 30 zero-padded)
    fp32_launches = flash_mha.launches_by_route["wgmma_tf32x3"]
    print(f"  flash launches by config {flash_by_arch}")
    check(all(flash_by_arch[a] == 2 * n_attn(a) for a in flash_by_arch),
          f"phase 8 flash launches {flash_by_arch}, want 2 prefills × the attention layers")
    want_fp32 = 2 * sum(n_attn(a) for a in flash_by_arch)
    check(flash_mha.launches_by_route == {"wgmma": 0, "wgmma_tf32x3": want_fp32},
          f"phase 8 flash routes {flash_mha.launches_by_route}, want {want_fp32} on wgmma_tf32x3")
    print(f"  flash routes {flash_mha.launches_by_route}")
    # fp32 r/k/v: every rwkv layer of the two prefills went through the rwkv
    # kernel's fp32 route, each prompt of 40 in one launch
    rwkv_fp32_launches = rwkv6_chunked.launches_by_route["tc_fp32"]
    want_fp32 = 2 * get_reduced_config("rwkv6-3b").n_layers
    check(rwkv6_chunked.launches_by_route == {"tc": 0, "tc_fp32": want_fp32} and rwkv6_chunked.one_launch == want_fp32,
          f"phase 8 rwkv routes {rwkv6_chunked.launches_by_route}, {rwkv6_chunked.one_launch} in one launch, "
          f"want {want_fp32} on tc_fp32, all in one launch")
    print(f"  rwkv routes {rwkv6_chunked.launches_by_route}, {rwkv6_chunked.one_launch} in one launch")

    # ------------------------------------------------------------- result
    src = "src/repro_torch/kernels/mix/csrc"
    rows = []
    for name, replaces, source, launches in (
        ("mix_matmul", "src/repro/kernels/mix/mix.py:76", f"{src}/mix.cu", quick_launches["mix_matmul"]),
        ("mix_bsr", "src/repro/kernels/mix/sparse.py:114", f"{src}/mix_bsr.cu", cli_launches["mix_bsr"]),
        ("flash_mha", "src/repro/kernels/flash/flash.py:130", "src/repro_torch/kernels/flash/csrc/flash_sm90.cu",
         serve_launches["flash_mha"]),
        # the fp32 route: phase 8's card-vs-CPU serving (the head dims with an
        # instance: reduced qwen2.5-3b, gemma3-4b, granite-moe, jamba, llava,
        # musicgen and llama4-scout)
        ("flash_mha_fp32", "src/repro/kernels/flash/flash.py:130", "src/repro_torch/kernels/flash/csrc/flash_sm90.cu",
         sum(flash_by_arch[a] for a in ("qwen2.5-3b", "gemma3-4b", "granite-moe-1b-a400m", *NEW_ARCHS))),
        ("rwkv6_chunked", "src/repro/kernels/rwkv/rwkv.py:99", "src/repro_torch/kernels/rwkv/csrc/rwkv_sm90.cu",
         serve_launches["rwkv6_chunked"]),
        # the fp32 route: phase 8's card-vs-CPU serving
        ("rwkv6_chunked_fma", "src/repro/kernels/rwkv/rwkv.py:99", "src/repro_torch/kernels/rwkv/csrc/rwkv_sm90.cu",
         rwkv_fp32_launches),
        # kernel 3 is three kernels here: the dense round (4b, one launch a
        # round), and the scales pass and the block-sparse walk (6)
        ("quant_scales", "src/repro/kernels/mix/quant.py:109", f"{src}/quant_mix.cu",
         comp_launches["int8"]["quant_scales"] + comp_launches["fp8"]["quant_scales"]
         + cli_c_launches["quant_scales"]),
        ("quant_mix_dense", "src/repro/kernels/mix/quant.py:109", f"{src}/quant_mix.cu",
         comp_launches["int8"]["quant_mix_dense"] + comp_launches["fp8"]["quant_mix_dense"]),
        ("quant_mix_bsr", "src/repro/kernels/mix/quant.py:109", f"{src}/quant_mix.cu",
         cli_c_launches["quant_mix_bsr"]),
        # the gossip rounds of phase 4e (kernels 1 and 2 over Mᵀ at d ≤ 4):
        # launches of the budget-32 warmup's estimation and of the CLI
        # ring-1024's estimator, each run alone; the row's times at their
        # push-sum round (kreg4-16 / ring-1024, d = 3), every gossip shape
        # under "shapes"
        ("mix_matmul_gossip", "src/repro/kernels/mix/mix.py:76", f"{src}/mix.cu", gossip_launches["mix_matmul"]),
        ("mix_bsr_gossip", "src/repro/kernels/mix/sparse.py:114", f"{src}/mix_bsr.cu", gossip_launches["mix_bsr"]),
        # the schedule rounds of phase 4f: the churn CLI's mix_bsr launches
        # (its training and gossip rounds), the K = 4 BA-16 schedule's dense
        # mixes and int8 rounds in its card runs
        ("mix_bsr_schedule", "src/repro/kernels/mix/sparse.py:114", f"{src}/mix_bsr.cu", sched_launches["mix_bsr"]),
        ("mix_matmul_schedule", "src/repro/kernels/mix/mix.py:76", f"{src}/mix.cu", sched_launches["mix_matmul"]),
        ("quant_mix_dense_schedule", "src/repro/kernels/mix/quant.py:109", f"{src}/quant_mix.cu",
         sched_launches["quant_mix_dense"]),
        # the event exchanges of phase 4g: the CLI's --async --compress int8
        # run, one dense round over the pair's two rows a delivered event.
        # The JAX event executor compresses the exchange with the plain
        # codec (compressed_mix_with, no pallas_call); the port runs it
        # through kernel 3's dense round, whose design it reuses
        ("quant_mix_dense_event", "src/repro/core/compress.py:251", f"{src}/quant_mix.cu", event_launches),
        # the consensus example of phase 4h: its DecAvg rounds (n = 8 over
        # the reduced qwen2.5-3b's row) and its fp32 flash prefills
        ("mix_matmul_decoder", "src/repro/kernels/mix/mix.py:76", f"{src}/mix.cu", lm_launches["mix_matmul"]),
        ("flash_mha_fp32_example", "src/repro/kernels/flash/flash.py:130",
         "src/repro_torch/kernels/flash/csrc/flash_sm90.cu", lm_launches["flash_mha"]),
        # the elastic rounds of phase 4i: the elastic CLI's masked dense
        # mixes (complete-16, a join and a crash burst), its int8 rounds with
        # the members' keep mask, and the sparse kreg4-256 run's masked walks
        ("mix_matmul_elastic", "src/repro/kernels/mix/mix.py:76", f"{src}/mix.cu", elastic_launches["mix_matmul"]),
        ("mix_bsr_elastic", "src/repro/kernels/mix/sparse.py:114", f"{src}/mix_bsr.cu", elastic_launches["mix_bsr"]),
        ("quant_mix_dense_elastic", "src/repro/kernels/mix/quant.py:109", f"{src}/quant_mix.cu",
         elastic_launches["quant_mix_dense"]),
        # head dims the kernel runs zero-padded: stablelm-12b's prefills in
        # phase 7 (hd 160), phase 8's reduced stablelm-12b (hd 40 fp32) and
        # qwen1.5-4b (hd 30 fp32); no path launches hd 40 in bf16
        ("flash_mha_hd160", "src/repro/kernels/flash/flash.py:130", "src/repro_torch/kernels/flash/csrc/flash_sm90.cu",
         new_serve["stablelm-12b"]["flash"]),
        ("flash_mha_hd40", "src/repro/kernels/flash/flash.py:130", "src/repro_torch/kernels/flash/csrc/flash_sm90.cu",
         0),
        ("flash_mha_hd40_fp32", "src/repro/kernels/flash/flash.py:130",
         "src/repro_torch/kernels/flash/csrc/flash_sm90.cu", flash_by_arch["stablelm-12b"]),
        ("flash_mha_hd30_fp32", "src/repro/kernels/flash/flash.py:130",
         "src/repro_torch/kernels/flash/csrc/flash_sm90.cu", flash_by_arch["qwen1.5-4b"]),
        # phase 7's new bf16 serving: granite-moe (hd 64), qwen1.5-4b (MHA
        # 20 / 20, hd 128), the swa variant's 16,384-token prompt
        ("flash_mha_granite", "src/repro/kernels/flash/flash.py:130",
         "src/repro_torch/kernels/flash/csrc/flash_sm90.cu", new_serve["granite-moe-1b-a400m"]["flash"]),
        ("flash_mha_qwen15", "src/repro/kernels/flash/flash.py:130",
         "src/repro_torch/kernels/flash/csrc/flash_sm90.cu", new_serve["qwen1.5-4b"]["flash"]),
        ("flash_mha_swa", "src/repro/kernels/flash/flash.py:130",
         "src/repro_torch/kernels/flash/csrc/flash_sm90.cu", new_serve["qwen2.5-3b-swa"]["flash"]),
        # phase 4k's --model moe rounds: the dense mix (plain) and the dense
        # int8 round, n = 8 over the reduced granite-moe's row
        ("mix_matmul_moe", "src/repro/kernels/mix/mix.py:76", f"{src}/mix.cu", moe_launches["plain"]["mix_matmul"]),
        ("quant_mix_dense_moe", "src/repro/kernels/mix/quant.py:109", f"{src}/quant_mix.cu",
         moe_launches["int8"]["quant_mix_dense"]),
        # phase 4l's DecAvg rounds (n = 8 over the reduced rwkv6-3b's, jamba's
        # and llava's rows) and --model rwkv's fp32 evals
        ("mix_matmul_zoo", "src/repro/kernels/mix/mix.py:76", f"{src}/mix.cu", zoo_launches["mix_matmul"]),
        ("rwkv6_chunked_eval", "src/repro/kernels/rwkv/rwkv.py:99", "src/repro_torch/kernels/rwkv/csrc/rwkv_sm90.cu",
         rwkv_eval_launches),
        # phase 7d's bf16 serving: jamba (5 layers; GQA 64 / 8), llava (2 ×
        # 4096 with the patch embeddings), musicgen (MHA 32 / 32, hd 64),
        # llama4-scout (8 layers; GQA 40 / 8, a group of 5)
        *((f"flash_mha_{short}", "src/repro/kernels/flash/flash.py:130",
           "src/repro_torch/kernels/flash/csrc/flash_sm90.cu", new_serve[arch]["flash"])
          for short, arch in zip(("jamba", "llava", "musicgen", "llama4"), NEW_ARCHS)),
        # the node-sharded round's row-block forms.  Their launches are
        # phase 6b's sharded runs at one NCCL rank, where the row block is
        # all n rows (r = n, S = 1); the r < n form that their errors,
        # times and shapes describe (phase 3, at the shapes S = 2 and 4
        # give) runs on the main path only at S > 1, which one card cannot
        # hold: each row says so under "launches_at"
        ("mix_matmul_rows", "src/repro/kernels/mix/mix.py:76", f"{src}/mix.cu", shard_launches["mix_matmul"]),
        ("mix_bsr_halo", "src/repro/kernels/mix/sparse.py:114", f"{src}/mix_bsr.cu", shard_launches["mix_bsr"]),
    ):
        t = timing[name]
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        }
        if name.startswith("mix_matmul"):
            row["dense_route"] = t["dense_route"]
        if name.endswith("_gossip"):
            kname = name.removesuffix("_gossip")
            row["shape"] = t["shape"]
            row["shapes"] = [{k: v for k, v in g_t.items() if k != "kernel"}
                             for g_t in gossip_shapes.values() if g_t["kernel"] == kname]
        elif name.startswith("flash_mha_hd") or name.endswith(("_schedule", "_event", "_decoder", "_example",
                                                               "_elastic", "_moe", "_granite", "_qwen15", "_swa",
                                                               "_zoo", "_eval", "_jamba", "_llava", "_musicgen",
                                                               "_llama4", "_rows", "_halo")):
            row["shape"] = t["shape"]
        if name.endswith(("_rows", "_halo")):
            row["launches_at"] = ("r = n (S = 1, one NCCL rank, phase 6b); the r < n form of shape, ms and "
                                  "max_abs_err is launched only in phase 3's holdings")
        rows.append(row)
    print(f"\nall phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


def traced_prefills() -> int:
    """Phase 7b, which ``main`` runs as ``chip_smoke.py --traced-prefills``
    in a process of its own (the kernel libraries already built): one
    qwen2.5-3b and one rwkv6-3b 4 × 2048 prefill, bf16, random weights,
    each under torch.profiler after a warm-up.  Exits 0, or 1 with the
    failed check on standard error."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.data import make_token_stream
    from repro_torch.device import resolve_device
    from repro_torch.fed import prefill
    from repro_torch.kernels.flash import attention_ref, flash_mha
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.rwkv import rwkv6_chunked
    from repro_torch.models import transformer as TF

    dev = resolve_device("cuda")
    kernels, reset_counts = kernel_counters()
    none_launched = {kern.__name__: 0 for kern in kernels}
    qcfg, rcfg = get_config("qwen2.5-3b"), get_config("rwkv6-3b")
    gen_p = torch.Generator(device=dev).manual_seed(0)

    def tokens(n_prompts, length, vocab, seed):
        stream = make_token_stream(n_prompts * length, vocab, seed=seed)
        return torch.as_tensor(stream.reshape(n_prompts, length), device=dev)

    # one qwen2.5-3b prefill (4 × 2048, one parameter set) under the
    # profiler, after a warm-up: device time by kernel, flash's share, and
    # the device's busy share of the traced wall time
    tparams = TF.init_params(gen_p, qcfg, InitConfig("trunc_normal", 1.0), device=dev)
    t_prompts = tokens(4, 2048, qcfg.vocab_size, seed=0)
    prefill(tparams, qcfg, t_prompts)
    torch.cuda.synchronize()
    t_logits, prof, traced_s = traced(lambda: prefill(tparams, qcfg, t_prompts),
                                      want={"flash_sm90": qcfg.n_layers}, before=reset_counts)
    traced_launches = {kern.__name__: kern.launches for kern in kernels}
    check(traced_launches == {**none_launched, "flash_mha": qcfg.n_layers}
          and flash_mha.launches_by_route == {"wgmma": qcfg.n_layers, "wgmma_tf32x3": 0},
          f"traced prefill launches {traced_launches}, routes {flash_mha.launches_by_route}")
    dev_ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in dev_ops}
    total_us = sum(dev_us.values())
    check(total_us > 0, "the profiler recorded no device time")
    flash_us = sum(t for name, t in dev_us.items() if "flash_sm90" in name)
    print(f"  traced prefill {traced_s * 1e3:.1f} ms wall, device busy {total_us / 1e3:.1f} ms "
          f"({total_us / 1e3 / (traced_s * 1e3):.1%}); flash kernel {flash_us / 1e3:.2f} ms "
          f"= {flash_us / total_us:.1%} of device time ({qcfg.n_layers} launches)")
    counts = {e.key: e.count for e in dev_ops}
    for name, t in sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {t / 1e3:9.3f} ms {t / total_us:6.1%} ×{counts[name]:<4d} {name[:110]}")
    # the same prefill with attention through the plain version (fp32
    # probabilities, einsum products): a diagnostic of the kernel's effect
    # on the logits, not a gate
    flash_ops.flash_mha = lambda q, k, v, *, causal=True, window=0: attention_ref(q, k, v, causal=causal,
                                                                                   window=window)
    ref_logits = prefill(tparams, qcfg, t_prompts)
    flash_ops.flash_mha = flash_mha
    print(f"  last-position logits, kernel vs attention_ref prefill: max abs diff "
          f"{float((t_logits.float() - ref_logits.float()).abs().max()):.3e} "
          f"(max abs {float(ref_logits.float().abs().max()):.2f}); argmax equal "
          f"{bool(torch.equal(t_logits.argmax(-1), ref_logits.argmax(-1)))}")
    del tparams, t_logits, ref_logits, prof
    torch.cuda.empty_cache()

    # one rwkv6-3b 4 × 2048 prefill (one parameter set) under the profiler:
    # the tc kernel's three launches a layer and their share of device time
    rparams = TF.init_params(gen_p, rcfg, InitConfig("trunc_normal", 1.0), device=dev)
    r_prompts = tokens(4, 2048, rcfg.vocab_size, seed=3)
    prefill(rparams, rcfg, r_prompts)
    torch.cuda.synchronize()
    r_logits, prof, traced_s = traced(lambda: prefill(rparams, rcfg, r_prompts),
                                      want=dict.fromkeys(("rwkv_span_delta", "rwkv_span_scan", "rwkv_span_out"),
                                                         rcfg.n_layers), before=reset_counts)
    check(bool(torch.isfinite(r_logits).all()), "traced rwkv prefill logits not finite")
    check(rwkv6_chunked.launches_by_route == {"tc": rcfg.n_layers, "tc_fp32": 0},
          f"traced rwkv prefill routes {rwkv6_chunked.launches_by_route}")
    dev_ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in dev_ops}
    counts = {e.key: e.count for e in dev_ops}
    total_us = sum(dev_us.values())
    check(total_us > 0, "the profiler recorded no device time")
    rwkv_us = {name: t for name, t in dev_us.items() if "rwkv_span" in name}
    rwkv_total = sum(rwkv_us.values())
    per_kernel = ", ".join(f"{re.sub(r'.*(rwkv_span_[a-z]+).*', r'\1', n)} {t / 1e3:.2f} ms"
                           for n, t in rwkv_us.items())
    print(f"  rwkv6-3b prefill 4 × 2048 traced: {traced_s * 1e3:.1f} ms wall, device busy {total_us / 1e3:.1f} ms "
          f"({total_us / 1e3 / (traced_s * 1e3):.1%}); rwkv kernel {rwkv_total / 1e3:.2f} ms = "
          f"{rwkv_total / total_us:.1%} of device time ({rcfg.n_layers} launches of 3 kernels: {per_kernel})")
    for name, t in sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {t / 1e3:9.3f} ms {t / total_us:6.1%} ×{counts[name]:<4d} {name[:110]}")
    check(len(rwkv_us) == 3 and all(counts[n] == rcfg.n_layers for n in rwkv_us),
          f"traced rwkv kernels {[(n, counts[n]) for n in rwkv_us]}; {trace_edges(prof)}")
    del rparams, r_logits, prof
    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(traced_prefills() if sys.argv[1:] == ["--traced-prefills"] else main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
