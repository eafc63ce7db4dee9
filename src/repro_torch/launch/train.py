"""Training launcher of the port: the paper's synchronous path (MLP, CNN, VGG16) on the card.

Examples:
    python -m repro_torch.launch.train --model mlp --nodes 16 --rounds 100
    python -m repro_torch.launch.train --model mlp --topology ring --nodes 1024 --rounds 3
    python -m repro_torch.launch.train --model mlp --no-gain-correction   # Fig. 1 baseline
    python -m repro_torch.launch.train --model mlp --device cpu --nodes 4 --rounds 2
    # paper cfg. B: the CNN on So2Sat-like data, BA(m=8), Zipf α=1.8 label skew
    python -m repro_torch.launch.train --model cnn --topology ba --zipf 1.8 --rounds 50
    # paper cfg. C: VGG16 (width 0.25 here, as the JAX launcher) on CIFAR-10-like data
    python -m repro_torch.launch.train --model vgg16 --topology kregular --rounds 20
    # a reduced zoo decoder: token windows through the executors (int8 gossip), or host-fed
    python -m repro_torch.launch.train --model transformer --nodes 8 --rounds 20 --compress int8
    python -m repro_torch.launch.train --model moe --nodes 8 --rounds 20 --compress int8
    python -m repro_torch.launch.train --model rwkv --nodes 8 --rounds 20
    python -m repro_torch.launch.train --arch qwen2.5-3b --reduced --rounds 30
    python -m repro_torch.launch.train --arch jamba-1.5-large-398b --reduced --rounds 30
    # a run log and a profiler trace of the rounds
    python -m repro_torch.launch.train --model mlp --rounds 20 --telemetry build/run.jsonl --profile-trace build/trace
    # compressed gossip: int8 / fp8 exchanges with error-feedback mirrors
    python -m repro_torch.launch.train --model mlp --compress int8
    python -m repro_torch.launch.train --model mlp --compress qtopk --topk-frac 0.3 --gamma 0.5
    # uncoordinated init (§4.4): per-node gains from gossip over the training
    # links (and their --link-p / --node-p failures), then init and training
    python -m repro_torch.launch.train --model mlp --topology kregular --uncoordinated-init --estimate-rounds 24
    # time-varying topology: 8 churned snapshots of a kreg4-256, one a round;
    # estimation and training both follow the schedule
    python -m repro_torch.launch.train --model mlp --topology kregular --nodes 256 \
        --topology-schedule churn --plans 8 --churn-rate 0.2 --uncoordinated-init --leaderless
    # stream the recorded rounds every 10 rounds instead of after the run
    python -m repro_torch.launch.train --model mlp --rounds 100 --log-every 10
    # event-driven, no round barrier: per-edge Poisson clocks, pairwise
    # exchanges as they fire (int8: one quantised pair round an exchange)
    python -m repro_torch.launch.train --model mlp --topology ba --async --event-rate 1.0 --event-horizon 100
    # elastic membership: 4 nodes arrive at round 50, estimate n online, and
    # initialise uncoordinated mid-run; correlated crash burst injected
    python -m repro_torch.launch.train --model mlp --topology kregular --elastic \
        --join-nodes 4 --join-round 50 --fault-scenario crash
    # preemption-safe: checkpoint every chunk, then resume bit-identically
    python -m repro_torch.launch.train --model mlp --rounds 100 --chunk-rounds 25 --ckpt-dir /tmp/ck --checkpoint-every 1
    python -m repro_torch.launch.train --model mlp --rounds 100 --chunk-rounds 25 --resume /tmp/ck

Runs on ``cuda`` unless ``--device cpu`` is given; the mixing rounds go
through the hand-written kernels there (dense for n ≤ 64; beyond it the
row-list kernel on an unmasked round, the block-sparse one on a masked
round; an int8 / fp8 round is one pass of the quantised-mix kernel).
With ``--uncoordinated-init`` every estimation round is one launch of the
same mixing kernels over Mᵀ (``repro_torch.gossip``, ``run_warmup_trajectory``).
``--topology-schedule cyclic|churn`` compiles a ``PlanSchedule`` of
``--plans`` graphs (independently drawn ones of the family, or a Markov
chain of ``--churn-rate`` rewirings of the base graph), each active
``--plan-period`` rounds; every round runs the active plan's kernels, and
``--link-p`` / ``--node-p`` ride in through ``make_round_fn``'s override.
``--chunk-rounds`` sets ``run_trajectory``'s chunk and ``--log-every`` prints the
recorded rounds at chunk boundaries (the warmup path runs unchunked and
prints after the run).
``--async`` runs the event-driven executor (``run_event_trajectory``)
over a Poisson stream of ``--event-rate`` clocks an edge and horizon
``--event-horizon`` (default ``--rounds``), printing one line a bin of
virtual time; with ``--uncoordinated-init`` the gains are n̂^0.5 from
barrier-free leaderless sketches over a stream of their own
(``--estimate-rounds`` units of virtual time, seed + 3).
``--elastic`` (implied by ``--join-nodes`` / ``--fault-scenario``) runs the
elastic executor (``run_elastic_trajectory``): ``--join-nodes`` envelope
slots arrive at ``--join-round``, estimate n̂ with leaderless sketches for
``--join-warmup`` rounds and initialise uncoordinated; ``--fault-scenario``
injects a seeded ``core.faults`` scenario; every recorded round prints its
live population (``active``).  Its plan carries ``--link-p`` / ``--node-p``
as the synchronous path's does.  ``--ckpt-dir`` with ``--checkpoint-every N``
checkpoints the synchronous or elastic trajectory every N chunks
(``CheckpointPolicy``) and ``--resume DIR`` continues it bit-identically from
the directory's LATEST; ``--ckpt-dir`` alone saves the final params after
the run.
Full-width VGG16 is reached through the API (``init_vgg16(width_mult=1.0)``).
``--model transformer`` trains the reduced qwen2.5-3b and ``--model moe`` the
reduced granite-moe-1b-a400m on windowed synthetic token data (``--seq-len``
tokens a window) through the same executors and codecs; ``--arch ID
--reduced`` trains a reduced zoo architecture on token streams through the
host-fed ``train_loop`` (``--legacy-loop`` takes that loop for the paper
models too); ``--model rwkv`` trains the reduced rwkv6-3b through the
executors, its recorded forwards through the plain chunked time-mix and
its evaluations through the rwkv kernel.  ``--arch`` takes any of the ten
zoo architectures, and, as the JAX launcher, feeds a frontend config
text tokens alone (no frontend embeddings).
``--telemetry PATH`` writes a JSONL run log (``repro_torch.obs``): the
manifest, one record a recorded round (or bin), the summary, and the
gossip health of the operator the run mixed over; ``--profile-trace DIR``
captures a ``torch.profiler`` trace of the run into ``DIR/trace.json``, the
rounds' phases marked ``dfl_local`` / ``dfl_mix`` / ``dfl_eval``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.checkpoint import save_train_state
from repro_torch.configs import get_reduced_config
from repro_torch.core import topology as T
from repro_torch.core.commplan import CommPlan, FailureModel, compile_plan, compile_schedule, cyclic_map
from repro_torch.core.compress import Compression
from repro_torch.core.faults import SCENARIOS, scenario
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.core.membership import membership_schedule
from repro_torch.data import (
    batch_index_schedule,
    cifar10_like,
    make_token_stream,
    mnist_like,
    node_batch_iterator,
    node_datasets,
    partition_iid,
    partition_zipf,
    so2sat_like,
    token_batch_iterator,
)
from repro_torch.device import resolve_device
from repro_torch.fed import (
    CheckpointPolicy,
    init_fl_state,
    make_eval_fn,
    make_round_fn,
    run_elastic_trajectory,
    run_event_trajectory,
    run_trajectory,
    run_warmup_trajectory,
    train_loop,
)
from repro_torch.flat import tree_leaves
from repro_torch.gossip import estimate_size_leaderless_events, gains_from_estimates, make_gain_estimator, split_seed
from repro_torch.models import transformer as TF
from repro_torch.models.paper_models import (
    classifier_loss,
    cnn_forward,
    init_cnn,
    init_mlp,
    init_vgg16,
    mlp_forward,
    vgg16_forward,
)
from repro_torch.obs import gossip_health, history_rows, profile_trace, run_manifest, write_run_log
from repro_torch.optim import adamw, sgd

# --model token archs: reduced zoo configs on windowed synthetic token data
TOKEN_MODELS = {"transformer": "qwen2.5-3b", "moe": "granite-moe-1b-a400m", "rwkv": "rwkv6-3b"}
MODELS = ["mlp", "cnn", "vgg16", *sorted(TOKEN_MODELS)]


def build_graph(kind: str, n: int, seed: int) -> T.Graph:
    return {
        "full": lambda: T.complete(n),
        "kregular": lambda: T.random_k_regular(n, min(4, n - 1 - (n % 2 == 0)), seed=seed)
        if n > 5
        else T.complete(n),
        "ba": lambda: T.barabasi_albert(n, min(8, n // 2), seed=seed),
        "er": lambda: T.erdos_renyi_gnp(n, min(1.0, 6.0 / n), seed=seed),
        "ring": lambda: T.ring(n),
        "circulant": lambda: T.circulant(n, (1, 2)),
    }[kind]()


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=MODELS, default=None, help="mlp (default), cnn, vgg16 or a token model")
    p.add_argument("--arch", type=str, default=None, help="zoo arch id (with --reduced): host-fed token training")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--nodes", type=int, default=16)
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--topology", choices=["full", "kregular", "ba", "er", "ring", "circulant"], default="full")
    p.add_argument("--optimizer", choices=["sgd", "adamw"], default="sgd")
    p.add_argument("--items-per-node", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--local-batches", type=int, default=8)
    p.add_argument("--zipf", type=float, default=0.0,
                   help="non-iid label skew: Zipf exponent α of each node's class preference (0 = iid)")
    p.add_argument("--seq-len", type=int, default=64, help="window length for the token --model archs")
    p.add_argument(
        "--compress", choices=["none", "int8", "fp8", "topk", "qtopk"], default="none",
        help="compressed gossip (core.compress): quantised / top-k sparsified exchanges with "
        "per-node error-feedback mirrors (qtopk = top-k with int8 values, 3 bytes/entry)",
    )
    p.add_argument("--compress-chunk", type=int, default=2048,
                   help="codec chunk: elements per fp32 scale (≤ 65536)")
    p.add_argument("--topk-frac", type=float, default=0.1,
                   help="fraction of each chunk the topk/qtopk codecs transmit")
    p.add_argument("--gamma", type=float, default=None,
                   help="consensus step size of the compressed mix (default 1.0; 0.3 for "
                   "topk/qtopk, which need the damping on sparse graphs)")
    p.add_argument("--link-p", type=float, default=1.0)
    p.add_argument("--node-p", type=float, default=1.0)
    p.add_argument(
        "--topology-schedule", choices=["static", "cyclic", "churn"], default="static",
        help="time-varying topology (PlanSchedule): 'cyclic' cycles --plans independently drawn graphs "
        "of the family, 'churn' walks a seeded Markov chain of edge up/down rewirings of the base "
        "graph (--churn-rate); each round mixes with the plan active at its index",
    )
    p.add_argument("--plans", type=int, default=4, help="K: plans in the schedule")
    p.add_argument("--plan-period", type=int, default=1,
                   help="rounds each plan stays active before the schedule advances")
    p.add_argument("--churn-rate", type=float, default=0.1,
                   help="per-snapshot edge resampling probability (churn schedule)")
    p.add_argument("--no-gain-correction", action="store_true")
    p.add_argument(
        "--uncoordinated-init", action="store_true",
        help="per-node gains from gossip estimation (repro_torch.gossip) instead of the "
        "perfect-knowledge gain_from_graph; estimation rides the training links and failures",
    )
    p.add_argument("--estimate-rounds", type=int, default=32,
                   help="gossip budget: power-iteration and push-sum rounds each")
    p.add_argument("--estimate-mode", choices=["vnorm", "alpha", "degree"], default="vnorm",
                   help="§4.4 knowledge regime: gossip ‖v̂‖ / size-only n̂^α / degree polling")
    p.add_argument("--leaderless", action="store_true",
                   help="size estimation by exponential-random-minimum sketches instead of the "
                   "leader one-hot: no distinguished node")
    p.add_argument(
        "--async", action="store_true", dest="async_gossip",
        help="event-driven gossip: no global round barrier; per-edge Poisson clocks realise an event stream and "
        "training and mixing happen pairwise as edges fire (fed.run_event_trajectory)",
    )
    p.add_argument("--event-rate", type=float, default=1.0,
                   help="per-edge Poisson clock rate; 1.0 matches one synchronous round per unit time in messages")
    p.add_argument("--event-horizon", type=float, default=None,
                   help="virtual-time horizon of the event stream (default: --rounds)")
    p.add_argument(
        "--elastic", action="store_true",
        help="elastic membership executor (fed.run_elastic_trajectory): nodes join/leave inside the static "
        "envelope; implied by --join-nodes / --fault-scenario",
    )
    p.add_argument("--join-nodes", type=int, default=0,
                   help="hold this many envelope slots out of the initial membership; they arrive at --join-round, "
                   "re-derive n̂ via leaderless sketches, and initialise uncoordinated mid-run")
    p.add_argument("--join-round", type=int, default=None,
                   help="arrival round of the joining nodes (default: rounds // 2)")
    p.add_argument("--join-warmup", type=int, default=8,
                   help="estimation rounds between a node's arrival and its init")
    p.add_argument("--fault-scenario", choices=sorted(SCENARIOS), default="none",
                   help="deterministic fault injection (core.faults): correlated crash bursts, partitions, hub "
                   "outages — seeded and replayable")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="with --ckpt-dir: snapshot the whole trajectory state every N chunks (preemption-safe; "
                   "resume is bit-identical)")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint dir to resume the trajectory from (replays bit-identical params/metrics; a "
                   "path without a LATEST starts fresh)")
    p.add_argument("--chunk-rounds", type=int, default=0, help="executor chunk size in rounds (0 = auto)")
    p.add_argument("--log-every", type=int, default=0,
                   help="print the recorded metrics every N rounds at chunk boundaries instead of after the "
                   "run (sets the chunk size unless --chunk-rounds is given)")
    p.add_argument(
        "--legacy-loop", action="store_true",
        help="per-round host-fed batches through train_loop instead of the schedule-gathering executor",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", type=str, default=None)
    p.add_argument("--history-out", type=str, default=None)
    p.add_argument("--telemetry", type=str, default=None,
                   help="write a JSONL run log: manifest, one record a recorded round or bin, summary, gossip "
                   "health (repro_torch.obs)")
    p.add_argument("--profile-trace", type=str, default=None,
                   help="capture a torch.profiler trace of the run into DIR/trace.json (ranges dfl_local / "
                   "dfl_mix / dfl_eval)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def _check_args(p: argparse.ArgumentParser, args) -> None:
    """The JAX launcher's flag rules."""
    if args.join_nodes > 0 or args.fault_scenario != "none":
        args.elastic = True
    if args.uncoordinated_init and args.no_gain_correction:
        p.error("--uncoordinated-init estimates (and applies) per-node gains; "
                "it contradicts --no-gain-correction — pick one")
    if args.async_gossip:
        if args.arch or args.legacy_loop:
            p.error("--async runs through the event executor — it excludes --arch and --legacy-loop")
        if args.topology_schedule != "static":
            p.error("--async needs a static topology: realise dynamics as per-edge "
                    "clock rates (poisson_event_stream) rather than a PlanSchedule")
        if args.uncoordinated_init and args.estimate_mode == "degree":
            p.error("--async estimation is barrier-free leaderless sketching; "
                    "degree polling needs the round-based walker — drop "
                    "--estimate-mode degree or drop --async")
    if args.elastic:
        if args.async_gossip or args.arch or args.legacy_loop:
            p.error("--elastic runs through the elastic executor — it excludes --async, --arch and --legacy-loop")
        if args.uncoordinated_init:
            p.error("--elastic joiners already initialise uncoordinated from online n̂ sketches; initial members "
                    "use the graph gain — drop --uncoordinated-init")
        if not 0 <= args.join_nodes < args.nodes:
            p.error(f"--join-nodes must leave at least one initial member (got {args.join_nodes} of {args.nodes})")
        if args.topology_schedule != "static" and "partition" in args.fault_scenario:
            p.error("edge-cut fault scenarios index the base graph's edge list — they need --topology-schedule static")
    if args.resume and args.uncoordinated_init and not args.async_gossip:
        p.error("--resume is not supported through the warmup phase; drop --uncoordinated-init (or resume an "
                "--elastic run)")
    if args.model in TOKEN_MODELS and args.legacy_loop:
        p.error("token --model archs gather from the precomputed schedule — they run through the executors, not "
                "--legacy-loop (use --arch for the host-driven token path)")


def main(argv: list[str] | None = None) -> dict[str, list]:
    p = _parser()
    args = p.parse_args(argv)
    _check_args(p, args)
    dev = resolve_device(args.device)
    compress_cfg = None
    if args.compress != "none":
        sparse = args.compress in ("topk", "qtopk")
        gamma = args.gamma if args.gamma is not None else (0.3 if sparse else 1.0)
        compress_cfg = Compression(
            codec=args.compress, chunk=args.compress_chunk, topk_frac=args.topk_frac, gamma=gamma
        )
        ratio = 4.0 / compress_cfg.leaf_row_bytes(args.compress_chunk, np.float32) * args.compress_chunk
        print(
            f"compress: {args.compress} chunk={args.compress_chunk} "
            + (f"topk_frac={args.topk_frac} " if sparse else "")
            + f"gamma={gamma:g} (~{ratio:.1f}x bytes)"
        )

    n = args.nodes
    graph = build_graph(args.topology, n, args.seed)
    sched_graphs = None
    mix_plan = graph
    if args.topology_schedule != "static":
        if args.topology_schedule == "churn":
            sched_graphs = T.churn_sequence(graph, args.plans, args.churn_rate, seed=args.seed + 1)
        else:  # cyclic: independently drawn graphs of the same family
            sched_graphs = [graph] + [build_graph(args.topology, n, args.seed + 101 * t) for t in range(1, args.plans)]
        # failures ride in through make_round_fn's link_p / node_p override
        mix_plan = compile_schedule(sched_graphs, round_map=cyclic_map(args.plan_period), device=dev)
        print(
            f"schedule: {args.topology_schedule} K={mix_plan.k} period={args.plan_period}"
            + (f" churn_rate={args.churn_rate}" if args.topology_schedule == "churn" else "")
        )
    gain = 1.0 if args.no_gain_correction else gain_from_graph(graph)
    print(f"graph={graph.name} ‖v_steady‖⁻¹ gain={gain:.2f}" + (" (DISABLED)" if args.no_gain_correction else ""))
    opt = sgd(1e-3, 0.5) if args.optimizer == "sgd" else adamw(1e-3)
    task = _task(args, n)

    ckpt_policy = None
    if args.ckpt_dir and args.checkpoint_every > 0:
        ckpt_policy = CheckpointPolicy(args.ckpt_dir, every=args.checkpoint_every)
    with profile_trace(args.profile_trace):
        if args.async_gossip:
            state, hist, health_plan = _run_async(args, graph, n, gain, opt, task, compress_cfg, dev)
        else:
            state, hist, health_plan = _run_rounds(args, graph, sched_graphs, mix_plan, n, gain, opt, task,
                                                   compress_cfg, ckpt_policy, dev)
    return _finish(args, state, hist, graph, ckpt_policy, health_plan, dev,
                   sys.argv[1:] if argv is None else list(argv))


def _task(args, n: int):
    """The model, its data and its loss: ``xs`` / ``ys`` the per-node data
    (None on the host-fed --arch path), ``eval_batch``, ``loss_fn``,
    ``eval_fn`` (None without an eval batch), ``init_one(generator, gains)``
    and ``batches()``, the host-fed rounds of ``train_loop`` (None for the
    windowed token models, which run through the executors only)."""

    if args.arch or args.model in TOKEN_MODELS:
        cfg = get_reduced_config(args.arch or TOKEN_MODELS[args.model])
        loss_fn = TF.node_loss(cfg)

        def init_one(g, gains):
            return TF.init_params(g, cfg, InitConfig("trunc_normal", gains), device=g.device)

        if args.arch:
            # token streams sample windows a batch (no gather schedule): the host-fed loop
            toks = np.stack([make_token_stream(20_000, cfg.vocab_size, seed=args.seed + i) for i in range(n)])
            it = token_batch_iterator(toks, batch_size=args.batch_size, seq_len=64, seed=args.seed)
            return SimpleNamespace(xs=None, ys=None, eval_batch=None, loss_fn=loss_fn, eval_fn=None,
                                   init_one=init_one, batches=lambda: _stacked(it, args.local_batches))
        # windowed token data: xs / ys (n, items, seq) next-token windows, so
        # the executors' schedule gather (and the compressed mix) run a decoder
        seq, items = args.seq_len, args.items_per_node
        win = (np.arange(items) * seq)[:, None] + np.arange(seq + 1)

        def windows(seed):
            t = make_token_stream(items * seq + 1, cfg.vocab_size, seed=seed)[win]
            return t[:, :-1].astype(np.int32), t[:, 1:].astype(np.int32)

        per_node = [windows(args.seed + i) for i in range(n)]
        xs, ys = np.stack([x for x, _ in per_node]), np.stack([y for _, y in per_node])
        ex, ey = windows(args.seed + n)  # a held-out stream on the same window grid
        one = init_one(torch.Generator().manual_seed(0), torch.ones(1))
        n_params = sum(leaf.numel() for _, leaf in tree_leaves(one))
        print(f"token model {cfg.name}: {n_params / 1e6:.2f}M params/node, seq {seq}")
        return SimpleNamespace(xs=xs, ys=ys, eval_batch=(ex[:64], ey[:64]), loss_fn=loss_fn,
                               eval_fn=make_eval_fn(loss_fn), init_one=init_one, batches=None)
    model = args.model or "mlp"
    ds = {"mlp": mnist_like, "cnn": so2sat_like, "vgg16": cifar10_like}[model](
        n * args.items_per_node + 1024, seed=args.seed
    )
    if args.zipf > 0:
        parts = partition_zipf(ds.y[: n * args.items_per_node], n, alpha=args.zipf, seed=args.seed)
    else:
        parts = partition_iid(n * args.items_per_node, n, seed=args.seed)
    xs, ys = node_datasets(ds, parts)
    init_model, forward = {
        "mlp": (init_mlp, mlp_forward),
        "cnn": (lambda c, g: init_cnn(c, g, image_shape=ds.x.shape[1:], n_classes=ds.n_classes), cnn_forward),
        "vgg16": (
            lambda c, g: init_vgg16(c, g, image_shape=ds.x.shape[1:], n_classes=ds.n_classes, width_mult=0.25),
            vgg16_forward,
        ),
    }[model]

    def loss_fn(params, batch):
        return classifier_loss(forward(params, batch[0]), batch[1])

    def init_one(g, gains):
        return init_model(InitConfig("he_normal", gains), g)

    return SimpleNamespace(xs=xs, ys=ys, eval_batch=(ds.x[-1024:], ds.y[-1024:]), loss_fn=loss_fn,
                           eval_fn=make_eval_fn(loss_fn), init_one=init_one,
                           batches=lambda: _stacked(node_batch_iterator(xs, ys, args.batch_size, seed=args.seed),
                                                    args.local_batches))


def _stacked(it, b_local: int):
    """Each round's host batches: ``b_local`` of the iterator's (n, B, ...)
    batches stacked on axis 1, (x (n, b, B, ...), y (n, b, B, ...))."""
    while True:
        bs = [next(it) for _ in range(b_local)]
        yield np.stack([b.x for b in bs], 1), np.stack([b.y for b in bs], 1)


def _run_rounds(args, graph, sched_graphs, mix_plan, n, gain, opt, task, compress_cfg, ckpt_policy, dev):
    """The synchronous paths: the executor (plain or warmup), the elastic
    executor, or the host-fed ``train_loop`` (``--arch``, ``--legacy-loop``).
    Returns (state, history, the plan the rounds mixed over)."""
    round_fn = make_round_fn(
        task.loss_fn, opt, mix_plan, link_p=args.link_p, node_p=args.node_p, device=dev, compression=compress_cfg
    )
    print(f"mixing: {round_fn.plan.backend} backend on {dev}")
    if args.log_every > 0 and not args.chunk_rounds:
        args.chunk_rounds = args.log_every
    eval_every = max(1, args.rounds // 20)

    def stream_rows(r0, r1, h):
        # at a chunk boundary, with the chunk's recorded rounds
        for i, r in enumerate(h["round"]):
            line = f"round {r:4d} train {h['train_loss'][i]:.4f}"
            if h.get("test_loss"):
                line += f" test {h['test_loss'][i]:.4f}"
            if h.get("n_active"):
                line += f" active {h['n_active'][i]:3d}"
            if h.get("wire_bytes"):
                line += f" wire {h['wire_bytes'][i]}B"
            print(line, flush=True)

    stream_hook = stream_rows if args.log_every > 0 else None
    estimate_fn = None
    if args.uncoordinated_init:
        # estimation rides the training links and failure model, on a
        # unit-weight plan (the Eq. 3 send operator); over a topology
        # schedule the gossip itself follows the dynamic graph
        fm = FailureModel(link_p=args.link_p, node_p=args.node_p)
        if sched_graphs is not None:
            est_plan = compile_schedule(sched_graphs, failures=fm, round_map=cyclic_map(args.plan_period), device=dev)
        else:
            est_plan = compile_plan(graph, failures=fm, device=dev)
        estimate_fn = make_gain_estimator(
            est_plan, pi_rounds=args.estimate_rounds, ps_rounds=args.estimate_rounds,
            mode=args.estimate_mode, leaderless=args.leaderless,
        )
    if args.arch or args.legacy_loop:
        if estimate_fn is None:
            state = init_fl_state(args.seed, n, task.init_one, opt, gains=gain, device=dev)
        else:
            est_seed, init_seed = split_seed(args.seed, 2)
            gains = estimate_fn(est_seed)
            _print_gains(gains.cpu().numpy(), estimate_fn, n)
            state = init_fl_state(init_seed, n, task.init_one, opt, gains=gains, device=dev)
        state, hist = train_loop(
            state, round_fn, task.batches(), n_rounds=args.rounds, eval_every=eval_every, eval_fn=task.eval_fn,
            eval_batch=task.eval_batch, track_sigmas=True, progress=True, device=dev,
        )
        return state, hist, round_fn.plan
    sched = batch_index_schedule(
        task.ys.shape[1], n, args.batch_size, args.rounds * args.local_batches, seed=args.seed
    )
    common = dict(
        n_rounds=args.rounds, eval_every=eval_every, eval_fn=task.eval_fn, eval_batch=task.eval_batch,
        track_sigmas=True, b_local=args.local_batches, device=dev,
    )
    if args.elastic:
        state, hist = _run_elastic(args, graph, n, gain, opt, task, round_fn.plan, sched, common, compress_cfg,
                                   ckpt_policy, stream_hook)
        return state, hist, round_fn.plan
    if estimate_fn is not None:
        state, hist, gains = run_warmup_trajectory(
            args.seed, round_fn, task.xs, task.ys, sched, n_nodes=n, init_one=task.init_one, optimizer=opt,
            estimate_gains=estimate_fn, chunk_size=args.chunk_rounds, **common,
        )
        _print_gains(gains, estimate_fn, n)
    else:
        state = init_fl_state(args.seed, n, task.init_one, opt, gains=gain, device=dev)
        state, hist = run_trajectory(state, round_fn, task.xs, task.ys, sched, chunk_size=args.chunk_rounds,
                                     checkpoint=ckpt_policy, resume_from=args.resume, on_chunk=stream_hook, **common)
    if stream_hook is None or estimate_fn is not None:
        # the warmup path has no chunk hook: it prints after the run
        for i, r in enumerate(hist["round"]):
            print(f"round {r:4d} train {hist['train_loss'][i]:.4f} test {hist['test_loss'][i]:.4f}", flush=True)
    return state, hist, round_fn.plan


def _print_gains(gains: np.ndarray, estimate_fn, n: int) -> None:
    line = f"gossip gains: mean={gains.mean():.2f} min={gains.min():.2f} max={gains.max():.2f}"
    if estimate_fn.reached is not None:
        reached = int(estimate_fn.reached.sum())
        line += f"; the leader's mass reached {reached} of {n} nodes"
        if reached < n:
            line += f", the other {n - reached} fall back to gain 1.00"
    print(line)


def _run_elastic(args, graph, n, gain, opt, task, plan, sched, common, compress_cfg, ckpt_policy, stream_hook):
    """The elastic path: the membership (the joining cohort) and the fault
    plan lowered to masks, then ``run_elastic_trajectory``."""
    join_round = args.join_round if args.join_round is not None else args.rounds // 2
    if args.join_nodes:
        mem = membership_schedule(
            n, args.rounds, initial=n - args.join_nodes,
            arrivals={join_round: list(range(n - args.join_nodes, n))}, join_warmup=args.join_warmup,
        )
        print(f"membership: {n - args.join_nodes} initial, {args.join_nodes} arrive at round {join_round} "
              f"(warmup {args.join_warmup})")
    else:
        mem = membership_schedule(n, args.rounds)
    faults = None if args.fault_scenario == "none" else scenario(args.fault_scenario, graph, args.rounds,
                                                                  seed=args.seed)
    if faults is not None:
        print(f"fault plan: {faults.name} ({(~faults.node_up).sum()} node-round outages, "
              f"{(~faults.edge_up).sum()} edge-round cuts)")
    state = init_fl_state(args.seed, n, task.init_one, opt, gains=gain, device=common["device"])
    kw = {k: v for k, v in common.items() if k != "track_sigmas"}
    state, hist, aux = run_elastic_trajectory(
        state, task.loss_fn, opt, plan, mem, task.xs, task.ys, sched, chunk_size=args.chunk_rounds,
        init_one=task.init_one, faults=faults, checkpoint=ckpt_policy, resume_from=args.resume,
        on_chunk=stream_hook, compression=compress_cfg, **kw,
    )
    if stream_hook is None:
        for i, r in enumerate(hist["round"]):
            print(f"round {r:4d} train {hist['train_loss'][i]:.4f} test {hist['test_loss'][i]:.4f} "
                  f"active {hist['n_active'][i]:3d}", flush=True)
    n_hat = aux["n_hat"]
    print(f"online n̂ (true n = {n}): mean {n_hat.mean():.2f}, range [{n_hat.min():.2f}, {n_hat.max():.2f}]")
    return state, hist


def _run_async(args, graph, n, gain, opt, task, compress_cfg, dev):
    """The event-driven path: no round barrier, and with
    ``--uncoordinated-init`` no estimation barrier either.  Returns (state,
    history, the plan the events mixed over)."""
    horizon = args.event_horizon if args.event_horizon is not None else float(args.rounds)
    plan = compile_plan(graph, failures=FailureModel(link_p=args.link_p, node_p=args.node_p), device=dev)
    print(f"mixing: pairwise events on the {plan.backend} plan on {dev}")
    stream = T.poisson_event_stream(graph, horizon=horizon, rate=args.event_rate, seed=args.seed + 2)
    print(f"event stream: {stream.n_events} events over horizon {horizon:g} "
          f"(rate {args.event_rate:g}, {2 * stream.n_events} messages)")
    sched = batch_index_schedule(task.ys.shape[1], n, args.batch_size, max(int(horizon), 1) * args.local_batches,
                                 seed=args.seed)
    if args.uncoordinated_init:
        # leaderless sketches over their own Poisson stream (--estimate-rounds
        # units of virtual time); --estimate-mode and --leaderless do not
        # apply: the event path always sketches, and the gains are n̂^0.5
        est_stream = T.poisson_event_stream(graph, horizon=float(args.estimate_rounds), rate=args.event_rate,
                                            seed=args.seed + 3)
        est_seed, init_seed = split_seed(args.seed, 2)
        gains = gains_from_estimates(estimate_size_leaderless_events(plan, est_stream, est_seed))
        g_np = gains.cpu().numpy()
        print(f"barrier-free leaderless gains (n̂^0.5): mean={g_np.mean():.2f} min={g_np.min():.2f} max={g_np.max():.2f}")
        state = init_fl_state(init_seed, n, task.init_one, opt, gains=gains, device=dev)
    else:
        state = init_fl_state(args.seed, n, task.init_one, opt, gains=gain, device=dev)
    state, hist, _ = run_event_trajectory(
        state, task.loss_fn, opt, plan, stream, task.xs, task.ys, sched, b_local=args.local_batches, n_bins=20,
        eval_fn=task.eval_fn, eval_batch=task.eval_batch, compression=compress_cfg, device=dev,
    )
    for i, t in enumerate(hist["time"]):
        print(f"t={t:8.1f} train {hist['train_loss'][i]:.4f} test {hist['test_loss'][i]:.4f} "
              f"stale {hist['staleness'][i]:.2f} msgs {hist['messages'][i]}", flush=True)
    return state, hist, plan


def _finish(args, state, hist: dict, graph, ckpt_policy, health_plan, dev, argv: list[str]) -> dict:
    if args.ckpt_dir and ckpt_policy is None:
        # the params-only snapshot; with --checkpoint-every the trajectory's
        # checkpoints own the directory (its LATEST must stay resumable)
        path = save_train_state(args.ckpt_dir, int(state.round), state.tree, meta={"graph": graph.name})
        print(f"checkpoint: {path}")
    if args.history_out:
        os.makedirs(os.path.dirname(args.history_out) or ".", exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump(hist, f, indent=1)
        print(f"history: {args.history_out}")
    if args.telemetry:
        n_rec = write_run_log(args.telemetry, telemetry_records(args, state, hist, health_plan, dev, argv))
        print(f"telemetry: {args.telemetry} ({n_rec} records)")
    return hist


def telemetry_records(args, state, hist: dict, health_plan, dev, argv: list[str]) -> list[dict]:
    """The run log, as the JAX launcher composes it: the manifest, one
    record a recorded round (``bin`` under --async), the summary, and the
    gossip health of the plan the run mixed over (a static ``CommPlan``
    only; its failure draws seeded ``seed + 17``)."""
    records = [run_manifest(vars(args), seed=args.seed, argv=argv, device=dev)]
    records += history_rows(hist, kind="bin" if args.async_gossip else "round")
    summary = {"kind": "summary", "rounds_run": int(state.round)}
    if hist.get("train_loss"):
        summary["final_train_loss"] = hist["train_loss"][-1]
    if hist.get("test_loss"):
        summary["final_test_loss"] = hist["test_loss"][-1]
    if hist.get("wire_messages"):
        summary["recorded_wire_messages"] = int(sum(hist["wire_messages"]))
    elif hist.get("messages"):
        summary["recorded_wire_messages"] = int(sum(hist["messages"]))
    if hist.get("wire_bytes"):
        summary["recorded_wire_bytes"] = int(sum(hist["wire_bytes"]))
    records.append(summary)
    if isinstance(health_plan, CommPlan):
        seed = args.seed + 17 if health_plan.failures.active else None
        records.append({"kind": "gossip_health",
                        **gossip_health(health_plan, rounds=min(64, max(16, 2 * args.nodes)), seed=seed)})
    return records


if __name__ == "__main__":
    main()
