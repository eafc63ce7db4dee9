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

Runs on ``cuda`` unless ``--device cpu`` is given; the mixing rounds go
through the hand-written kernels there (dense for n ≤ 64, block-sparse
beyond; an int8 / fp8 round is one pass of the quantised-mix kernel).
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
Full-width VGG16 is reached through the API (``init_vgg16(width_mult=1.0)``).
The token models and the JAX launcher's other modes (elastic,
checkpointing, telemetry) are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.core import topology as T
from repro_torch.core.commplan import FailureModel, compile_plan, compile_schedule, cyclic_map
from repro_torch.core.compress import Compression
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.data import (
    batch_index_schedule,
    cifar10_like,
    mnist_like,
    node_datasets,
    partition_iid,
    partition_zipf,
    so2sat_like,
)
from repro_torch.device import resolve_device
from repro_torch.fed import (
    init_fl_state,
    make_eval_fn,
    make_round_fn,
    run_event_trajectory,
    run_trajectory,
    run_warmup_trajectory,
)
from repro_torch.gossip import estimate_size_leaderless_events, gains_from_estimates, make_gain_estimator, split_seed
from repro_torch.models.paper_models import (
    classifier_loss,
    cnn_forward,
    init_cnn,
    init_mlp,
    init_vgg16,
    mlp_forward,
    vgg16_forward,
)
from repro_torch.optim import adamw, sgd

MODELS = ["mlp", "cnn", "vgg16", "transformer", "moe", "rwkv"]
PAPER_MODELS = ("mlp", "cnn", "vgg16")
NOT_PORTED = "is not yet ported to the PyTorch launcher; see ROADMAP.md Queue 1"


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


def main(argv: list[str] | None = None) -> dict[str, list]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=MODELS, default="mlp")
    p.add_argument("--nodes", type=int, default=16)
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--topology", choices=["full", "kregular", "ba", "er", "ring", "circulant"], default="full")
    p.add_argument("--optimizer", choices=["sgd", "adamw"], default="sgd")
    p.add_argument("--items-per-node", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--zipf", type=float, default=0.0,
                   help="non-iid label skew: Zipf exponent α of each node's class preference (0 = iid)")
    p.add_argument("--local-batches", type=int, default=8)
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
    p.add_argument("--chunk-rounds", type=int, default=0, help="executor chunk size in rounds (0 = auto)")
    p.add_argument("--log-every", type=int, default=0,
                   help="print the recorded metrics every N rounds at chunk boundaries instead of after the "
                   "run (sets the chunk size unless --chunk-rounds is given)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--history-out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args, rest = p.parse_known_args(argv)
    if rest:
        p.error(f"{' '.join(rest)} {NOT_PORTED}")
    if args.model not in PAPER_MODELS:
        p.error(f"--model {args.model} {NOT_PORTED}")
    if args.uncoordinated_init and args.no_gain_correction:
        p.error("--uncoordinated-init estimates (and applies) per-node gains; "
                "it contradicts --no-gain-correction — pick one")
    if args.async_gossip:
        if args.topology_schedule != "static":
            p.error("--async needs a static topology: realise dynamics as per-edge "
                    "clock rates (poisson_event_stream) rather than a PlanSchedule")
        if args.uncoordinated_init and args.estimate_mode == "degree":
            p.error("--async estimation is barrier-free leaderless sketching; "
                    "degree polling needs the round-based walker — drop "
                    "--estimate-mode degree or drop --async")
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

    ds = {"mlp": mnist_like, "cnn": so2sat_like, "vgg16": cifar10_like}[args.model](
        n * args.items_per_node + 1024, seed=args.seed
    )
    if args.zipf > 0:
        parts = partition_zipf(ds.y[: n * args.items_per_node], n, alpha=args.zipf, seed=args.seed)
    else:
        parts = partition_iid(n * args.items_per_node, n, seed=args.seed)
    xs, ys = node_datasets(ds, parts)
    eval_batch = (ds.x[-1024:], ds.y[-1024:])
    init_model, forward = {
        "mlp": (init_mlp, mlp_forward),
        "cnn": (lambda c, g: init_cnn(c, g, image_shape=ds.x.shape[1:], n_classes=ds.n_classes), cnn_forward),
        "vgg16": (
            lambda c, g: init_vgg16(c, g, image_shape=ds.x.shape[1:], n_classes=ds.n_classes, width_mult=0.25),
            vgg16_forward,
        ),
    }[args.model]

    def loss_fn(params, batch):
        return classifier_loss(forward(params, batch[0]), batch[1])

    def init_one(g, gains):
        return init_model(InitConfig("he_normal", gains), g)

    eval_fn = make_eval_fn(loss_fn)
    if args.async_gossip:
        hist = _run_async(args, graph, n, gain, opt, loss_fn, eval_fn, init_one, xs, ys, eval_batch, compress_cfg, dev)
        return _finish(args, hist)
    round_fn = make_round_fn(
        loss_fn, opt, mix_plan, link_p=args.link_p, node_p=args.node_p, device=dev, compression=compress_cfg
    )
    print(f"mixing: {round_fn.plan.backend} backend on {dev}")
    if args.log_every > 0 and not args.chunk_rounds:
        args.chunk_rounds = args.log_every

    def stream_rows(r0, r1, h):
        # at a chunk boundary, with the chunk's recorded rounds
        for i, r in enumerate(h["round"]):
            line = f"round {r:4d} train {h['train_loss'][i]:.4f} test {h['test_loss'][i]:.4f}"
            if h.get("wire_bytes"):
                line += f" wire {h['wire_bytes'][i]}B"
            print(line, flush=True)

    stream_hook = stream_rows if args.log_every > 0 else None

    sched = batch_index_schedule(
        ys.shape[1], n, args.batch_size, args.rounds * args.local_batches, seed=args.seed
    )
    common = dict(
        n_rounds=args.rounds, eval_every=max(1, args.rounds // 20), eval_fn=eval_fn,
        eval_batch=eval_batch, track_sigmas=True, b_local=args.local_batches, device=dev,
    )
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
        state, hist, gains = run_warmup_trajectory(
            args.seed, round_fn, xs, ys, sched, n_nodes=n, init_one=init_one, optimizer=opt,
            estimate_gains=estimate_fn, **common,
        )
        line = f"gossip gains: mean={gains.mean():.2f} min={gains.min():.2f} max={gains.max():.2f}"
        if estimate_fn.reached is not None:
            reached = int(estimate_fn.reached.sum())
            line += f"; the leader's mass reached {reached} of {n} nodes"
            if reached < n:
                line += f", the other {n - reached} fall back to gain 1.00"
        print(line)
    else:
        state = init_fl_state(args.seed, n, init_one, opt, gains=gain, device=dev)
        state, hist = run_trajectory(state, round_fn, xs, ys, sched, chunk_size=args.chunk_rounds,
                                     on_chunk=stream_hook, **common)
    if stream_hook is None or args.uncoordinated_init:
        # the warmup path has no chunk hook: it prints after the run
        for i, r in enumerate(hist["round"]):
            print(f"round {r:4d} train {hist['train_loss'][i]:.4f} test {hist['test_loss'][i]:.4f}", flush=True)
    return _finish(args, hist)


def _run_async(args, graph, n, gain, opt, loss_fn, eval_fn, init_one, xs, ys, eval_batch, compress_cfg, dev):
    """The event-driven path: no round barrier, and with
    ``--uncoordinated-init`` no estimation barrier either."""
    horizon = args.event_horizon if args.event_horizon is not None else float(args.rounds)
    plan = compile_plan(graph, failures=FailureModel(link_p=args.link_p, node_p=args.node_p), device=dev)
    print(f"mixing: pairwise events on the {plan.backend} plan on {dev}")
    stream = T.poisson_event_stream(graph, horizon=horizon, rate=args.event_rate, seed=args.seed + 2)
    print(f"event stream: {stream.n_events} events over horizon {horizon:g} "
          f"(rate {args.event_rate:g}, {2 * stream.n_events} messages)")
    sched = batch_index_schedule(ys.shape[1], n, args.batch_size, max(int(horizon), 1) * args.local_batches,
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
        state = init_fl_state(init_seed, n, init_one, opt, gains=gains, device=dev)
    else:
        state = init_fl_state(args.seed, n, init_one, opt, gains=gain, device=dev)
    _, hist, _ = run_event_trajectory(
        state, loss_fn, opt, plan, stream, xs, ys, sched, b_local=args.local_batches, n_bins=20, eval_fn=eval_fn,
        eval_batch=eval_batch, compression=compress_cfg, device=dev,
    )
    for i, t in enumerate(hist["time"]):
        print(f"t={t:8.1f} train {hist['train_loss'][i]:.4f} test {hist['test_loss'][i]:.4f} "
              f"stale {hist['staleness'][i]:.2f} msgs {hist['messages'][i]}", flush=True)
    return hist


def _finish(args, hist: dict) -> dict:
    if args.history_out:
        os.makedirs(os.path.dirname(args.history_out) or ".", exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump(hist, f, indent=1)
        print(f"history: {args.history_out}")
    return hist


if __name__ == "__main__":
    main()
