"""Live-serving launcher of the port: train and serve concurrently under Poisson traffic.

An open-loop Poisson load generator (``--qps``) fires synthetic queries at
the nodes of an event-driven DFL run of the paper's MLP (full width,
d = 567,434); gossip and query events ride one merged envelope through
``fed.serve.run_serve_trajectory``, with no barrier between training and
answering.  The router policy (``--router``) decides which node's
*current* parameters answer each query, trading staleness against
locality and queueing (``fed.router.make_router``); the answer is the
routed node's predicted class for a test image.

Examples:
    python -m repro_torch.launch.serve --nodes 16 --topology ring --horizon 30 \\
        --qps 8 --router consensus --staleness-budget 2.0
    python -m repro_torch.launch.serve --qps 4 --router uniform
    python -m repro_torch.launch.serve --device cpu --nodes 4 --horizon 3 --per-node 16

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--telemetry`` (the
JSONL run log, with ``--log-queries`` per-query records) is not ported yet
(ROADMAP.md Queue 1 item 14).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import topology as T
from repro_torch.core.commplan import FailureModel, compile_plan
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.data import batch_index_schedule, mnist_like, node_datasets
from repro_torch.device import resolve_device
from repro_torch.fed import init_fl_state, make_eval_fn, make_router, run_serve_trajectory, serve_summary
from repro_torch.fed.router import ROUTER_POLICIES, poisson_query_stream
from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
from repro_torch.optim import sgd

from .train import NOT_PORTED

TOPOLOGIES = ("ring", "kreg", "ba", "complete")


def build_graph(name: str, n: int, seed: int) -> T.Graph:
    if name == "ring":
        return T.ring(n)
    if name == "kreg":
        return T.random_k_regular(n, min(8, n - 1), seed=seed)
    if name == "ba":
        return T.barabasi_albert(n, 4, seed=seed)
    if name == "complete":
        return T.complete(n)
    raise ValueError(f"unknown topology {name!r} (choose from {TOPOLOGIES})")


def main(argv: list[str] | None = None) -> tuple[dict, dict]:
    """Run the CLI; returns (the history, the summary printed)."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nodes", type=int, default=16)
    p.add_argument("--topology", type=str, default="ring", choices=TOPOLOGIES)
    p.add_argument("--horizon", type=float, default=30.0, help="virtual-time span (≈ rounds)")
    p.add_argument("--rate", type=float, default=1.0, help="per-edge gossip clock rate")
    p.add_argument("--qps", type=float, default=4.0, help="open-loop query arrival rate")
    p.add_argument("--router", type=str, default="consensus", choices=ROUTER_POLICIES)
    p.add_argument("--staleness-budget", type=float, default=float("inf"))
    p.add_argument("--locality-weight", type=float, default=0.1)
    p.add_argument("--queue-weight", type=float, default=1.0)
    p.add_argument("--service-time", type=float, default=0.2, help="virtual seconds per answer")
    p.add_argument("--hop-latency", type=float, default=0.05, help="virtual seconds per hop")
    p.add_argument("--skew", type=float, default=0.0, help="home-node rank skew (0 = uniform)")
    p.add_argument("--per-node", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--local-batches", type=int, default=2)
    p.add_argument("--bins", type=int, default=10)
    p.add_argument("--link-p", type=float, default=1.0)
    p.add_argument("--test-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--telemetry", type=str, default=None, help="write a JSONL run log here (not ported yet)")
    p.add_argument("--log-queries", type=int, default=200,
                   help="max per-query records in the run log (0 = none; only with --telemetry)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.telemetry:
        p.error(f"--telemetry {NOT_PORTED} item 14 (the run log of obs/export.py)")
    dev = resolve_device(args.device)

    n = args.nodes
    graph = build_graph(args.topology, n, args.seed)
    ds = mnist_like(n * args.per_node + args.test_size, seed=args.seed)
    parts = [np.arange(i * args.per_node, (i + 1) * args.per_node) for i in range(n)]
    xs, ys = node_datasets(ds, parts)
    test = (ds.x[-args.test_size :], ds.y[-args.test_size :])

    def loss_fn(params, batch):
        return classifier_loss(mlp_forward(params, batch[0]), batch[1])

    def init_one(g, gains):
        return init_mlp(InitConfig("he_normal", gains), g)

    # answers: the routed node's predicted class for the query image
    def serve_fn(params, x):
        return torch.argmax(mlp_forward(params, x[None]), dim=-1)[0]

    opt = sgd(1e-3, 0.5)
    state = init_fl_state(args.seed, n, init_one, opt, gains=gain_from_graph(graph), device=dev)
    plan = compile_plan(graph, failures=FailureModel(link_p=args.link_p), device=dev)
    stream = T.poisson_event_stream(graph, horizon=args.horizon, rate=args.rate, seed=args.seed + 1)
    queries = poisson_query_stream(n, args.horizon, args.qps, seed=args.seed + 2, pool=args.test_size,
                                   skew=args.skew)
    router = make_router(graph, args.router, staleness_budget=args.staleness_budget,
                         locality_weight=args.locality_weight, queue_weight=args.queue_weight)
    sched = batch_index_schedule(args.per_node, n, args.batch_size,
                                 max(int(args.horizon), 1) * args.local_batches, seed=args.seed)

    print(
        f"serving {queries.n_queries} queries (qps={args.qps}) over {stream.n_events} gossip events "
        f"({args.topology}, n={n}, horizon={args.horizon}, router={args.router}) on {dev}"
    )
    t0 = time.perf_counter()
    final, hist, serve, aux = run_serve_trajectory(
        state, loss_fn, opt, plan, stream, queries, router, xs, ys, sched, b_local=args.local_batches,
        n_bins=args.bins, eval_fn=make_eval_fn(loss_fn), eval_batch=test, service_time=args.service_time,
        hop_latency=args.hop_latency, serve_fn=serve_fn, query_xs=test[0], device=dev,
    )
    wall = time.perf_counter() - t0  # the history and answers are read back at the end: the card has finished
    summ = serve_summary(serve)
    summ["train_loss_final"] = float(hist["train_loss"][-1])
    summ["test_loss_final"] = float(hist["test_loss"][-1])
    summ["queries_per_sec_wall"] = summ["served"] / max(wall, 1e-9)
    for k, v in summ.items():
        print(f"  {k}: {v:.4g}" if isinstance(v, float) else f"  {k}: {v}")
    return hist, summ


if __name__ == "__main__":
    main()
