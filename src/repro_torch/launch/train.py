"""Training launcher of the port: the paper's synchronous MLP path on the card.

Examples:
    python -m repro_torch.launch.train --model mlp --nodes 16 --rounds 100
    python -m repro_torch.launch.train --model mlp --topology ring --nodes 1024 --rounds 3
    python -m repro_torch.launch.train --model mlp --no-gain-correction   # Fig. 1 baseline
    python -m repro_torch.launch.train --model mlp --device cpu --nodes 4 --rounds 2

Runs on ``cuda`` unless ``--device cpu`` is given; the mixing rounds go
through the hand-written kernels there (dense for n ≤ 64, block-sparse
beyond).  Other models and the JAX launcher's other modes (async, elastic,
compressed, schedules, checkpointing, telemetry) are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.core import topology as T
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.data import batch_index_schedule, mnist_like, node_datasets, partition_iid
from repro_torch.device import resolve_device
from repro_torch.fed import init_fl_state, make_eval_fn, make_round_fn, run_trajectory
from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
from repro_torch.optim import adamw, sgd

MODELS = ["mlp", "cnn", "vgg16", "transformer", "moe", "rwkv"]
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
    p.add_argument("--local-batches", type=int, default=8)
    p.add_argument("--link-p", type=float, default=1.0)
    p.add_argument("--node-p", type=float, default=1.0)
    p.add_argument("--no-gain-correction", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--history-out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args, rest = p.parse_known_args(argv)
    if rest:
        p.error(f"{' '.join(rest)} {NOT_PORTED}")
    if args.model != "mlp":
        p.error(f"--model {args.model} {NOT_PORTED}")
    dev = resolve_device(args.device)

    n = args.nodes
    graph = build_graph(args.topology, n, args.seed)
    gain = 1.0 if args.no_gain_correction else gain_from_graph(graph)
    print(f"graph={graph.name} ‖v_steady‖⁻¹ gain={gain:.2f}" + (" (DISABLED)" if args.no_gain_correction else ""))
    opt = sgd(1e-3, 0.5) if args.optimizer == "sgd" else adamw(1e-3)

    ds = mnist_like(n * args.items_per_node + 1024, seed=args.seed)
    parts = partition_iid(n * args.items_per_node, n, seed=args.seed)
    xs, ys = node_datasets(ds, parts)
    eval_batch = (ds.x[-1024:], ds.y[-1024:])

    def loss_fn(params, batch):
        return classifier_loss(mlp_forward(params, batch[0]), batch[1])

    round_fn = make_round_fn(loss_fn, opt, graph, link_p=args.link_p, node_p=args.node_p, device=dev)
    print(f"mixing: {round_fn.plan.backend} backend on {dev}")
    state = init_fl_state(
        args.seed, n, lambda g, gains: init_mlp(InitConfig("he_normal", gains), g), opt,
        gains=gain, device=dev,
    )
    sched = batch_index_schedule(
        ys.shape[1], n, args.batch_size, args.rounds * args.local_batches, seed=args.seed
    )
    state, hist = run_trajectory(
        state, round_fn, xs, ys, sched, n_rounds=args.rounds,
        eval_every=max(1, args.rounds // 20), eval_fn=make_eval_fn(loss_fn),
        eval_batch=eval_batch, track_sigmas=True, b_local=args.local_batches, device=dev,
    )
    for i, r in enumerate(hist["round"]):
        print(f"round {r:4d} train {hist['train_loss'][i]:.4f} test {hist['test_loss'][i]:.4f}", flush=True)
    if args.history_out:
        os.makedirs(os.path.dirname(args.history_out) or ".", exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump(hist, f, indent=1)
        print(f"history: {args.history_out}")
    return hist


if __name__ == "__main__":
    main()
