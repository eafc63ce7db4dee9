"""Topology study: how the communication network shapes DFL (counterpart
of ``examples/topology_study.py``).

For several network families at n = 16 it reports ‖v_steady‖ (the
compression factor, hence the init gain), the spectral gap and the
mixing-time estimate (stabilisation rounds, §4.5), and the final test loss
of a trajectory with the corrected init.

Run:  python -m repro_torch.examples.topology_study [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import mixing as M
from repro_torch.core import topology as T
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.data import mnist_like, node_batch_iterator, node_datasets
from repro_torch.device import resolve_device
from repro_torch.fed import init_fl_state, make_eval_fn, make_round_fn, train_loop
from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
from repro_torch.optim import sgd

N, PER, ROUNDS = 16, 128, 30


def graphs() -> dict[str, T.Graph]:
    return {
        "complete": T.complete(N),
        "4-regular": T.random_k_regular(N, 4, seed=0),
        "barabasi-albert m=4": T.barabasi_albert(N, 4, seed=0),
        "ring": T.ring(N),
        "torus 4x4": T.torus_lattice((4, 4)),
    }


def main(argv: list[str] | None = None) -> dict[str, dict]:
    """Prints one line a topology; returns {name: its row's numbers}."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(p.parse_args(argv).device)

    ds = mnist_like(N * PER + 512, seed=0)
    parts = [np.arange(i * PER, (i + 1) * PER) for i in range(N)]
    xs, ys = node_datasets(ds, parts)
    test = (ds.x[-512:], ds.y[-512:])

    def loss_fn(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    opt = sgd(1e-3, 0.5)
    eval_fn = make_eval_fn(loss_fn)

    def batches():
        it = node_batch_iterator(xs, ys, 16, seed=0)
        while True:
            bs = [next(it) for _ in range(4)]
            yield np.stack([b.x for b in bs], 1), np.stack([b.y for b in bs], 1)

    rows = {}
    print(f"{'topology':22s} {'‖v_steady‖':>11s} {'gain':>6s} {'gap':>7s} {'t_mix':>6s}  final test loss")
    for name, graph in graphs().items():
        vnorm, gain = M.v_steady_norm(graph), gain_from_graph(graph)
        gap, tmix = M.spectral_gap(graph), M.mixing_time_estimate(graph)
        state = init_fl_state(
            0, N, lambda g, gains: init_mlp(InitConfig("he_normal", gains), g), opt, gains=gain, device=dev
        )
        _, hist = train_loop(
            state, make_round_fn(loss_fn, opt, graph, device=dev), batches(), n_rounds=ROUNDS,
            eval_every=ROUNDS - 1, eval_fn=eval_fn, eval_batch=test, device=dev,
        )
        rows[name] = dict(vnorm=vnorm, gain=gain, gap=gap, t_mix=tmix, final=hist["test_loss"][-1])
        print(f"{name:22s} {vnorm:11.4f} {gain:6.2f} {gap:7.4f} {tmix:6.1f}  {hist['test_loss'][-1]:.4f}")
    return rows


if __name__ == "__main__":
    main()
