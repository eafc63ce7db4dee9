"""Failure resilience (paper Fig. 2; counterpart of ``examples/failure_resilience.py``):
every link or node is active with probability p a round; inactive nodes
keep training locally.  He and the proposed gain, host-fed rounds
(``train_loop``).

Run:  python -m repro_torch.examples.failure_resilience [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import topology as T
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.data import mnist_like, node_batch_iterator, node_datasets
from repro_torch.device import resolve_device
from repro_torch.fed import init_fl_state, make_eval_fn, make_round_fn, train_loop
from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
from repro_torch.optim import sgd

N, PER, ROUNDS = 16, 128, 30
PS = (0.2, 0.5, 1.0)


def run(device=None) -> dict[tuple[str, float], dict[str, float]]:
    """Final test losses ``{(mode, p): {"he": ..., "proposed": ...}}``, printed as a table."""
    dev = resolve_device(device)
    graph = T.complete(N)
    ds = mnist_like(N * PER + 512, seed=0)
    xs, ys = node_datasets(ds, [np.arange(i * PER, (i + 1) * PER) for i in range(N)])
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

    print(f"{'failure mode':16s} {'p':>5s} {'He final':>9s} {'proposed final':>15s}")
    out = {}
    for mode in ("link", "node"):
        for p in PS:
            finals = {}
            for label, gain in (("he", 1.0), ("proposed", gain_from_graph(graph))):
                kw = {"link_p": p} if mode == "link" else {"node_p": p}
                state = init_fl_state(0, N, lambda g, gains: init_mlp(InitConfig("he_normal", gains), g), opt,
                                      gains=gain, device=dev)
                _, hist = train_loop(
                    state, make_round_fn(loss_fn, opt, graph, device=dev, **kw), batches(), n_rounds=ROUNDS,
                    eval_every=ROUNDS - 1, eval_fn=eval_fn, eval_batch=test, device=dev,
                )
                finals[label] = hist["test_loss"][-1]
            out[(mode, p)] = finals
            print(f"{mode:16s} {p:5.2f} {finals['he']:9.3f} {finals['proposed']:15.3f}")
    return out


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(p.parse_args(argv).device)


if __name__ == "__main__":
    main()
