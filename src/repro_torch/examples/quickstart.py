"""Quickstart: the paper's effect in one run (counterpart of ``examples/quickstart.py``).

Trains a 16-node decentralised federated MLP on synthetic MNIST-like data
with plain He initialisation (the paper's Fig. 1 dashed baseline, which
plateaus) and with the proposed ‖v_steady‖⁻¹ gain-corrected initialisation,
and prints both test-loss trajectories.  Both runs share one upload of the
data through ``repro_torch.fed.run_sweep``; every round's DecAvg mix is one
launch of the dense mixing kernel on the card.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np

from repro_torch.core import topology as T
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.data import batch_index_schedule, mnist_like, node_datasets
from repro_torch.device import resolve_device
from repro_torch.fed import init_fl_state, make_eval_fn, make_round_fn, run_sweep
from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
from repro_torch.optim import sgd

N_NODES, PER_NODE, ROUNDS, B_LOCAL = 16, 128, 40, 4
VARIANTS = ("He et al. (uncorrected)", "proposed (gain-corrected)")


def setup(device=None) -> SimpleNamespace:
    """The graph, data, model, optimizer and the two initial ensembles (He,
    gain-corrected) on ``device`` (default cuda)."""
    dev = resolve_device(device)
    graph = T.complete(N_NODES)  # paper cfg. A: fully-connected communication
    gain = gain_from_graph(graph)
    ds = mnist_like(N_NODES * PER_NODE + 512, seed=0)
    parts = [np.arange(i * PER_NODE, (i + 1) * PER_NODE) for i in range(N_NODES)]
    xs, ys = node_datasets(ds, parts)

    def loss_fn(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    opt = sgd(1e-3, momentum=0.5)
    states = [
        init_fl_state(0, N_NODES, lambda g, gains: init_mlp(InitConfig("he_normal", gains), g), opt,
                      gains=gv, device=dev)
        for gv in (1.0, gain)
    ]
    return SimpleNamespace(
        device=dev, graph=graph, gain=gain, xs=xs, ys=ys, test=(ds.x[-512:], ds.y[-512:]), loss_fn=loss_fn,
        opt=opt, eval_fn=make_eval_fn(loss_fn), states=states,
        schedule=batch_index_schedule(PER_NODE, N_NODES, 16, ROUNDS * B_LOCAL, seed=0),
    )


def run(device=None) -> tuple[float, list[dict]]:
    """The two trajectories, printed; returns (gain, [He history, corrected history])."""
    q = setup(device)
    print(f"communication network: {q.graph.name};  ‖v_steady‖⁻¹ gain = {q.gain:.2f}\n")
    _, hists = run_sweep(
        q.states, make_round_fn(q.loss_fn, q.opt, q.graph, device=q.device), q.xs, q.ys, q.schedule,
        n_rounds=ROUNDS, eval_every=5, eval_fn=q.eval_fn, eval_batch=q.test, b_local=B_LOCAL, device=q.device,
    )
    for label, hist in zip(VARIANTS, hists):
        traj = "  ".join(f"{v:.3f}" for v in hist["test_loss"])
        print(f"{label:28s} test loss @ rounds {hist['round']}:\n    {traj}\n")
    print("note the plateau at log(10) ≈ 2.303 without the correction (paper Fig. 1).")
    return q.gain, hists


def main(argv: list[str] | None = None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(p.parse_args(argv).device)[1]


if __name__ == "__main__":
    main()
