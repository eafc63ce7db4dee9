"""Uncoordinated initialisation: estimate → init → train (counterpart of
``examples/uncoordinated_init.py``, paper §4.4).

No node needs to know the network: each derives its own gain
``‖v̂_steady‖⁻¹`` from gossip with its neighbours.  On a random 4-regular
graph whose links drop with probability 0.2 a round, every node

  1. runs the gossip engine (``repro_torch.gossip``) for a budget of
     power-iteration + push-sum rounds, over the failure-prone links the
     training rounds use (one mixing-kernel launch a round on the card),
  2. turns its own noisy estimates into its own init gain,
  3. draws its parameters with that gain and trains

(``run_warmup_trajectory``; the gains stay on the device between the
phases).  Against the perfect-knowledge gain and the unscaled He baseline,
a tiny budget recovers almost all of the benefit.

Run:  python -m repro_torch.examples.uncoordinated_init [--device cpu]
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np

from repro_torch.core import topology as T
from repro_torch.core.commplan import FailureModel, compile_plan
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.core.mixing import spectral_gap
from repro_torch.data import batch_index_schedule, mnist_like, node_datasets
from repro_torch.device import resolve_device
from repro_torch.fed import init_fl_state, make_eval_fn, make_round_fn, run_trajectory, run_warmup_trajectory
from repro_torch.gossip import convergence_report, make_gain_estimator
from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
from repro_torch.optim import sgd

N_NODES, PER_NODE, ROUNDS, B_LOCAL, LINK_P = 16, 128, 40, 4, 0.8
BUDGETS = {"tiny budget (4 rounds)": 4, "converged budget (32 rounds)": 32}


def setup(device=None) -> SimpleNamespace:
    """The graph, data, model, optimizer, training round (link_p 0.8) and the
    estimation plan (the same links and failure model) on ``device``."""
    dev = resolve_device(device)
    graph = T.random_k_regular(N_NODES, 4, seed=0)
    ds = mnist_like(N_NODES * PER_NODE + 512, seed=0)
    parts = [np.arange(i * PER_NODE, (i + 1) * PER_NODE) for i in range(N_NODES)]
    xs, ys = node_datasets(ds, parts)

    def loss_fn(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    def init_one(g, gains):
        return init_mlp(InitConfig("he_normal", gains), g)

    opt = sgd(1e-3, momentum=0.5)
    return SimpleNamespace(
        device=dev, graph=graph, exact_gain=gain_from_graph(graph), xs=xs, ys=ys, init_one=init_one, opt=opt,
        rf=make_round_fn(loss_fn, opt, graph, link_p=LINK_P, device=dev),
        est_plan=compile_plan(graph, failures=FailureModel(link_p=LINK_P), device=dev),
        sched=batch_index_schedule(PER_NODE, N_NODES, 16, ROUNDS * B_LOCAL, seed=0),
        common=dict(n_rounds=ROUNDS, eval_every=10, eval_fn=make_eval_fn(loss_fn), eval_batch=(ds.x[-512:], ds.y[-512:]),
                    b_local=B_LOCAL, device=dev),
    )


def run(device=None) -> dict:
    """The runs, printed; returns ``{label: (history, gains)}`` (each gossip
    budget, then the perfect-knowledge and He runs) and, under ``"report"``,
    the convergence report."""
    q = setup(device)
    print(f"network: {q.graph.name}  spectral gap={spectral_gap(q.graph):.3f}  "
          f"exact ‖v_steady‖⁻¹ = {q.exact_gain:.2f}  link_p={LINK_P}\n")
    # how many gossip rounds does this topology need? ask the diagnostics
    report = convergence_report(q.est_plan, 64, 99)
    print(f"gossip convergence: fitted rate {report['fitted_rate']:.3f} "
          f"(predicted |λ₂| = {report['predicted_rate']:.3f}), 1% error at round {report['rounds_to_1pct']}\n")
    out: dict = {"report": report}
    for label, budget in BUDGETS.items():
        estimate_fn = make_gain_estimator(q.est_plan, pi_rounds=budget, ps_rounds=budget)
        _, hist, gains = run_warmup_trajectory(
            0, q.rf, q.xs, q.ys, q.sched, n_nodes=N_NODES, init_one=q.init_one, optimizer=q.opt,
            estimate_gains=estimate_fn, **q.common,
        )
        out[label] = (hist, gains)
        print(f"{label:28s} per-node gains ∈ [{gains.min():.2f}, {gains.max():.2f}]  "
              f"final test loss {hist['test_loss'][-1]:.3f}")
    for label, gain in (("perfect knowledge", q.exact_gain), ("He baseline (no correction)", 1.0)):
        gains = np.full(N_NODES, gain, np.float32)
        state = init_fl_state(0, N_NODES, q.init_one, q.opt, gains=gains, device=q.device)
        _, hist = run_trajectory(state, q.rf, q.xs, q.ys, q.sched, **q.common)
        out[label] = (hist, gains)
        print(f"{label:28s} gain {gain:.2f}  final test loss {hist['test_loss'][-1]:.3f}")
    return out


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(p.parse_args(argv).device)


if __name__ == "__main__":
    main()
