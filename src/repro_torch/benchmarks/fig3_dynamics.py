"""Figure 3: early-stage dynamics: aggregation dominates training; σ_an
collapses to the noise floor while σ_ap compresses to σ_init‖v_steady‖
(counterpart of ``benchmarks/fig3_dynamics.py``).

(a) magnitude of parameter change due to aggregation vs local training,
(b) σ_an / σ_ap on the real ANN system, (c) the simplified numerical model.

Run:  python -m repro_torch.benchmarks.fig3_dynamics [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import topology as T
from repro_torch.core.commplan import compile_plan
from repro_torch.core.diffusion import run_diffusion
from repro_torch.core.initialisation import InitConfig
from repro_torch.core.mixing import v_steady_norm
from repro_torch.data import mnist_like, node_batch_iterator, node_datasets
from repro_torch.device import resolve_device
from repro_torch.fed import init_fl_state, sigma_metrics
from repro_torch.fed.trainer import _local_steps
from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
from repro_torch.optim import sgd

from .common import driver_main, emit


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(quick: bool = True, device=None) -> None:
    dev = resolve_device(device)
    n, k = (32, 8) if quick else (256, 32)
    graph = T.random_k_regular(n, k, seed=0)

    # ---- (c) numerical model -----------------------------------------
    t0 = time.time()
    res = run_diffusion(graph, d=1024, sigma_noise=1e-4, rounds=150, seed=0, device=dev)
    emit(
        "fig3.numerical_model",
        (time.time() - t0) * 1e6 / 150,
        f"sigma_ap_final={res.sigma_ap[-1]:.4f};prediction={res.sigma_ap_prediction:.4f};"
        f"sigma_an_final={res.sigma_an[-1]:.2e}",
    )

    # ---- (a,b) real ANN system ----------------------------------------
    per_node = 80  # paper: 80 samples/node for this figure
    ds = mnist_like(n * per_node + 128, seed=0)
    parts = [np.arange(i * per_node, (i + 1) * per_node) for i in range(n)]
    xs, ys = node_datasets(ds, parts)

    def loss_fn(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    opt = sgd(1e-3, 0.5)
    # the paper's panel uses the He baseline (gain 1)
    state = init_fl_state(
        0, n, lambda g, gains: init_mlp(InitConfig("he_normal", gains), g, hidden=(128, 64)), opt, device=dev
    )
    plan = compile_plan(graph, "dense", device=dev)
    it = node_batch_iterator(xs, ys, 16, seed=0)

    params, opt_state = state.params.clone(), state.opt_state
    s0 = sigma_metrics(params)
    rounds = 40 if quick else 100
    d_tr_first = d_ag_first = cos_first = None
    t0 = time.time()
    for r in range(rounds):
        b = next(it)
        batch = (torch.as_tensor(b.x, device=dev)[:, None], torch.as_tensor(b.y, device=dev)[:, None])
        before = params.clone() if r == 0 else None  # the local steps update params in place
        trained, opt_state, _ = _local_steps(loss_fn, opt, state.layout, params, opt_state, batch)
        mixed = plan.mix(trained)
        if r == 0:  # each node's change by training and by aggregation
            v1, v2 = trained - before, mixed - trained
            n1, n2 = v1.norm(dim=1), v2.norm(dim=1)
            cos = ((v1 * v2).sum(dim=1) / (n1 * n2 + 1e-12)).mean()
            d_tr_first, d_ag_first, cos_first = float(n1.mean()), float(n2.mean()), float(cos)
        params, opt_state = mixed, opt.init(mixed)  # Algorithm 1 line 15
    _sync(dev)
    spr = (time.time() - t0) / rounds
    s1 = sigma_metrics(params)
    emit(
        "fig3.agg_vs_train_magnitude",
        spr * 1e6,
        f"round0_agg_over_train={d_ag_first / max(d_tr_first, 1e-12):.1f};cos_sim_round0={cos_first:.3f}",
    )
    emit(
        "fig3.ann_sigmas",
        spr * 1e6,
        f"sigma_ap_ratio={float(s1['sigma_ap']) / float(s0['sigma_ap']):.4f};"
        f"v_steady_norm={v_steady_norm(graph):.4f};"
        f"sigma_an_final={float(s1['sigma_an']):.2e}",
    )


main = driver_main(run, __doc__)

if __name__ == "__main__":
    main()
