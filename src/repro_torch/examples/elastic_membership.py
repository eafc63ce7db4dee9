"""Elastic membership (counterpart of ``examples/elastic_membership.py``):
a 16-node k-regular swarm where 4 nodes arrive at round 50, re-derive the
network size online with leaderless sketches, and initialise
uncoordinated mid-run; then the same trajectory checkpointed at every
chunk and run again with ``resume_from``.

Run:  python -m repro_torch.examples.elastic_membership [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core import topology as T
from repro_torch.core.commplan import compile_plan
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.core.membership import membership_schedule
from repro_torch.data import batch_index_schedule, mnist_like, node_datasets
from repro_torch.device import resolve_device
from repro_torch.fed import CheckpointPolicy, init_fl_state, make_eval_fn, run_elastic_trajectory
from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
from repro_torch.optim import sgd

N, JOIN, PER, ROUNDS, JOIN_ROUND, WARMUP = 16, 4, 128, 100, 50, 8


def setup(device=None) -> SimpleNamespace:
    """The graph, plan, data, model, membership and the run's keywords on ``device``."""
    dev = resolve_device(device)
    graph = T.random_k_regular(N, 6, seed=0)
    ds = mnist_like(N * PER + 512, seed=0)
    parts = [np.arange(i * PER, (i + 1) * PER) for i in range(N)]
    xs, ys = node_datasets(ds, parts)

    def loss_fn(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    def init_one(g, gains):
        return init_mlp(InitConfig("he_normal", gains), g)

    # initial members use the perfect-knowledge gain; the late cohort gets NO
    # coordination: each joiner sketches n̂ over the live gossip population
    # during warmup and initialises from its own estimate (√n̂, §4.4 size-only)
    mem = membership_schedule(N, ROUNDS, initial=N - JOIN, arrivals={JOIN_ROUND: list(range(N - JOIN, N))},
                              join_warmup=WARMUP)
    kw = dict(n_rounds=ROUNDS, eval_every=10, eval_fn=make_eval_fn(loss_fn), eval_batch=(ds.x[-512:], ds.y[-512:]),
              b_local=2, chunk_size=25, init_one=init_one, device=dev)
    return SimpleNamespace(device=dev, graph=graph, plan=compile_plan(graph, device=dev), gain=gain_from_graph(graph),
                           xs=xs, ys=ys, loss_fn=loss_fn, init_one=init_one, opt=sgd(1e-3, 0.5), mem=mem,
                           sched=batch_index_schedule(PER, N, 16, ROUNDS * 2, seed=0), kw=kw)


def _state(q):
    return init_fl_state(0, N, q.init_one, q.opt, gains=q.gain, device=q.device)


def run(device=None) -> dict:
    """The elastic run and the checkpoint / resume part, printed as the JAX
    example does; returns ``{final, hist, aux, resumed, bit}``."""
    q = setup(device)
    print(f"{N - JOIN} nodes train from round 0; {JOIN} arrive at round {JOIN_ROUND}, init at round "
          f"{JOIN_ROUND + WARMUP}")
    final, hist, aux = run_elastic_trajectory(_state(q), q.loss_fn, q.opt, q.plan, q.mem, q.xs, q.ys, q.sched, **q.kw)
    for i, r in enumerate(hist["round"]):
        print(f"round {r:3d}  train {hist['train_loss'][i]:.3f}  test {hist['test_loss'][i]:.3f}  "
              f"active {hist['n_active'][i]:2d}")
    print(f"final online n̂ (true n = {N}): mean {aux['n_hat'].mean():.1f}, spread "
          f"[{aux['n_hat'].min():.1f}, {aux['n_hat'].max():.1f}]")

    # ---- the same trajectory, checkpointed at every chunk, run again with resume_from
    with tempfile.TemporaryDirectory() as d:
        run_elastic_trajectory(_state(q), q.loss_fn, q.opt, q.plan, q.mem, q.xs, q.ys, q.sched,
                               checkpoint=CheckpointPolicy(d, every=1), **q.kw)
        # the JAX example passes the round-50 step *file*: a path with no
        # LATEST, so this run starts fresh and the comparison is of two
        # whole runs (a resume from the directory: the port's tests)
        resumed, h2, _ = run_elastic_trajectory(_state(q), q.loss_fn, q.opt, q.plan, q.mem, q.xs, q.ys, q.sched,
                                                resume_from=os.path.join(d, "step_00000001.ckpt"), **q.kw)
    bit = torch.equal(final.params, resumed.params) and h2 == hist
    print(f"restart at round 50 → resume: bit-identical = {bit}")
    return {"final": final, "hist": hist, "aux": aux, "resumed": resumed, "bit": bit}


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(p.parse_args(argv).device)


if __name__ == "__main__":
    main()
