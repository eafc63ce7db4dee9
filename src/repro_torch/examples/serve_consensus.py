"""End-to-end train → route → serve (counterpart of ``examples/serve_consensus.py``).

DFL-trains a reduced qwen2.5-3b decoder on synthetic token streams (8
nodes, random 4-regular graph, gain-corrected truncated-normal init, AdamW
3e-3, one local step a round through ``make_round_fn`` + ``train_loop``;
each round's DecAvg mix is one launch of the mixing kernel over the (8, d)
flat buffer), then serves a batch of generation requests two ways:

1. **consensus serving** — average the node ensemble into one artifact
   (``consensus_params``) and answer everything from it through the
   prefill → KV-insert → decode ``ServeEngine`` (each prefill attention
   layer one flash kernel launch on the card);
2. **ensemble serving** — keep the per-node parameters and let a
   ``Router`` assign each query a serving node (the consensus policy with
   equal clocks, which degrades to nearest-by-hops), answered through
   ``ServeEngine.serve``.

The two answer sets differ only by consensus noise.  The training steps
run the decoder's plain attention (the kernels have no backward); serving
runs flash.  The init is drawn on the CPU and moved, so a run on the card
and one on the CPU start from the same parameters.  For serving
interleaved with training, see ``python -m repro_torch.launch.serve``.

Run:  python -m repro_torch.examples.serve_consensus [--device cpu]
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.core import topology as T
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.data import make_token_stream, token_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.fed import (
    DFLState, ServeEngine, consensus_params, init_fl_state, make_round_fn, make_router, train_loop,
)
from repro_torch.flat import tree_map
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw

N_NODES, ROUNDS, SEQ, BATCH, N_NEW = 8, 30, 48, 8, 16
AUX_WEIGHT = 0.01  # the MoE load-balance term's weight, as the JAX example (0 aux here: no MoE layer)


def node_loss(cfg):
    """The DFL trainer's loss for the decoder: ``loss_fn(node_params, (x,
    y))`` with node-stacked views (every leaf ``(n, ...)``) and tokens x,
    targets y ``(n, B, S)`` → the ``(n,)`` per-node ``lm_loss + 0.01 ·
    aux``, one forward a node on its own parameters (the JAX example vmaps
    the same function over the nodes)."""

    def loss_fn(node_params, batch) -> torch.Tensor:
        x, y = batch
        out = []
        for i in range(x.shape[0]):
            p = tree_map(lambda t: t[i], node_params)
            hidden, aux = TF.forward(p, cfg, x[i])
            out.append(TF.lm_loss(p, cfg, hidden, y[i]) + AUX_WEIGHT * aux)
        return torch.stack(out)

    return loss_fn


def setup(device=None) -> SimpleNamespace:
    """The config, graph, init gain, optimizer, loss and the initial state
    on ``device`` (drawn on the CPU, seed 0)."""
    dev = resolve_device(device)
    cfg = get_reduced_config("qwen2.5-3b")
    graph = T.random_k_regular(N_NODES, 4, seed=0)
    gain = gain_from_graph(graph)
    opt = adamw(3e-3)

    def init_one(g, gains):
        return TF.init_params(g, cfg, InitConfig("trunc_normal", gains), device=g.device)

    state = init_fl_state(0, N_NODES, init_one, opt, gains=gain, device="cpu")
    state = DFLState(params=state.params.to(dev), opt_state=type(state.opt_state)(*(f.to(dev) for f in state.opt_state)),
                     layout=state.layout, round=state.round, generator=state.generator)
    return SimpleNamespace(device=dev, cfg=cfg, graph=graph, gain=gain, opt=opt, state=state,
                           loss_fn=node_loss(cfg))


def batches(cfg):
    """Each round's (x, y), (n, 1, B, S): one local batch of token windows a node."""
    toks = np.stack([make_token_stream(20_000, cfg.vocab_size, seed=i) for i in range(N_NODES)])
    it = token_batch_iterator(toks, batch_size=BATCH, seq_len=SEQ, seed=0)
    while True:
        b = next(it)
        yield b.x[:, None], b.y[:, None]


def train(q: SimpleNamespace, rounds: int | None = None):
    """``rounds`` (default ``ROUNDS``) DecAvg rounds from ``q.state``:
    (final state, history)."""
    round_fn = make_round_fn(q.loss_fn, q.opt, q.graph, device=q.device)
    n_rounds = ROUNDS if rounds is None else rounds
    return train_loop(q.state, round_fn, batches(q.cfg), n_rounds=n_rounds, eval_every=5, device=q.device)


def prompts(cfg) -> np.ndarray:
    return np.stack([make_token_stream(16, cfg.vocab_size, seed=100 + i)[:8] for i in range(4)]).astype(np.int32)


def serve(q: SimpleNamespace, state: DFLState) -> dict:
    """Consensus and ensemble serving of the trained ensemble: the prompts,
    the consensus answers, each query's node and the nodes' answers."""
    p = torch.as_tensor(prompts(q.cfg), device=q.device)
    engine = ServeEngine(q.cfg, cache_len=128, device=q.device)
    out = engine.generate(consensus_params(state.tree), p, n_new=N_NEW)
    router = make_router(q.graph, "consensus")
    homes = np.arange(p.shape[0]) % N_NODES
    zeros = np.zeros(N_NODES, np.float32)  # after training every node is equally fresh
    assignments = np.array([router.route(int(h), zeros, zeros) for h in homes])
    out_nodes = engine.serve(state.tree, assignments, p, n_new=N_NEW)
    return {"prompts": p.cpu().numpy(), "consensus": out.cpu().numpy(), "assignments": assignments,
            "nodes": out_nodes.cpu().numpy()}


def run(device=None) -> dict:
    """Train, then serve both ways, printing as the JAX example does."""
    q = setup(device)
    print(f"arch={q.cfg.name} (reduced) graph={q.graph.name} gain={q.gain:.2f} device={q.device}")
    state, hist = train(q)
    for r, loss in zip(hist["round"], hist["train_loss"]):
        print(f"  round {r:3d}  train loss {loss:.4f}")
    got = serve(q, state)
    print("\n[1] consensus serving (DecAvg average of the node ensemble)...")
    for i, (pr, ans) in enumerate(zip(got["prompts"], got["consensus"])):
        print(f"  req{i}: prompt={pr.tolist()} -> {ans.tolist()}")
    print("\n[2] ensemble serving (router assigns each query a node)...")
    for i, (node, ans) in enumerate(zip(got["assignments"], got["nodes"])):
        agree = "==" if np.array_equal(ans, got["consensus"][i]) else "!="
        print(f"  req{i}: node {int(node)} {agree} consensus -> {ans.tolist()}")
    return dict(got, hist=hist, state=state)


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(device=p.parse_args(argv).device)


if __name__ == "__main__":
    main()
