"""Mixture-of-Experts FFN with sort-based, capacity-bounded dispatch
(counterpart of ``repro/models/moe.py``).

The JAX package's routing, step for step:

    1. router top-k over E experts (fp32 softmax), the k gates renormalised,
    2. the (token, slot) pairs sorted by expert id (stable),
    3. each pair's position inside its expert from ``searchsorted``; a pair
       past the capacity C is dropped,
    4. the batched expert FFN over the (E, C, D) buffer and (E, D, F)
       weights (``torch.matmul``, as the JAX package leaves its einsums to
       XLA),
    5. each token's kept outputs scaled by their gates and summed.

Leading axes fold into the T tokens of one call, so C is per call: a
serving batch folds (B, S) into T, and the DFL trainer's ``node_loss``
runs one call a node, as the JAX trainer's ``vmap`` does.

Determinism.  The JAX buffer is a scatter (``.at[dest].set``) and the
combine a scatter-add (``.at[tok].add``).  Here the buffer is a gather
(slot c of expert e holds the pair at sorted position first[e] + c), and
the combine adds each token's k contributions one at a time in ascending
expert id, from zeros of y's dtype: the order in which the JAX scatter
lists its updates, rounded after each add.  No atomic add, no
data-dependent shape and no host read: C is a Python int from the shapes,
the per-expert counts come from ``searchsorted`` (``torch.bincount`` reads
its maximum back to the host), so one decode step can be captured as a
CUDA graph.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.initialisation import InitConfig
from repro_torch.dtensor import replicate, replicated

from .common import dense_init

Tree = dict[str, Any]

__all__ = ["Routing", "combine", "dispatch", "init_moe", "moe_forward", "route"]


def init_moe(init_cfg: InitConfig, generator: torch.Generator, cfg: ArchConfig, lead: tuple[int, ...] = ()) -> Tree:
    """The router (D, E) and the expert stacks (E, D, F) / (E, F, D); each
    expert's fans from its own (D, F) shape, as the JAX package's vmapped
    draw sees them."""
    d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.param_dtype
    stack = (*lead, e)
    p: Tree = {"router": dense_init(init_cfg, generator, (d, e), dt, lead=lead)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(init_cfg, generator, (d, f), dt, lead=stack)
    p["w_in"] = dense_init(init_cfg, generator, (d, f), dt, lead=stack)
    p["w_out"] = dense_init(init_cfg, generator, (f, d), dt, lead=stack)
    return p


def _capacity(cfg: ArchConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # rounded up to 8, as the JAX package


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _experts(p: Tree, cfg: ArchConfig, buf: torch.Tensor) -> torch.Tensor:
    """buf (E, C, D) → (E, C, D): each expert's FFN on its C slots."""
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_type == "swiglu" else _gelu
        g = torch.matmul(buf, p["w_gate"]["w"])
        h = torch.matmul(buf, p["w_in"]["w"])
        return torch.matmul(act(g) * h, p["w_out"]["w"])
    return torch.matmul(_gelu(torch.matmul(buf, p["w_in"]["w"])), p["w_out"]["w"])


class Routing(NamedTuple):
    """The sort-based dispatch of one call's T·k (token, slot) pairs."""

    gate: torch.Tensor  # (T, k) renormalised top-k gates, fp32
    idx: torch.Tensor  # (T, k) their experts, descending probability
    order: torch.Tensor  # (T·k,) the pairs sorted by expert (stable)
    st: torch.Tensor  # (T·k,) token of each sorted pair
    first: torch.Tensor  # (E,) sorted position of each expert's first pair
    counts: torch.Tensor  # (E,) pairs routed to each expert
    keep: torch.Tensor  # (T·k,) sorted pair within its expert's capacity
    dest: torch.Tensor  # (T·k,) its slot in the (E·C) buffer; E·C (scratch) when dropped


def route(probs: torch.Tensor, k: int, cap: int) -> Routing:
    """probs (T, E) fp32 → the top-k routing and its capacity-C dispatch."""
    t, e = probs.shape
    dev = probs.device
    # top-k with ties toward the lower expert id, as jax.lax.top_k (a token
    # whose normed state is zero has all logits equal; torch.topk promises
    # no order among equals)
    sorted_p, sorted_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = sorted_p[:, :k], sorted_e[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.searchsorted(se, torch.arange(e, device=dev), side="left")
    counts = torch.diff(first, append=first.new_full((1,), t * k))
    pos = torch.arange(t * k, device=dev) - first[se]
    keep = pos < cap
    dest = torch.where(keep, se * cap + pos, e * cap)
    return Routing(gate, idx, order, torch.div(order, k, rounding_mode="floor"), first, counts, keep, dest)


def dispatch(xt: torch.Tensor, r: Routing, cap: int) -> torch.Tensor:
    """The (E, C, D) buffer as a gather: slot c of expert e holds the
    sorted pair first[e] + c when e has more than c pairs, else zeros."""
    slot = torch.arange(cap, device=xt.device)
    filled = slot[None, :] < r.counts[:, None]
    src = (r.first[:, None] + slot[None, :]).clamp(max=r.order.numel() - 1)
    return torch.where(filled[..., None], xt[r.st[src]], torch.zeros((), dtype=xt.dtype, device=xt.device))


def combine(y: torch.Tensor, r: Routing) -> torch.Tensor:
    """y (E·C, D) → (T, D): each token's kept outputs × their gates, added
    in ascending expert id (the order the JAX scatter lists its updates),
    from zeros of y's dtype and rounded after each add; a dropped pair adds
    y[E·C − 1] × 0, as in the JAX package."""
    t, k = r.idx.shape
    inv = torch.empty_like(r.order)
    inv[r.order] = torch.arange(t * k, device=y.device)
    by_expert = torch.argsort(r.idx, dim=-1)  # the token's k slots in ascending expert id
    sorted_pos = inv.view(t, k).gather(1, by_expert)  # their positions among the sorted pairs
    pair_gate = torch.where(r.keep[sorted_pos], r.gate.gather(1, by_expert), 0.0).to(y.dtype)
    rows = r.dest[sorted_pos].clamp(max=y.shape[0] - 1)
    out = y.new_zeros((t, y.shape[1]))
    for j in range(k):
        out = out + y[rows[:, j]] * pair_gate[:, j, None]
    return out


def moe_forward(p: Tree, cfg: ArchConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., S, D) → (y in x's shape and dtype, the fp32 Switch load-balance aux loss)."""
    lead, d = x.shape[:-1], x.shape[-1]
    e, k = cfg.n_experts, cfg.experts_per_token
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    cap = _capacity(cfg, t)
    probs = torch.softmax(torch.matmul(xt, p["router"]["w"]).float(), dim=-1)  # (T, E)
    # on DTensors (the launch layer) the routing is global: computed on the
    # gathered probabilities, tokens and slots indexed on gathered tensors
    r = replicated(route, probs, k, cap)
    y = _experts(p, cfg, dispatch(replicate(xt), r, cap)).reshape(e * cap, d)
    out = combine(replicate(y), r)
    # Switch aux load-balance loss: E · Σ_e mean router probability × fraction of pairs routed
    aux = e * torch.sum(probs.mean(dim=0) * (r.counts.to(torch.float32) / (t * k)))
    return out.reshape(*lead, d), aux
