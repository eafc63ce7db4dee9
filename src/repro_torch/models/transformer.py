"""Decoder stack (counterpart of ``repro/models/transformer.py``): attention
and RWKV-6 blocks.

The layer sequence is ``layer_kinds(cfg)`` (attn / swa / rwkv cycled from
``cfg.block_pattern``); an attention block carries a dense FFN, an RWKV
block its own channel-mix.  The parameter tree has the JAX package's
layout, leaf for leaf:

    stack:  one tree per position in the repeating unit, every leaf with a
            leading period axis (n_full periods),
    tail:   the n_layers % unit leftover layers, one tree each
            (gemma3's 34 = 5×6 + 4).

An attention block is ``norm1, attn, norm2, ffn``; an RWKV block is
``norm1, rwkv {tmix, cmix}, norm2`` (no ``ffn``).  The JAX package scans
over the periods; here a Python loop walks them in the same order, reading
each period's block as views.  Mamba blocks, MoE FFNs and modality
frontends are not ported yet and raise.  With an ``(n,)`` per-node gain,
``init_params`` draws a node-stacked ensemble (every leaf with a leading
node axis); the forward functions take one parameter set (index an
ensemble's leaves at a node, or average it with
``repro_torch.fed.serve.consensus_params``).

Training: ``lm_loss`` is the JAX package's chunked softmax cross-entropy
(``node_loss`` runs it a node at a time for the DFL trainer: the
consensus example and the CLI's token models).  Under autograd the attention
layers run the plain masked softmax (the kernels have no backward:
``models/attention.py``); RWKV training is not ported yet, and a recorded
RWKV forward on the card raises in the kernel's wrapper.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ffn_kinds, layer_kinds
from repro_torch.core.initialisation import InitConfig
from repro_torch.device import resolve_device
from repro_torch.flat import tree_leaves, tree_map

from .attention import attention_decode, attention_forward, attention_prefill, init_attention, init_kv_cache
from .common import dense_init, node_lead, norm_apply, norm_init
from .mlp import ffn_forward, init_ffn
from .rwkv import init_rwkv, init_rwkv_cache, rwkv_channel_mix, rwkv_time_mix, rwkv_time_mix_step

Tree = dict[str, Any]

__all__ = [
    "decode_step",
    "forward",
    "hidden_to_logits",
    "init_cache",
    "init_params",
    "lm_loss",
    "node_loss",
    "prefill_cache",
    "unit_size",
]

_NOT_PORTED = {
    "mamba": "mamba blocks are not yet ported (ROADMAP Queue 1 item 15: models/mamba.py)",
    "moe": "MoE FFNs are not yet ported (ROADMAP Queue 1 item 15: models/moe.py)",
}


def _check_cfg(cfg: ArchConfig) -> None:
    for kind, fk in zip(layer_kinds(cfg), ffn_kinds(cfg)):
        if kind in _NOT_PORTED:
            raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED[kind]}")
        if kind not in ("attn", "swa", "rwkv"):
            raise ValueError(f"unknown block kind {kind}")
        if fk == "moe":
            raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED['moe']}")
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: modality frontends are not yet ported (ROADMAP Queue 1 item 15: the other configs)"
        )


# ----------------------------------------------------------------- structure
def unit_size(cfg: ArchConfig) -> int:
    """Length of the repeating layer unit (pattern period ∨ MoE period)."""
    u = len(cfg.block_pattern)
    if cfg.is_moe:
        u = math.lcm(u, cfg.moe_period)
    return min(u, cfg.n_layers)


def _split_layers(cfg: ArchConfig) -> tuple[int, int, int]:
    """(unit, n_full_periods, n_tail_layers)."""
    u = unit_size(cfg)
    n_full = cfg.n_layers // u
    return u, n_full, cfg.n_layers - n_full * u


def _layers(cfg: ArchConfig):
    """(period or None for the tail, position in unit or tail index, block kind) per layer, in order."""
    kinds = layer_kinds(cfg)
    u, n_full, tail = _split_layers(cfg)
    for per in range(n_full):
        for j in range(u):
            yield per, j, kinds[j]
    for j in range(tail):
        yield None, j, kinds[n_full * u + j]


def _window(cfg: ArchConfig, kind: str) -> int:
    return cfg.sliding_window if kind == "swa" else 0


def _block_at(tree_stack: list, tree_tail: list, per, j):
    """Layer (per, j)'s block tree: views into period ``per`` of the stack, or tail layer j."""
    if per is None:
        return tree_tail[j]
    return tree_map(lambda t: t[per], tree_stack[j])


# ----------------------------------------------------------------- init
def _init_block(
    init_cfg: InitConfig, generator: torch.Generator, cfg: ArchConfig, kind: str, lead: tuple[int, ...]
) -> Tree:
    dt, dev = cfg.param_dtype, generator.device
    if kind == "rwkv":
        return {
            "norm1": norm_init(cfg.d_model, cfg.norm, dt, lead, dev),
            "rwkv": init_rwkv(init_cfg, generator, cfg, lead),
            "norm2": norm_init(cfg.d_model, cfg.norm, dt, lead, dev),
        }
    return {
        "norm1": norm_init(cfg.d_model, cfg.norm, dt, lead, dev),
        "attn": init_attention(init_cfg, generator, cfg, lead),
        "norm2": norm_init(cfg.d_model, cfg.norm, dt, lead, dev),
        "ffn": init_ffn(init_cfg, generator, cfg, lead),
    }


def init_params(
    generator: torch.Generator | int, cfg: ArchConfig, init_cfg: InitConfig, *, device=None
) -> Tree:
    """The decoder's parameters on ``device`` (default ``cuda``), drawn from
    ``generator`` (a ``torch.Generator`` on that device, or an int seed).

    Weights are ``init_cfg``'s distribution with fans from the per-layer
    shape (the embedding's fan-in is the vocabulary, as ``dense_init`` on
    (V, d) gives in the JAX package); norm scales are ones, biases zeros.
    """
    _check_cfg(cfg)
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator lies on {generator.device}, parameters go to {dev}")
    nodes = node_lead(init_cfg)
    kinds = layer_kinds(cfg)
    u, n_full, tail = _split_layers(cfg)
    dt = cfg.param_dtype
    params: Tree = {
        "stack": [_init_block(init_cfg, generator, cfg, kinds[j], (*nodes, n_full)) for j in range(u)],
        "tail": [_init_block(init_cfg, generator, cfg, kinds[n_full * u + j], nodes) for j in range(tail)],
        "embed": {"tok": dense_init(init_cfg, generator, (cfg.vocab_size, cfg.d_model), dt, lead=nodes)},
        "final_norm": norm_init(cfg.d_model, cfg.norm, dt, nodes, generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(init_cfg, generator, (cfg.d_model, cfg.vocab_size), dt, lead=nodes)
    return params


# ----------------------------------------------------------------- forward
def _ffn_residual(p: Tree, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return x + ffn_forward(p["ffn"], cfg, norm_apply(p["norm2"], x, cfg.norm))


def _rwkv_block(p: Tree, cfg: ArchConfig, x: torch.Tensor, cache: Tree | None = None) -> torch.Tensor:
    """x += tmix(ln1(x)); x += cmix(ln2(x)), from a zero shift and state.
    With ``cache`` (prefill), the final wkv state and the last-token shift
    inputs are written into it: exactly the decode cache."""
    h = norm_apply(p["norm1"], x, cfg.norm)
    prev0 = torch.zeros(*x.shape[:-2], 1, x.shape[-1], dtype=x.dtype, device=x.device)
    y_t, tshift, state = rwkv_time_mix(p["rwkv"]["tmix"], cfg, h, prev0)
    x = x + y_t
    h2 = norm_apply(p["norm2"], x, cfg.norm)
    y_c, cshift = rwkv_channel_mix(p["rwkv"]["cmix"], h2, prev0)
    if cache is not None:
        cache["tshift"].copy_(tshift)
        cache["cshift"].copy_(cshift)
        cache["state"].copy_(state)
    return x + y_c


def _rwkv_decode(p: Tree, cfg: ArchConfig, x: torch.Tensor, cache: Tree) -> torch.Tensor:
    """One token through an RWKV block; the cache's shifts and state are updated in place."""
    h = norm_apply(p["norm1"], x, cfg.norm)
    y_t, tshift, state = rwkv_time_mix_step(p["rwkv"]["tmix"], cfg, h, cache["tshift"], cache["state"])
    x = x + y_t
    h2 = norm_apply(p["norm2"], x, cfg.norm)
    y_c, cshift = rwkv_channel_mix(p["rwkv"]["cmix"], h2, cache["cshift"].to(h2.dtype))
    cache["tshift"].copy_(tshift)
    cache["cshift"].copy_(cshift)
    cache["state"].copy_(state)
    return x + y_c


def _embed(params: Tree, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["tok"]["w"][tokens.long()]


def forward(params: Tree, cfg: ArchConfig, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass: tokens (..., S) → (final hidden states (..., S, D),
    aux loss 0 — no MoE layer is ported)."""
    _check_cfg(cfg)
    x = _embed(params, tokens)
    positions = torch.arange(x.shape[-2], device=x.device)
    for per, j, kind in _layers(cfg):
        p = _block_at(params["stack"], params["tail"], per, j)
        if kind == "rwkv":
            x = _rwkv_block(p, cfg, x)
            continue
        h = norm_apply(p["norm1"], x, cfg.norm)
        x = _ffn_residual(p, cfg, x + attention_forward(p["attn"], cfg, h, positions, _window(cfg, kind)))
    x = norm_apply(params["final_norm"], x, cfg.norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def hidden_to_logits(params: Tree, cfg: ArchConfig, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(hidden, params["embed"]["tok"]["w"].transpose(-1, -2))
    return torch.matmul(hidden, params["lm_head"]["w"])


def lm_loss(params: Tree, cfg: ArchConfig, hidden: torch.Tensor, targets: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Chunked softmax cross-entropy: the logits materialise one sequence
    chunk at a time ((..., chunk, V), never (..., S, V)), each chunk's summed
    fp32 CE added in the JAX package's order (the whole chunks, then the
    remainder), the total divided by the token count."""
    s = hidden.shape[-2]
    chunk = min(chunk, s)
    n_chunks = s // chunk
    rem = s - n_chunks * chunk

    def ce(h, t):
        logits = hidden_to_logits(params, cfg, h).to(torch.float32)
        picked = torch.gather(logits, -1, t.long()[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - picked).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        total = total + ce(hidden[..., i * chunk : (i + 1) * chunk, :], targets[..., i * chunk : (i + 1) * chunk])
    if rem:
        total = total + ce(hidden[..., s - rem :, :], targets[..., s - rem :])
    return total / math.prod(targets.shape)


AUX_WEIGHT = 0.01  # the MoE load-balance term's weight, as the JAX callers (0 aux here: no MoE layer)


def node_loss(cfg: ArchConfig):
    """The DFL trainer's loss for the decoder: ``loss_fn(node_params, (x,
    y))`` with node-stacked views (every leaf ``(n, ...)``) → the ``(n,)``
    per-node ``lm_loss + 0.01 · aux``, one forward a node on its own
    parameters (the JAX callers vmap the same function over the nodes).
    Tokens x and targets y are ``(n, B, S)``, each node its own, or ``(B,
    S)``, shared by every node (an eval batch)."""

    def loss_fn(node_params: Tree, batch) -> torch.Tensor:
        x, y = batch
        out = []
        for i in range(tree_leaves(node_params)[0][1].shape[0]):
            p = tree_map(lambda t: t[i], node_params)
            xi, yi = (x[i], y[i]) if x.ndim == 3 else (x, y)
            hidden, aux = forward(p, cfg, xi)
            out.append(lm_loss(p, cfg, hidden, yi) + AUX_WEIGHT * aux)
        return torch.stack(out)

    return loss_fn


# ----------------------------------------------------------------- decode
def init_cache(cfg: ArchConfig, batch_shape: tuple[int, ...], cache_len: int, *, device=None) -> Tree:
    """Zeroed caches: KV caches (n_full, *batch, T, KVH, hd) per unit
    position and (*batch, T, KVH, hd) per tail layer, T = cache_len for attn
    layers and min(window, cache_len) for swa layers (a ring buffer); for
    rwkv layers the token shifts (…, 1, D) and the fp32 wkv state
    (…, H, M, M), whatever ``cache_len``."""
    _check_cfg(cfg)
    kinds = layer_kinds(cfg)
    u, n_full, tail = _split_layers(cfg)

    def one(kind, lead):
        if kind == "rwkv":
            return init_rwkv_cache(cfg, (*lead, *batch_shape), device=device)
        t = min(cfg.sliding_window, cache_len) if kind == "swa" else cache_len
        return init_kv_cache(cfg, (*lead, *batch_shape), t, device=device)

    return {
        "stack": [one(kinds[j], (n_full,)) for j in range(u)],
        "tail": [one(kinds[n_full * u + j], ()) for j in range(tail)],
    }


@torch.no_grad()
def prefill_cache(params: Tree, cfg: ArchConfig, tokens: torch.Tensor, cache_len: int) -> tuple[torch.Tensor, Tree]:
    """Batched prefill: one full-sequence pass that fills the decode cache.

    tokens (..., S).  Returns (last-position logits (..., V), the cache ready
    for ``decode_step`` at ``pos = S``), leaf for leaf the JAX package's.
    """
    cache = init_cache(cfg, tuple(tokens.shape[:-1]), cache_len, device=tokens.device)
    x = _embed(params, tokens)
    positions = torch.arange(x.shape[-2], device=x.device)
    for per, j, kind in _layers(cfg):
        p = _block_at(params["stack"], params["tail"], per, j)
        c = _block_at(cache["stack"], cache["tail"], per, j)
        if kind == "rwkv":
            x = _rwkv_block(p, cfg, x, c)
            continue
        y, _ = attention_prefill(
            p["attn"], cfg, norm_apply(p["norm1"], x, cfg.norm), positions, c, _window(cfg, kind)
        )
        x = _ffn_residual(p, cfg, x + y)
    x = norm_apply(params["final_norm"], x, cfg.norm)
    return hidden_to_logits(params, cfg, x[..., -1:, :])[..., 0, :], cache


@torch.no_grad()
def decode_step(
    params: Tree, cfg: ArchConfig, cache: Tree, tokens: torch.Tensor, pos: int
) -> tuple[torch.Tensor, Tree]:
    """One decode step: tokens (..., 1) at absolute position ``pos``.

    Returns (logits (..., 1, V), the cache, updated in place)."""
    x = _embed(params, tokens)
    for per, j, kind in _layers(cfg):
        p = _block_at(params["stack"], params["tail"], per, j)
        c = _block_at(cache["stack"], cache["tail"], per, j)
        if kind == "rwkv":
            x = _rwkv_decode(p, cfg, x, c)
            continue
        y, _ = attention_decode(
            p["attn"], cfg, norm_apply(p["norm1"], x, cfg.norm), c, int(pos), _window(cfg, kind)
        )
        x = _ffn_residual(p, cfg, x + y)
    x = norm_apply(params["final_norm"], x, cfg.norm)
    return hidden_to_logits(params, cfg, x), cache
