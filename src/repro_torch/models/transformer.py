"""Decoder stack (counterpart of ``repro/models/transformer.py``): attention,
mamba and RWKV-6 blocks, dense and MoE FFNs, and the modality frontends'
projector.

The layer sequence is ``layer_kinds(cfg)`` (attn / swa / mamba / rwkv
cycled from ``cfg.block_pattern``); an attention or mamba block carries
the FFN ``ffn_kinds(cfg)`` names for its layer (dense, or the MoE FFN of
``models/moe.py``: jamba's layout), an RWKV block its own channel-mix.
The parameter tree has the JAX package's layout, leaf for leaf:

    stack:  one tree per position in the repeating unit, every leaf with a
            leading period axis (n_full periods),
    tail:   the n_layers % unit leftover layers, one tree each
            (gemma3's 34 = 5×6 + 4).

An attention block is ``norm1, attn, norm2, ffn``, a mamba block ``norm1,
mamba, norm2, ffn``; an RWKV block is ``norm1, rwkv {tmix, cmix}, norm2``
(no ``ffn``).  The JAX package scans over the periods; here a Python loop
walks them in the same order, reading each period's block as views.  A
config with a ``frontend`` (vision, audio) has ``frontend_proj``, a
(frontend_embed_dim, d_model) projection with a bias: ``forward`` and
``prefill_cache`` take ``frontend_embeds`` (..., F, frontend_embed_dim),
project them and put them before the text tokens, so positions run over
both and decoding resumes at ``pos = F + S``.  With an ``(n,)`` per-node
gain, ``init_params`` draws a node-stacked ensemble (every leaf with a
leading node axis); the forward functions take one parameter set (index an
ensemble's leaves at a node, or average it with
``repro_torch.fed.serve.consensus_params``).

Training: ``lm_loss`` is the JAX package's chunked softmax cross-entropy
(``node_loss`` runs it a node at a time for the DFL trainer: the
consensus example and the CLI's token models).  The kernels have no
backward: under autograd the attention layers run the plain masked
softmax (``models/attention.py``) and the RWKV time-mix its plain chunked
form (``models/rwkv.py``); the mamba scan is plain torch either way.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig, ffn_kinds, layer_kinds
from repro_torch.core.initialisation import InitConfig
from repro_torch.device import resolve_device
from repro_torch.dtensor import batch_layout, embed, gather_last, residual
from repro_torch.flat import tree_leaves, tree_map

from .attention import attention_decode, attention_forward, attention_prefill, init_attention, init_kv_cache
from .common import dense_init, node_lead, norm_apply, norm_init
from .mamba import init_mamba, init_mamba_cache, mamba_decode, mamba_forward, mamba_prefill
from .mlp import ffn_forward, init_ffn
from .moe import init_moe, moe_forward
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

_KINDS = ("attn", "swa", "mamba", "rwkv")


def _check_cfg(cfg: ArchConfig) -> None:
    for kind in layer_kinds(cfg):
        if kind not in _KINDS:
            raise ValueError(f"unknown block kind {kind}")


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
    """(period or None for the tail, position in unit or tail index, block
    kind, FFN kind) per layer, in order."""
    kinds, fkinds = layer_kinds(cfg), ffn_kinds(cfg)
    u, n_full, tail = _split_layers(cfg)
    for per in range(n_full):
        for j in range(u):
            yield per, j, kinds[j], fkinds[j]
    for j in range(tail):
        yield None, j, kinds[n_full * u + j], fkinds[n_full * u + j]


def _window(cfg: ArchConfig, kind: str) -> int:
    return cfg.sliding_window if kind == "swa" else 0


def _block_at(tree_stack: list, tree_tail: list, per, j):
    """Layer (per, j)'s block tree: views into period ``per`` of the stack, or tail layer j."""
    if per is None:
        return tree_tail[j]
    return tree_map(lambda t: t[per], tree_stack[j])


# ----------------------------------------------------------------- init
def _init_block(
    init_cfg: InitConfig, generator: torch.Generator, cfg: ArchConfig, kind: str, fk: str, lead: tuple[int, ...]
) -> Tree:
    dt, dev = cfg.param_dtype, generator.device
    if kind == "rwkv":
        return {
            "norm1": norm_init(cfg.d_model, cfg.norm, dt, lead, dev),
            "rwkv": init_rwkv(init_cfg, generator, cfg, lead),
            "norm2": norm_init(cfg.d_model, cfg.norm, dt, lead, dev),
        }
    block = {"norm1": norm_init(cfg.d_model, cfg.norm, dt, lead, dev)}
    if kind == "mamba":
        block["mamba"] = init_mamba(init_cfg, generator, cfg, lead)
    else:
        block["attn"] = init_attention(init_cfg, generator, cfg, lead)
    block["norm2"] = norm_init(cfg.d_model, cfg.norm, dt, lead, dev)
    block["ffn"] = (init_moe if fk == "moe" else init_ffn)(init_cfg, generator, cfg, lead)
    return block


def init_params(
    generator: torch.Generator | int, cfg: ArchConfig, init_cfg: InitConfig, *, device=None
) -> Tree:
    """The decoder's parameters on ``device`` (default ``cuda``), drawn from
    ``generator`` (a ``torch.Generator`` on that device, or an int seed).

    Weights are ``init_cfg``'s distribution with fans from the per-layer
    shape (the embedding's fan-in is the vocabulary, as ``dense_init`` on
    (V, d) gives in the JAX package); norm scales are ones, biases zeros;
    a mamba block's structured leaves follow ``models/mamba.py``.
    """
    _check_cfg(cfg)
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator lies on {generator.device}, parameters go to {dev}")
    nodes = node_lead(init_cfg)
    kinds, fkinds = layer_kinds(cfg), ffn_kinds(cfg)
    u, n_full, tail = _split_layers(cfg)
    dt = cfg.param_dtype
    params: Tree = {
        "stack": [_init_block(init_cfg, generator, cfg, kinds[j], fkinds[j], (*nodes, n_full)) for j in range(u)],
        "tail": [
            _init_block(init_cfg, generator, cfg, kinds[n_full * u + j], fkinds[n_full * u + j], nodes)
            for j in range(tail)
        ],
        "embed": {"tok": dense_init(init_cfg, generator, (cfg.vocab_size, cfg.d_model), dt, lead=nodes)},
        "final_norm": norm_init(cfg.d_model, cfg.norm, dt, nodes, generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(init_cfg, generator, (cfg.d_model, cfg.vocab_size), dt, lead=nodes)
    if cfg.frontend:
        params["frontend_proj"] = dense_init(
            init_cfg, generator, (cfg.frontend_embed_dim, cfg.d_model), dt, bias=True, lead=nodes
        )
    return params


# ----------------------------------------------------------------- forward
def _ffn_residual(p: Tree, cfg: ArchConfig, fk: str, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x + ffn(ln2(x)), and the MoE aux loss (None for a dense FFN)."""
    h = norm_apply(p["norm2"], x, cfg.norm)
    if fk == "moe":
        y, aux = moe_forward(p["ffn"], cfg, h)
        return residual(x, y), aux
    return residual(x, ffn_forward(p["ffn"], cfg, h)), None


def _rwkv_block(p: Tree, cfg: ArchConfig, x: torch.Tensor, cache: Tree | None = None) -> torch.Tensor:
    """x += tmix(ln1(x)); x += cmix(ln2(x)), from a zero shift and state.
    With ``cache`` (prefill), the final wkv state and the last-token shift
    inputs are written into it: exactly the decode cache."""
    h = norm_apply(p["norm1"], x, cfg.norm)
    prev0 = torch.zeros(*x.shape[:-2], 1, x.shape[-1], dtype=x.dtype, device=x.device)
    y_t, tshift, state = rwkv_time_mix(p["rwkv"]["tmix"], cfg, h, prev0)
    x = residual(x, y_t)
    h2 = norm_apply(p["norm2"], x, cfg.norm)
    y_c, cshift = rwkv_channel_mix(p["rwkv"]["cmix"], h2, prev0)
    if cache is not None:
        cache["tshift"].copy_(tshift)
        cache["cshift"].copy_(cshift)
        cache["state"].copy_(state)
    return residual(x, y_c)


def _rwkv_decode(p: Tree, cfg: ArchConfig, x: torch.Tensor, cache: Tree) -> torch.Tensor:
    """One token through an RWKV block; the cache's shifts and state are updated in place."""
    h = norm_apply(p["norm1"], x, cfg.norm)
    y_t, tshift, state = rwkv_time_mix_step(p["rwkv"]["tmix"], cfg, h, cache["tshift"], cache["state"])
    x = residual(x, y_t)
    h2 = norm_apply(p["norm2"], x, cfg.norm)
    y_c, cshift = rwkv_channel_mix(p["rwkv"]["cmix"], h2, cache["cshift"].to(h2.dtype))
    cache["tshift"].copy_(tshift)
    cache["cshift"].copy_(cshift)
    cache["state"].copy_(state)
    return residual(x, y_c)


def _embed(params: Tree, cfg: ArchConfig, tokens: torch.Tensor, frontend_embeds: torch.Tensor | None) -> torch.Tensor:
    """The token embeddings, after the projected frontend embeddings when
    the config has a frontend and the caller gives them: (..., F + S, D).
    The projection takes the promoted dtype of the embeddings and the
    weight (an fp32 input against bf16 weights is an fp32 product, as the
    JAX einsum's promotion gives) and is cast to the model's dtype."""
    x = embed(params["embed"]["tok"]["w"], tokens.long())
    if cfg.frontend and frontend_embeds is not None:
        w, b = params["frontend_proj"]["w"], params["frontend_proj"]["b"]
        dt = torch.promote_types(frontend_embeds.dtype, w.dtype)
        proj = torch.matmul(frontend_embeds.to(dt), w.to(dt)) + b.to(dt)
        x = torch.cat([proj.to(x.dtype), x], dim=-2)
    return x


def _block(
    p: Tree, cfg: ArchConfig, kind: str, fk: str, x: torch.Tensor, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One residual block (training / prefill, no cache) → (x, the MoE aux or None)."""
    if kind == "rwkv":
        return _rwkv_block(p, cfg, x), None
    h = norm_apply(p["norm1"], x, cfg.norm)
    if kind == "mamba":
        return _ffn_residual(p, cfg, fk, residual(x, mamba_forward(p["mamba"], cfg, h)))
    return _ffn_residual(p, cfg, fk, residual(x, attention_forward(p["attn"], cfg, h, positions, _window(cfg, kind))))


def forward(
    params: Tree,
    cfg: ArchConfig,
    tokens: torch.Tensor,
    frontend_embeds: torch.Tensor | None = None,
    remat: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass: tokens (..., S) → (final hidden states (..., S, D),
    the MoE aux loss summed over the layers, fp32; 0 without a MoE layer).

    The JAX package's keywords: ``frontend_embeds`` (..., F, E) is read only
    by a config with a modality frontend (then the hidden states are
    (..., F + S, D)), and ignored otherwise, as the JAX call does.  ``remat``
    recomputes each period's activations in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) when autograd records, as
    the JAX call wraps each period in ``jax.checkpoint``; the tail layers
    are not wrapped, and the values are the same either way."""
    _check_cfg(cfg)
    x = batch_layout(_embed(params, cfg, tokens, frontend_embeds), tokens)
    positions = torch.arange(x.shape[-2], device=x.device)
    kinds, fkinds = layer_kinds(cfg), ffn_kinds(cfg)
    u, n_full, tail = _split_layers(cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def period(x: torch.Tensor, per: int) -> tuple[torch.Tensor, torch.Tensor]:
        aux = zero
        for j in range(u):
            x, a = _block(_block_at(params["stack"], params["tail"], per, j), cfg, kinds[j], fkinds[j], x, positions)
            x = batch_layout(x, tokens)
            aux = aux if a is None else aux + a
        return x, aux

    aux = zero
    for per in range(n_full):
        if remat and torch.is_grad_enabled():
            x, a = torch.utils.checkpoint.checkpoint(period, x, per, use_reentrant=False)
        else:
            x, a = period(x, per)
        aux = aux + a
    for j in range(tail):
        layer = n_full * u + j
        x, a = _block(_block_at(params["stack"], params["tail"], None, j), cfg, kinds[layer], fkinds[layer], x,
                      positions)
        x = batch_layout(x, tokens)
        aux = aux if a is None else aux + a
    x = norm_apply(params["final_norm"], x, cfg.norm)
    return x, aux


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
        picked = gather_last(logits, t.long())
        return (torch.logsumexp(logits, dim=-1) - picked).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        total = total + ce(hidden[..., i * chunk : (i + 1) * chunk, :], targets[..., i * chunk : (i + 1) * chunk])
    if rem:
        total = total + ce(hidden[..., s - rem :, :], targets[..., s - rem :])
    return total / math.prod(targets.shape)


AUX_WEIGHT = 0.01  # the MoE load-balance term's weight, as the JAX callers


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
    (…, H, M, M), for mamba layers the conv tail (…, dc−1, d_inner) and the
    fp32 state (…, d_inner, N), whatever ``cache_len``."""
    _check_cfg(cfg)
    kinds = layer_kinds(cfg)
    u, n_full, tail = _split_layers(cfg)

    def one(kind, lead):
        if kind == "rwkv":
            return init_rwkv_cache(cfg, (*lead, *batch_shape), device=device)
        if kind == "mamba":
            return init_mamba_cache(cfg, (*lead, *batch_shape), device=device)
        t = min(cfg.sliding_window, cache_len) if kind == "swa" else cache_len
        return init_kv_cache(cfg, (*lead, *batch_shape), t, device=device)

    return {
        "stack": [one(kinds[j], (n_full,)) for j in range(u)],
        "tail": [one(kinds[n_full * u + j], ()) for j in range(tail)],
    }


@torch.no_grad()
def prefill_cache(
    params: Tree, cfg: ArchConfig, tokens: torch.Tensor, cache_len: int, frontend_embeds: torch.Tensor | None = None
) -> tuple[torch.Tensor, Tree]:
    """Batched prefill: one full-sequence pass that fills the decode cache.

    tokens (..., S); ``frontend_embeds`` (..., F, E) go before them for a
    config with a frontend (``forward``'s keyword).  Returns
    (last-position logits (..., V), the cache ready for ``decode_step`` at
    ``pos = F + S``), leaf for leaf the JAX package's.
    """
    cache = init_cache(cfg, tuple(tokens.shape[:-1]), cache_len, device=tokens.device)
    x = _embed(params, cfg, tokens, frontend_embeds)
    positions = torch.arange(x.shape[-2], device=x.device)
    for per, j, kind, fk in _layers(cfg):
        p = _block_at(params["stack"], params["tail"], per, j)
        c = _block_at(cache["stack"], cache["tail"], per, j)
        if kind == "rwkv":
            x = _rwkv_block(p, cfg, x, c)
            continue
        h = norm_apply(p["norm1"], x, cfg.norm)
        if kind == "mamba":
            y, filled = mamba_prefill(p["mamba"], cfg, h)
            for name, t in filled.items():
                c[name].copy_(t)
        else:
            y, _ = attention_prefill(p["attn"], cfg, h, positions, c, _window(cfg, kind))
        x, _ = _ffn_residual(p, cfg, fk, residual(x, y))
    x = norm_apply(params["final_norm"], x, cfg.norm)
    return hidden_to_logits(params, cfg, x[..., -1:, :])[..., 0, :], cache


@torch.no_grad()
def decode_step(
    params: Tree, cfg: ArchConfig, cache: Tree, tokens: torch.Tensor, pos: int
) -> tuple[torch.Tensor, Tree]:
    """One decode step: tokens (..., 1) at absolute position ``pos``.

    Returns (logits (..., 1, V), the cache, updated in place)."""
    x = batch_layout(_embed(params, cfg, tokens, None), tokens)
    for per, j, kind, fk in _layers(cfg):
        p = _block_at(params["stack"], params["tail"], per, j)
        c = _block_at(cache["stack"], cache["tail"], per, j)
        if kind == "rwkv":
            x = batch_layout(_rwkv_decode(p, cfg, x, c), tokens)
            continue
        h = norm_apply(p["norm1"], x, cfg.norm)
        if kind == "mamba":
            y, _ = mamba_decode(p["mamba"], cfg, h, c)
        else:
            y, _ = attention_decode(p["attn"], cfg, h, c, int(pos), _window(cfg, kind))
        x = batch_layout(_ffn_residual(p, cfg, fk, residual(x, y))[0], tokens)
    x = norm_apply(params["final_norm"], x, cfg.norm)
    return hidden_to_logits(params, cfg, x), cache
