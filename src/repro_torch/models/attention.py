"""Grouped-query attention with RoPE, sliding-window option and KV cache
(counterpart of ``repro/models/attention.py``).

Every full-sequence attention that autograd does not record
(``attention_prefill``, ``attention_forward`` under ``torch.no_grad()``)
goes through ``repro_torch.kernels.flash.flash_attention``: the hand-written
CUDA kernel on the card, its plain version on the CPU.  The kernel has no
backward, so when autograd records (grad mode on and q, k or v requiring
grad: a training step) ``attention_forward`` computes the JAX package's
training function instead, the plain masked softmax ``_sdpa`` over the
causal / window mask of the JAX ``_causal_mask``, on every device.  The
choice depends on nothing else.  One-token decode against the cache is
``_sdpa`` too (fp32 scores and softmax, probabilities cast to v's dtype
before PV, as the JAX ``_sdpa``).  The kernel keeps the probabilities in
fp32: at fp32 the two agree to summation order, at bf16 they differ by one
rounding of p.

Shapes (node / batch axes lead and broadcast):
    x          (..., S, D)
    wq         (D, H·hd)        wk/wv (D, KVH·hd)       wo (H·hd, D)
    cache k/v  (..., S_cache, KVH, hd)

The caches are written in place: ``attention_prefill`` and
``attention_decode`` return the cache dict they were given, updated.

On DTensors (the launch layer's step functions) the head split and the
attention core go through ``repro_torch.dtensor``: ``split_heads``
gathers a projection whose heads cannot be split over the mesh, and
``on_local_heads`` runs the kernel (or ``_sdpa``) on each rank's own
heads (``_attend``, which flattens the heads there).  Plain tensors pass through both untouched.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.initialisation import InitConfig
from repro_torch.dtensor import on_local_heads, split_heads
from repro_torch.kernels.flash import flash_attention

from .common import apply_rope, dense_init

Tree = dict[str, Any]

__all__ = [
    "attention_decode",
    "attention_forward",
    "attention_prefill",
    "init_attention",
    "init_kv_cache",
]


def init_attention(init_cfg: InitConfig, generator: torch.Generator, cfg: ArchConfig, lead: tuple[int, ...] = ()) -> Tree:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.param_dtype
    return {
        "wq": dense_init(init_cfg, generator, (d, h * hd), dt, bias=cfg.qkv_bias, lead=lead),
        "wk": dense_init(init_cfg, generator, (d, kvh * hd), dt, bias=cfg.qkv_bias, lead=lead),
        "wv": dense_init(init_cfg, generator, (d, kvh * hd), dt, bias=cfg.qkv_bias, lead=lead),
        "wo": dense_init(init_cfg, generator, (h * hd, d), dt, bias=False, lead=lead),
    }


def _project(p: Tree, x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return split_heads(y, n_heads, hd)


def _qkv(p: Tree, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = apply_rope(_project(p["wq"], x, h, hd), positions, cfg.rope_theta)
    k = apply_rope(_project(p["wk"], x, kvh, hd), positions, cfg.rope_theta)
    v = _project(p["wv"], x, kvh, hd)
    return q, k, v


def _out(p: Tree, attn: torch.Tensor) -> torch.Tensor:
    """attn (..., S, H·hd), the heads already flattened → (..., S, D)."""
    return torch.matmul(attn, p["wo"]["w"])


def _attend(core, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *args, **kw) -> torch.Tensor:
    """``core(q, k, v, ...)`` on each rank's own heads, its (..., S, H, hd)
    output flattened to (..., S, H·hd) there (on a DTensor's local shard,
    so no gradient is ever unflattened across a mesh split)."""

    def flat(*a, **k_):
        out = core(*a, **k_)
        return out.reshape(*out.shape[:-2], -1)

    return on_local_heads(flat, q, k, v, *args, **kw)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q (..., S, H, hd), k/v (..., T, KVH, hd) → (..., S, H, hd); GQA via head groups.

    fp32 scores and softmax; mask is boolean (True = attend), broadcast to (S, T).
    """
    h, kvh, hd = q.shape[-2], k.shape[-2], q.shape[-1]
    qg = q.reshape(*q.shape[:-2], kvh, h // kvh, hd)
    scores = torch.einsum("...sngd,...tnd->...ngst", qg.float(), k.float()) * scale
    scores = scores.masked_fill(~mask[..., None, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("...ngst,...tnd->...sngd", probs.to(v.dtype).float(), v.float())
    return out.reshape(*out.shape[:-3], h, hd).to(q.dtype)


def _causal_mask(s: int, window: int, device) -> torch.Tensor:
    """(S, S) boolean, True = attend: key j ≤ query i, and j > i − window
    when ``window`` > 0 (the JAX ``_causal_mask``)."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & (j > i - window)
    return m


def attention_forward(
    p: Tree, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, window: int = 0
) -> torch.Tensor:
    """Full-sequence attention: causal, optionally sliding-window.  Through
    the flash kernel unless autograd records the call; then through the
    plain ``_sdpa`` (the JAX package's training function)."""
    q, k, v = _qkv(p, cfg, x, positions)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        mask = _causal_mask(q.shape[-3], window, q.device)
        return _out(p, _attend(_sdpa, q, k, v, mask, 1.0 / (cfg.resolved_head_dim**0.5)))
    return _out(p, _attend(flash_attention, q, k, v, causal=True, window=window))


def init_kv_cache(cfg: ArchConfig, batch_shape: tuple[int, ...], cache_len: int, dtype=None, device=None) -> Tree:
    """Zeroed k / v caches (*batch_shape, cache_len, KVH, hd) in ``dtype``
    (a torch dtype or its name, as ``"bfloat16"``; default the config's)."""
    shape = (*batch_shape, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = cfg.param_dtype if dtype is None else (getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device), "v": torch.zeros(shape, dtype=dt, device=device)}


def attention_prefill(
    p: Tree, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, cache: Tree, window: int = 0
) -> tuple[torch.Tensor, Tree]:
    """Full-prompt prefill with one batched KV-cache insert.

    x (..., S, D); positions (S,) absolute; cache k/v (..., T, KVH, hd).
    The last ``min(S, T)`` keys/values are written at ``positions % T`` —
    the slots token-by-token decode would have left, so a decode resuming
    at ``pos = S`` sees the same ring buffer.
    """
    s = x.shape[-2]
    t = cache["k"].shape[-3]
    q, k, v = _qkv(p, cfg, x, positions)
    out = _attend(flash_attention, q, k, v, causal=True, window=window)
    w = min(s, t)
    slots = positions[s - w :] % t
    cache["k"][..., slots, :, :] = k[..., s - w :, :, :].to(cache["k"].dtype)
    cache["v"][..., slots, :, :] = v[..., s - w :, :, :].to(cache["v"].dtype)
    return _out(p, out), cache


def attention_decode(
    p: Tree, cfg: ArchConfig, x: torch.Tensor, cache: Tree, pos: int, window: int = 0
) -> tuple[torch.Tensor, Tree]:
    """One-token decode: x (..., 1, D); cache k/v (..., T, KVH, hd); pos the
    absolute position.  The new K/V goes to slot ``pos % T``: a plain slot
    for full caches and a ring buffer for sliding-window layers (T = window)."""
    hd = cfg.resolved_head_dim
    t = cache["k"].shape[-3]
    q, k_new, v_new = _qkv(p, cfg, x, torch.full((1,), pos, device=x.device))
    slot = pos % t
    cache["k"][..., slot : slot + 1, :, :] = k_new.to(cache["k"].dtype)
    cache["v"][..., slot : slot + 1, :, :] = v_new.to(cache["v"].dtype)
    # valid slots: the absolute index of slot j is pos - ((slot - j) mod T)
    j = torch.arange(t, device=x.device)
    abs_idx = pos - torch.remainder(slot - j, t)
    valid = abs_idx >= 0
    if window > 0:
        valid = valid & (abs_idx > pos - window)
    out = _attend(_sdpa, q, cache["k"], cache["v"], valid[None, :], 1.0 / (hd**0.5))
    return _out(p, out), cache
