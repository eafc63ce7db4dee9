"""Payload compression for DecAvg gossip (counterpart of ``repro/core/compress.py``).

Each node transmits its row compressed per *chunk* of ``chunk`` elements,
every leaf of the parameter tree cut on its own (chunk ``min(chunk, leaf
size)``, the last one short).  Codecs: ``int8`` and ``fp8`` (one fp32
absmax scale per chunk), ``topk`` (the ``ceil(topk_frac · c)`` largest
|·| per chunk, sent verbatim) and ``qtopk`` (those, int8-quantised against
the chunk absmax).  With error feedback (the default) each node carries a
mirror h, the copy of itself its peers hold, and one compressed round is

    q = C(x − h);   h' = h + q;   x' = x + γ (M h' − h')

— ``error_feedback=False`` is the memory-less ablation h' = C(x).  Codec
``"none"`` is the raw operator, bit for bit.

The port keeps an ensemble in one flat ``(n, d)`` buffer (``repro_torch.flat``):
its ``FlatLayout`` says where each leaf sits, so the per-leaf chunks become
one chunk table over the row.  On the card every int8 / fp8 round runs the
hand-written quantised-mix kernels (``kernels/mix/quant.py``): with M dense
one launch that reduces the scales, decodes and mixes in one pass over X
and H; with M block-sparse the scales pass, then the walk.  topk and qtopk
quantise in plain torch and mix h' through the DecAvg kernels.  The
arithmetic is the JAX package's as its executors run it, jitted: see
``kernels/mix/ref.py``.

==========  ===============================================================
codec       wire bytes per row of a d-element leaf (C = ceil(d / chunk))
==========  ===============================================================
none        d · itemsize
int8, fp8   d · 1 + C · 4                  (fp32 scale per chunk)
topk        Σ_chunks k_c · (4 + 2)         (fp32 value + uint16 index)
qtopk       Σ_chunks k_c · (1 + 2) + C · 4 (int8 value + uint16 index)
==========  ===============================================================

``compressed_spread`` is the send form, ``CommPlan.spread(compression=)``:
the same round over Mᵀ, which conserves the payload's total mass exactly
for any codec (the invariant push-sum estimation needs).

A ``ppermute`` (edge-coloured) plan holds no operator matrix: its rounds
take the plain codec for h' and then the colour mix of h', as the JAX
package's do.  Over a ``PlanSchedule`` (``round_index=``) a round is the
active plan's, through the same kernels as a static plan's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.flat import FlatLayout, tree_leaves, tree_map
from repro_torch.kernels.mix import mix_flat, quant_mix_flat
from repro_torch.kernels.mix.quant import table_bounds
from repro_torch.kernels.mix.ref import chunk_bounds, dequantise_ref, quant_scales_ref

__all__ = [
    "CODECS",
    "Compression",
    "compressed_mix",
    "compressed_mix_with",
    "compressed_spread",
    "encode_decode",
    "init_residuals",
    "seed_residual",
]

Tree = dict[str, Any]
CODECS = ("none", "int8", "fp8", "topk", "qtopk")
_SCALE_BYTES = 4  # fp32 scale per chunk on the wire
_TOPK_IDX_BYTES = 2  # uint16 in-chunk index (chunk <= 65536)


@dataclasses.dataclass(frozen=True)
class Compression:
    """Codec configuration of a compressed round.

    ``chunk`` is the per-leaf chunk in elements (the scale granularity),
    ``topk_frac`` the kept fraction per chunk (topk, qtopk), ``gamma`` the
    consensus step of the delta form.  ``error_feedback=False`` drops the
    mirror (ablation only).  ``stream`` is accepted for the JAX package's
    signature and changes nothing here: the port's round builds no
    ``(n, d)`` temporary beyond its outputs.
    """

    codec: str = "none"
    chunk: int = 2048
    topk_frac: float = 0.1
    gamma: float = 1.0
    error_feedback: bool = True
    stream: bool = False

    def __post_init__(self):
        if self.codec not in CODECS:
            raise ValueError(f"unknown codec {self.codec!r}, want one of {CODECS}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.chunk > 65536:
            raise ValueError(f"chunk must be <= 65536, got {self.chunk}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], got {self.topk_frac}")
        if not 0.0 < self.gamma <= 1.0:
            raise ValueError(f"gamma must be in (0, 1], got {self.gamma}")

    @property
    def active(self) -> bool:
        return self.codec != "none"

    def topk_count(self, chunk_elems: int) -> int:
        """Entries kept in one chunk of ``chunk_elems`` elements."""
        return max(1, min(chunk_elems, math.ceil(self.topk_frac * chunk_elems)))

    def leaf_row_bytes(self, n_elems: int, dtype) -> float:
        """Wire bytes for ONE node's row of one leaf (the module table);
        ``dtype`` is a numpy or torch dtype."""
        if n_elems == 0:
            return 0.0
        if not self.active:
            size = dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize
            return float(n_elems * size)
        full, rem = divmod(n_elems, self.chunk)
        n_chunks = full + (1 if rem else 0)
        if self.codec in ("int8", "fp8"):
            return float(n_elems + n_chunks * _SCALE_BYTES)
        entries = full * self.topk_count(self.chunk)
        if rem:
            entries += self.topk_count(rem)
        if self.codec == "qtopk":
            return float(entries * (1 + _TOPK_IDX_BYTES) + n_chunks * _SCALE_BYTES)
        return float(entries * (4 + _TOPK_IDX_BYTES))


# ------------------------------------------------------------ flat rows
@functools.lru_cache(maxsize=64)
def _edges(sizes: tuple[int, ...], chunk: int) -> tuple[int, ...]:
    """The chunk table of a row of leaves as host ints, built once per
    (layout, chunk): what the quantised round takes."""
    return tuple(chunk_bounds(sizes, chunk).tolist())


def _bounds(sizes: tuple[int, ...], chunk: int, device: torch.device) -> torch.Tensor:
    """The same table on ``device``: the copy the quantised round makes of
    ``_edges`` (``kernels/mix/quant.py::table_bounds``), made once."""
    return table_bounds(_edges(sizes, chunk), device)


def _sizes(x: torch.Tensor, layout: FlatLayout | None) -> tuple[int, ...]:
    if layout is None:
        return (x.shape[1],)
    if layout.size != x.shape[1]:
        raise ValueError(f"flat buffer has {x.shape[1]} columns, layout wants {layout.size}")
    return layout.sizes


def _flat32(tree: Tree, layout: FlatLayout) -> torch.Tensor:
    """A node-stacked tree as one fp32 (n, d) buffer (bf16 leaves widen exactly)."""
    return layout.flatten(tree).to(torch.float32)


def _unflat(flat: torch.Tensor, layout: FlatLayout, like: Tree | None = None) -> Tree:
    """The tree of ``flat``'s columns, each leaf cast to ``like``'s dtype (fp32 without one)."""
    views = layout.views(flat)
    if like is None:
        return views
    dtypes = [v.dtype for _, v in tree_leaves(like)]
    return layout.unflatten([v.to(dt) for (_, v), dt in zip(tree_leaves(views), dtypes)])


def _topk_leaf(t2: torch.Tensor, comp: Compression) -> torch.Tensor:
    """top-k (or qtopk) decode(encode(·)) of one (n, s) fp32 leaf.  Ties go
    to the lower index, as ``jax.lax.top_k`` orders them (a stable sort)."""
    n, s = t2.shape
    c = min(comp.chunk, s)
    t3 = F.pad(t2, (0, -s % c)).reshape(n, -1, c)
    k = comp.topk_count(c)
    idx = torch.sort(t3.abs(), dim=-1, descending=True, stable=True).indices[..., :k]
    kept = torch.gather(t3, -1, idx)
    if comp.codec == "qtopk":
        amax = t3.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp_min(amax, 1e-30) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
        kept = torch.clamp(torch.round(kept / scale), -127.0, 127.0) * scale
    return torch.zeros_like(t3).scatter_(-1, idx, kept).reshape(n, -1)[:, :s]


def _topk_flat(t: torch.Tensor, sizes: tuple[int, ...], comp: Compression) -> torch.Tensor:
    parts, off = [], 0
    for size in sizes:
        if size:
            parts.append(_topk_leaf(t[:, off : off + size], comp))
        off += size
    return torch.cat(parts, dim=1)


def _new_mirror(
    x: torch.Tensor, h: torch.Tensor, sizes: tuple[int, ...], comp: Compression, keep: torch.Tensor | None
) -> torch.Tensor:
    """Plain h' of one round over flat rows: h + C(x − h), or C(x) without
    error feedback; rows where ``keep`` is False keep h."""
    if comp.codec in ("int8", "fp8"):
        bounds = _bounds(sizes, comp.chunk, x.device)
        kw = dict(codec=comp.codec, error_feedback=comp.error_feedback)
        scales = quant_scales_ref(x, h, bounds, **kw)
        return dequantise_ref(x, h, bounds, scales, keep=keep, **kw)
    t = x.to(torch.float32)
    h_new = h + _topk_flat(t - h, sizes, comp) if comp.error_feedback else _topk_flat(t, sizes, comp)
    if keep is not None:
        h_new = torch.where(keep[:, None], h_new, h)
    return h_new


def encode_decode(params: Tree | torch.Tensor, comp: Compression, layout: FlatLayout | None = None):
    """decode(encode(·)) of node-stacked params, per leaf, fp32 out: a dict
    tree, or a flat (n, d) buffer whose leaves ``layout`` gives (None: the
    row is one leaf).  Codec ``"none"`` returns ``params`` untouched."""
    if not comp.active:
        return params
    if isinstance(params, dict):
        lay = FlatLayout.of(params)
        return _unflat(encode_decode(_flat32(params, lay), comp, lay), lay)
    sizes = _sizes(params, layout)
    if comp.codec in ("int8", "fp8"):
        bounds = _bounds(sizes, comp.chunk, params.device)
        scales = quant_scales_ref(params, None, bounds, codec=comp.codec)
        return dequantise_ref(params, None, bounds, scales, codec=comp.codec)
    return _topk_flat(params.to(torch.float32), sizes, comp)


# ------------------------------------------------------------ residual carry
def init_residuals(params: Tree | torch.Tensor):
    """Zero mirrors: params-shaped, fp32."""
    return tree_map(lambda v: torch.zeros(v.shape, dtype=torch.float32, device=v.device), params)


def seed_residual(state, compression: Compression | None):
    """Attach zero mirrors to a ``DFLState`` when the codec needs them."""
    if compression is None or not compression.active or state.residual is not None:
        return state
    return dataclasses.replace(state, residual=init_residuals(state.params))


# ------------------------------------------------------------ mixing forms
def _keep(update_mask, device) -> torch.Tensor | None:
    return None if update_mask is None else torch.as_tensor(update_mask, dtype=torch.bool, device=device)


def _delta_step(x: torch.Tensor, mixed: torch.Tensor, h_new: torch.Tensor, gamma: float) -> torch.Tensor:
    return (x.to(torch.float32) + gamma * (mixed - h_new)).to(x.dtype)


def compressed_mix_with(
    mix_fn: Callable,
    params: Tree | torch.Tensor,
    residual: Tree | torch.Tensor,
    comp: Compression,
    *,
    update_mask: torch.Tensor | None = None,
    layout: FlatLayout | None = None,
):
    """Error-feedback delta-form gossip around ANY linear node-mixing
    operator ``mix_fn`` (it gets h' in the form of ``params``, a dict tree
    or a flat buffer), in plain torch: returns ``(x', h')``.

    ``update_mask`` ((n,) bool) freezes the mirrors of rows it marks False.
    Codec ``"none"`` returns ``(mix_fn(params), residual)`` verbatim.
    """
    if not comp.active:
        return mix_fn(params), residual
    if isinstance(params, dict):
        lay = FlatLayout.of(params)
        x, h = _flat32(params, lay), _flat32(residual, lay)
        h_new = _new_mirror(x, h, lay.sizes, comp, _keep(update_mask, x.device))
        mixed = _flat32(mix_fn(_unflat(h_new, lay)), lay)
        return _unflat(_delta_step(x, mixed, h_new, comp.gamma), lay, params), _unflat(h_new, lay)
    h_new = _new_mirror(params, residual, _sizes(params, layout), comp, _keep(update_mask, params.device))
    return _delta_step(params, mix_fn(h_new), h_new, comp.gamma), h_new


def compressed_mix(
    plan,
    params: Tree | torch.Tensor,
    residual: Tree | torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    compression: Compression,
    active: torch.Tensor | None = None,
    edge_live: torch.Tensor | None = None,
    update_mask: torch.Tensor | None = None,
    layout: FlatLayout | None = None,
    round_index: int | None = None,
):
    """One compressed DecAvg round over a ``CommPlan``: returns ``(x', h')``.

    The round's operator is drawn once (``plan.round_operator``, one
    failure draw, as an uncompressed round).  int8 / fp8 rounds are one
    quantised mix (``kernels/mix/ops.py::quant_mix_flat``); topk and
    qtopk compute h' in plain torch and mix it with ``mix_flat``.  A
    ``ppermute`` plan computes h' in plain torch and mixes it by its colour
    schedule (one draw, in ``plan.mix``).  ``plan`` may be a
    ``PlanSchedule``: ``round_index`` then picks the plan.
    ``compression.stream`` gives the same result: nothing here holds an
    ``(n, d)`` temporary that streaming would avoid.
    """
    if round_index is not None:
        plan = plan.select(round_index)
    comp = compression
    if not comp.active:
        return plan.mix(params, generator, active=active, edge_live=edge_live), residual
    if plan.failures.active and generator is None:
        raise ValueError("failure model active: mix() needs a torch.Generator")
    if isinstance(params, dict):
        lay = FlatLayout.of(params)
        x_new, h_new = compressed_mix(
            plan, _flat32(params, lay), _flat32(residual, lay), generator, compression=comp,
            active=active, edge_live=edge_live, update_mask=update_mask, layout=lay,
        )
        return _unflat(x_new, lay, params), _unflat(h_new, lay)
    if residual.shape != params.shape or residual.dtype != torch.float32:
        raise ValueError(f"residual must be fp32 {tuple(params.shape)}, got {residual.dtype} {tuple(residual.shape)}")
    sizes = _sizes(params, layout)
    keep = _keep(update_mask, params.device)
    if plan.backend == "ppermute":
        h_new = _new_mirror(params, residual, sizes, comp, keep)
        mixed = plan.mix(h_new, generator, active=active, edge_live=edge_live)
        return _delta_step(params, mixed, h_new, comp.gamma), h_new
    op = plan.round_operator(generator, active=active, edge_live=edge_live)
    if comp.codec in ("int8", "fp8"):
        return quant_mix_flat(
            op, params, residual, _edges(sizes, comp.chunk), codec=comp.codec,
            gamma=comp.gamma, error_feedback=comp.error_feedback, keep=keep,
        )
    h_new = _new_mirror(params, residual, sizes, comp, keep)
    return _delta_step(params, mix_flat(op, h_new), h_new, comp.gamma), h_new


def compressed_spread(
    plan,
    values: torch.Tensor,
    residual: torch.Tensor | None,
    generator: torch.Generator | None = None,
    *,
    compression: Compression,
    active: torch.Tensor | None = None,
    edge_live: torch.Tensor | None = None,
    round_index: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One compressed send-form (push) round over a ``CommPlan``:
    ``v' = v + γ (Mᵀ h' − h')`` with ``h' = h + C(v − h)``; returns
    ``(v', h')``.  ``values`` is an (n,) or (n, k) payload, each row one
    leaf; ``residual`` the fp32 mirror of its shape (None: zeros).

    Because the masked Mᵀ is column-stochastic, ``sum(Mᵀ h') = sum(h')``
    and the round conserves the total of ``values`` for any codec.  As
    ``compressed_mix``: int8 / fp8 are one quantised mix over Mᵀ
    (``ops.quant_mix_flat``), topk / qtopk the plain codec, then ``mix_flat``;
    a ``ppermute`` plan the plain codec, then its colour spread.  Over a
    ``PlanSchedule`` ``round_index`` picks the plan.
    """
    if round_index is not None:
        plan = plan.select(round_index)
    comp = compression
    if not comp.active:
        return plan.spread(values, generator, active=active, edge_live=edge_live), residual
    if plan.failures.active and generator is None:
        raise ValueError("failure model active: spread() needs a torch.Generator")
    v = torch.as_tensor(values, dtype=torch.float32, device=plan.device)
    x = v.reshape(plan.n, -1).contiguous()
    h = torch.zeros_like(x) if residual is None else torch.as_tensor(residual, dtype=torch.float32).reshape(x.shape)
    sizes = (x.shape[1],)
    if plan.backend == "ppermute":
        h_new = _new_mirror(x, h, sizes, comp, None)
        x_new = _delta_step(x, plan.spread(h_new, generator, active=active, edge_live=edge_live), h_new, comp.gamma)
        return x_new.reshape(v.shape), h_new.reshape(v.shape)
    op = plan.send_operator(generator, active=active, edge_live=edge_live)
    if comp.codec in ("int8", "fp8"):
        x_new, h_new = quant_mix_flat(
            op, x, h.contiguous(), _edges(sizes, comp.chunk), codec=comp.codec, gamma=comp.gamma,
            error_feedback=comp.error_feedback,
        )
    else:
        h_new = _new_mirror(x, h, sizes, comp, None)
        x_new = _delta_step(x, mix_flat(op, h_new), h_new, comp.gamma)
    return x_new.reshape(v.shape), h_new.reshape(v.shape)
