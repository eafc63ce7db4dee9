"""Partition specs for every parameter / state / input tensor (counterpart
of ``repro/launch/shardings.py``).

The rules are the JAX package's, path and shape driven (DESIGN.md §8):

* FL node axis            → ``data`` (train shapes) or ``("pod","data")``
* tensor parallelism      → ``model``: attention heads (fallback: head_dim
                            when the head count doesn't divide the axis —
                            qwen1.5's 20H, llama4's 40H), FFN hidden dim,
                            MoE expert dim, vocab (fallback: d_model when
                            vocab doesn't divide — granite's 49155)
* period-stacked layers   → extra leading None (the ``stack`` lists)
* structured scalars      → replicated

Divisibility is checked per tensor: any dim not divisible by the axis size
falls back to replication.

A spec is a ``PartitionSpec``: a tuple with one entry per tensor dim, each
an axis name, a tuple of names, or None (the JAX ``PartitionSpec`` as pure
data, without jax).  The rules read only a mesh's ``axis_names`` and
``shape`` (a mapping from axis name to size), so a plain stand-in serves
as well as a ``DeviceMesh`` (``mesh_axes`` gives a ``DeviceMesh`` that
form).  ``shardings_for`` turns specs into ``NamedSharding``s: the
DTensor placements over a ``DeviceMesh``, ``Shard(d)`` on every mesh dim a
tensor dim names (a ``("pod", "data")`` entry shards dim d over both, pod
major, the JAX order) and ``Replicate()`` on the others.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.configs.base import ArchConfig

PyTree = Any

__all__ = [
    "NamedSharding",
    "P",
    "PartitionSpec",
    "cache_pspecs",
    "commplan_in_specs",
    "map_with_path",
    "mesh_axes",
    "node_stack_specs",
    "param_pspecs",
    "shardings_for",
    "with_node_axis",
]

_MODEL = "model"


class PartitionSpec(tuple):
    """One entry per tensor dim: an axis name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec laid on a mesh: ``placements`` has one DTensor placement a
    mesh dim (the JAX ``NamedSharding``'s counterpart)."""

    mesh: Any
    spec: PartitionSpec
    placements: tuple


@dataclasses.dataclass(frozen=True)
class _Axes:
    axis_names: tuple[str, ...]
    shape: dict[str, int]


def mesh_axes(mesh) -> _Axes:
    """The axis names and sizes of a ``DeviceMesh`` (or of a stand-in that
    already has ``axis_names`` and a ``shape`` mapping)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return _Axes(tuple(mesh.axis_names), dict(mesh.shape))
    return _Axes(tuple(names), dict(zip(names, mesh.shape)))


def _is_container(x) -> bool:
    return isinstance(x, (dict, list)) or (isinstance(x, tuple) and not isinstance(x, PartitionSpec))


def map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over nested dicts, lists, tuples and NamedTuples
    (an optimizer state); a ``PartitionSpec`` is a leaf.  A path holds dict
    keys, list indices and NamedTuple field names."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if _is_container(tree):
        fields = getattr(tree, "_fields", None)
        if fields is not None:  # a NamedTuple
            return type(tree)(*(map_with_path(fn, v, path + (f,)) for f, v in zip(fields, tree)))
        return tuple(map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _map(fn, tree):
    return map_with_path(lambda _, leaf: fn(leaf), tree)


def _div(n: int, size: int) -> bool:
    return n % size == 0


def _leaf_spec(names: list[str], shape: tuple[int, ...], msize: int, replicate_attn: str = "auto") -> PartitionSpec:
    """Logical trailing-dims spec (no node/period prefixes yet)."""
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    gparent = names[-3] if len(names) >= 3 else ""
    rank = len(shape)

    # the attn_weight_sharding variants:
    #   "replicate": all attention weights replicated
    #   "qkv_split": K/V projections replicated, Q/O sharded
    if replicate_attn == "replicate" and "attn" in names:
        return P(*([None] * rank))
    if replicate_attn == "qkv_split" and "attn" in names and parent in ("wk", "wv"):
        return P(*([None] * rank))

    def last2(d0, d1):
        return P(*([None] * (rank - 2)), d0, d1)

    def last1(d0):
        return P(*([None] * (rank - 1)), d0)

    # ---- embeddings / head -------------------------------------------
    if parent == "tok":  # (V, D)
        v, d = shape[-2], shape[-1]
        if _div(v, msize):
            return last2(_MODEL, None)
        return last2(None, _MODEL) if _div(d, msize) else last2(None, None)
    if gparent == "lm_head" or parent == "lm_head":  # (D, V)
        d, v = shape[-2], shape[-1]
        if _div(v, msize):
            return last2(None, _MODEL)
        return last2(_MODEL, None) if _div(d, msize) else last2(None, None)

    # ---- biases / vectors --------------------------------------------
    if leaf == "b" or rank - _n_prefix_dims(names) <= 1:
        d = shape[-1]
        if parent in ("wq", "wk", "wv", "wg", "wr", "w_in", "w_gate", "in_proj", "dt_proj", "wk_c") and _div(d, msize):
            return last1(_MODEL)
        if leaf in ("conv_b", "dt_bias", "d_skip") and _div(d, msize):
            return last1(_MODEL)
        return P(*([None] * rank))

    # ---- MoE expert stacks (E, D, F) / (E, F, D) ----------------------
    if gparent == "ffn" and rank >= 3 and parent in ("w_in", "w_gate", "w_out"):
        e = shape[-3]
        if _div(e, msize):
            return P(*([None] * (rank - 3)), _MODEL, None, None)
        f_dim = -1 if parent in ("w_in", "w_gate") else -2
        if _div(shape[f_dim], msize):
            spec = [None, None, None]
            spec[3 + f_dim] = _MODEL
            return P(*([None] * (rank - 3)), *spec)
        return P(*([None] * rank))
    if parent == "router":
        return P(*([None] * rank))

    # ---- dense 2-D weights -------------------------------------------
    out_sharded = {"wq", "wk", "wv", "wg", "w_in", "w_gate", "in_proj", "dt_proj", "decay_lora_a"}
    in_sharded = {"wo", "w_out", "x_proj", "out_proj", "decay_lora_b"}
    if gparent == "cmix" and parent == "wv":  # rwkv channel-mix wv is (F, D)
        return last2(_MODEL, None) if _div(shape[-2], msize) else last2(None, None)
    if parent in out_sharded or leaf in ("conv_w",):
        return last2(None, _MODEL) if _div(shape[-1], msize) else last2(None, None)
    if parent in in_sharded:
        return last2(_MODEL, None) if _div(shape[-2], msize) else last2(None, None)
    if parent == "wr":
        return last2(None, _MODEL) if _div(shape[-1], msize) else last2(None, None)
    if leaf == "a_log":  # (di, N)
        return last2(_MODEL, None) if _div(shape[-2], msize) else last2(None, None)
    if parent == "frontend_proj" or gparent == "frontend_proj":
        if rank >= 2 and _div(shape[-1], msize):
            return last2(None, _MODEL)
        return P(*([None] * rank))

    # ---- everything else (norm scales, mixes, decay bases, bonus) ----
    return P(*([None] * rank))


def _n_prefix_dims(names: list[str]) -> int:
    """Number of structural leading dims: 1 if under a period-stacked list."""
    return 1 if "stack" in names else 0


def _names(path: tuple) -> list[str]:
    return [str(k) for k in path]


def param_pspecs(params: PyTree, cfg: ArchConfig, mesh) -> PyTree:
    """PartitionSpec tree matching ``params`` (consensus / per-node layout):
    any tree of objects with a ``shape`` (tensors, fake or meta tensors)."""
    axes = mesh_axes(mesh)
    msize = math.prod(axes.shape[a] for a in axes.axis_names if a == _MODEL)
    replicate_attn = getattr(cfg, "attn_weight_sharding", "auto")

    def spec_of(path, leaf):
        shape = tuple(leaf.shape)
        s = _leaf_spec(_names(path), shape, msize, replicate_attn=replicate_attn)
        return P(*([None] * (len(shape) - len(s))), *s)

    return map_with_path(spec_of, params)


def _node_entry(node_ax):
    ax = tuple(node_ax) if isinstance(node_ax, (tuple, list)) else (node_ax,)
    return ax if len(ax) > 1 else ax[0]


def with_node_axis(specs: PyTree, node_ax) -> PyTree:
    """Prepend the FL node axis to every spec (training layout)."""
    ax = _node_entry(node_ax)
    return _map(lambda s: P(ax, *s), specs)


def node_stack_specs(tree: PyTree, node_ax) -> PyTree:
    """``P(node_ax, None, ...)`` per leaf of a node-stacked tree: the node
    dimension first and only that dimension sharded, each spec from the
    leaf's own rank."""
    ax = _node_entry(node_ax)
    return _map(lambda leaf: P(ax, *([None] * (len(leaf.shape) - 1))), tree)


def commplan_in_specs(backend: str, node_ax) -> tuple[PartitionSpec, ...]:
    """Specs of a ``CommPlan``'s explicit operands: only the ppermute
    backend has any, its (n_colors, n) colour weights and (n,) self weights
    sharded along the node axis (each node group reads its own column of
    the schedule); the dense and sparse operators index the global node
    axis and have none."""
    if backend != "ppermute":
        return ()
    ax = _node_entry(node_ax)
    return (P(None, ax), P(ax))


def _axis_entry(axis: str):
    return axis if "+" not in axis else tuple(axis.split("+"))


def _axsize(axes: _Axes, axis: str) -> int:
    return math.prod(axes.shape[a] for a in axis.split("+"))


def cache_pspecs(cache: PyTree, cfg: ArchConfig, mesh, *, batch_axis: str | None, seq_axis: str | None) -> PyTree:
    """KV/state cache specs.

    decode_32k: batch over ``data``; long_500k (batch=1): the *sequence* dim
    of attention caches shards over ``data`` instead; SSM/conv states shard
    their feature dim over ``model`` when divisible.  An axis ``"pod+data"``
    names both (the multi-pod batch).
    """
    axes = mesh_axes(mesh)
    msize = axes.shape[_MODEL]

    def batch_ok(shape, stacked):
        return batch_axis and shape[stacked] % _axsize(axes, batch_axis) == 0

    def spec_of(path, leaf):
        names = _names(path)
        leafname = names[-1]
        shape = tuple(leaf.shape)
        stacked = 1 if "stack" in names else 0
        body: list = [None] * (len(shape) - stacked)
        if leafname in ("k", "v"):  # (B, T, KVH, hd)
            if batch_ok(shape, stacked):
                body[0] = _axis_entry(batch_axis)
            elif seq_axis and shape[stacked + 1] % _axsize(axes, seq_axis) == 0:
                body[1] = _axis_entry(seq_axis)
            # KV heads shard over model only when they fill the axis (MHA);
            # GQA kv heads below the axis size stay replicated
            if shape[stacked + 2] % msize == 0:
                body[2] = _MODEL
        elif leafname == "conv":  # (B, dc-1, di)
            if batch_ok(shape, stacked):
                body[0] = _axis_entry(batch_axis)
            if shape[stacked + 2] % msize == 0:
                body[2] = _MODEL
        elif leafname == "ssm":  # (B, di, N)
            if batch_ok(shape, stacked):
                body[0] = _axis_entry(batch_axis)
            if shape[stacked + 1] % msize == 0:
                body[1] = _MODEL
        elif leafname in ("tshift", "cshift"):  # (B, 1, D)
            if batch_ok(shape, stacked):
                body[0] = _axis_entry(batch_axis)
            if shape[stacked + 2] % msize == 0:
                body[2] = _MODEL
        elif leafname == "state":  # (B, H, M, M)
            if batch_ok(shape, stacked):
                body[0] = _axis_entry(batch_axis)
            elif shape[stacked + 1] % msize == 0:
                body[1] = _MODEL
        return P(*([None] * stacked), *body)

    return map_with_path(spec_of, cache)


def placements_for(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` for the tensor dim d whose entry names it, else
    ``Replicate()``.  A tuple entry ``("pod", "data")`` shards d over both
    dims, pod first (the JAX order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axes(mesh).axis_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(ax)] = Shard(d)
    return tuple(out)


def shardings_for(specs: PyTree, mesh) -> PyTree:
    """A ``NamedSharding`` per spec of ``specs``."""
    return _map(lambda s: NamedSharding(mesh, s, placements_for(s, mesh)), specs)
