"""Step functions + input specs for every (architecture × input shape)
(counterpart of ``repro/launch/steps.py``).

The deployable SPMD layer: given an arch config, an input shape name and a
``DeviceMesh`` (``launch/mesh.py``), each builder returns

    * the step function, which runs on DTensors laid out by the shardings,
    * example args: fake tensors (``FakeTensorMode``) of the global shapes
      and dtypes, nothing allocated (the JAX ``ShapeDtypeStruct``s),
    * in / out shardings (``launch/shardings.py::NamedSharding``).

``shard_args(args, in_shardings)`` turns global tensors (real or fake) into
the DTensors a step takes: each rank keeps its own slice.

Training = one DFL communication round on the mesh: every FL node (one
``data`` slice, or ``("pod", "data")`` multi-pod) takes ``local_batches``
gradient steps, then the ensemble aggregates through a compiled
``CommPlan``, then the optimizer state is re-initialised (Algorithm 1 line
15).  A rank holds its nodes' rows of every node-stacked leaf; the local
steps run a node at a time, as a model-parallel program on the ``model``
sub-mesh (the JAX ``vmap`` over a data-sharded node axis), and the mix runs
on the rank's local shards through ``core.shardplan`` over the node axis's
process group — DecAvg acts on the node dimension only, so a model-sharded
leaf mixes its local columns:

    mixing="dense"      one all-gather of the rows, the rank's rows of the
                        round matrix through the dense kernel (#1).
    mixing="sparse"     the halo exchange, the row-list kernel (#2y; the
                        hub rows over one all-gather when a rank owns a
                        hub; a masked round the block-sparse kernel, #2).
    mixing="ppermute"   edge-coloured exchanges, one node a rank
                        (``mix_pytree_colored``'s process-group form; with
                        every node on one rank, its one-device form);
                        "circulant" is kept as an alias.

Serving = consensus model; decode is ONE token against a cache of seq_len.
The serving steps run under ``torch.no_grad()``, so attention goes through
the flash kernel on each rank's own heads (``repro_torch.dtensor``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import topology
from repro_torch.core.commplan import compile_plan
from repro_torch.core.initialisation import InitConfig, gain_from_graph
from repro_torch.core.shardplan import shard_plan
from repro_torch.dtensor import (
    DTensor,
    FakeTensorMode,
    Replicate,
    Shard,
    fake_mode_of,
    implicit_replication,
    is_dtensor,
    local_shape,
    mesh_group,
)
from repro_torch.flat import tree_leaves, tree_map, tree_structure, tree_unflatten
from repro_torch.models import transformer as tfm
from repro_torch.optim import Optimizer, sgd

from . import shardings as shard_rules
from .mesh import n_fl_nodes, node_axis
from .shardings import NamedSharding, P

PyTree = Any

__all__ = [
    "CIRCULANT_OFFSETS",
    "SHAPES",
    "ShapeSpec",
    "abstract_params",
    "build",
    "build_decode_step",
    "build_prefill_step",
    "build_train_step",
    "params_strip_node",
    "shard_args",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# the circulant communication graph of the production training rounds:
# offsets (1, 2) → a degree-4 ring, the paper's default k regime
CIRCULANT_OFFSETS = (1, 2)


# ------------------------------------------------------------ abstract args
class _MetaFactories(torch.overrides.TorchFunctionMode):
    """Every factory call that names a device makes a meta tensor instead."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


@functools.lru_cache(maxsize=32)
def abstract_params(cfg: ArchConfig, gain: float = 1.0) -> PyTree:
    """The decoder's parameter tree as meta tensors (shapes and dtypes,
    nothing drawn or allocated): ``init_params`` run with its factories on
    the meta device, where the draws return at once.  The draws of a real
    init are untouched.  Cached: callers build new trees from it and write
    into none."""
    with _MetaFactories():
        return tfm.init_params(torch.Generator(), cfg, InitConfig("trunc_normal", gain), device="cpu")


def _fake(tree: PyTree, fake_mode, device: str) -> PyTree:
    """Fake tensors of the meta tree's shapes and dtypes on ``device``."""
    with fake_mode:
        return shard_rules.map_with_path(lambda _, t: torch.empty(t.shape, dtype=t.dtype, device=device), tree)


def _token_spec(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """tokens (+ frontend embeds) for one sequence batch, as meta tensors."""
    text_len = seq - cfg.n_frontend_tokens
    out = {"tokens": torch.empty((batch, text_len), dtype=torch.int32, device="meta")}
    if cfg.frontend and cfg.n_frontend_tokens:
        out["frontend"] = torch.empty((batch, cfg.n_frontend_tokens, cfg.frontend_embed_dim), dtype=torch.bfloat16,
                                      device="meta")
    return out


def params_strip_node(params: PyTree) -> PyTree:
    """Drop the leading node dim from abstract param shapes (spec helper)."""
    return tree_map(lambda t: torch.empty(t.shape[1:], dtype=t.dtype, device="meta"), params)


def shard_args(args: PyTree, shardings: PyTree) -> PyTree:
    """Global tensors (real or fake) → the DTensors a step takes: each rank
    keeps its own slice (no collective), laid out by the matching
    ``NamedSharding``."""

    def one(t: torch.Tensor, sh: NamedSharding) -> DTensor:
        if is_dtensor(t):
            return t
        shape, offsets = local_shape(t.shape, sh.mesh, sh.placements)
        local = t
        for d, (o, size) in enumerate(zip(offsets, shape)):
            if size != t.shape[d]:
                local = local.narrow(d, o, size)
        local = local.contiguous() if local is not t else t
        return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False)

    return _zip_map(one, args, shardings)


def _zip_map(fn, tree, other):
    """fn(leaf, other_leaf) over two trees of one structure (dicts, lists,
    tuples, NamedTuples; a ``NamedSharding`` or a tensor is a leaf)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Tensor):
        items = [_zip_map(fn, a, b) for a, b in zip(tree, other)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, other)


def _opt_init(opt: Optimizer, params: PyTree):
    """``opt.init`` over a tree, state in the JAX layout: a NamedTuple of
    trees (``SgdState(momentum=tree)``)."""
    leaves = [t for _, t in tree_leaves(params)]
    struct = tree_structure(params)
    states = [opt.init(t) for t in leaves]
    return type(states[0])(*(tree_unflatten(struct, [s[i] for s in states]) for i in range(len(states[0]))))


def _state_leaves(state) -> list[list[torch.Tensor]]:
    """A tree-of-fields state → one list of field values a leaf."""
    per_field = [[t for _, t in tree_leaves(f)] for f in state]
    return [list(x) for x in zip(*per_field)]


# ---------------------------------------------------------------- train
def _loss_fn(cfg: ArchConfig, remat: bool):
    def loss_fn(params: PyTree, batch: dict) -> torch.Tensor:
        fe = batch.get("frontend")
        hidden, aux = tfm.forward(params, cfg, batch["tokens"], fe, remat=remat)
        nf = cfg.n_frontend_tokens if (cfg.frontend and fe is not None) else 0
        hidden_text = hidden[..., nf:, :] if nf else hidden
        loss = tfm.lm_loss(params, cfg, hidden_text, batch["targets"])
        return loss + tfm.AUX_WEIGHT * aux

    return loss_fn


def build_train_step(
    cfg: ArchConfig,
    mesh,
    *,
    multi_pod: bool = False,
    mixing: str = "dense",
    local_batches: int = 1,
    optimizer: Optimizer | None = None,
    remat: bool = True,
    seq_len: int | None = None,
    fake_mode=None,
):
    """Returns (step_fn, example_args, in_shardings, out_shardings)."""
    n = n_fl_nodes(multi_pod=multi_pod)
    node_ax = node_axis(multi_pod=multi_pod)
    # degree-4 circulant at production sizes; complete graph for the tiny
    # meshes of the tests (offsets would degenerate)
    graph = topology.circulant(n, CIRCULANT_OFFSETS) if n >= 5 else topology.complete(n)
    gain = gain_from_graph(graph)
    opt = optimizer or sgd(1e-3, 0.5)
    if mixing == "circulant":  # alias: colouring ≡ offset schedule
        mixing = "ppermute"
    device = mesh.device_type
    plan = compile_plan(graph, backend=mixing, device=_plan_device(device))
    fake_mode = fake_mode or FakeTensorMode(allow_non_fake_inputs=True)
    loss_fn = _loss_fn(cfg, remat)
    names = tuple(mesh.mesh_dim_names)
    node_dims = [names.index(a) for a in node_ax]
    model_dim = names.index("model")

    # ---- abstract inputs ---------------------------------------------
    p1 = abstract_params(cfg, gain)
    params_meta = tree_map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype, device="meta"), p1)
    opt_meta = _opt_init(opt, params_meta)
    node_pspecs = shard_rules.with_node_axis(shard_rules.param_pspecs(p1, cfg, mesh), node_ax)
    ospecs = shard_rules.with_node_axis(shard_rules.param_pspecs(_opt_init(opt, p1), cfg, mesh), node_ax)
    per_node = SHAPES["train_4k"].global_batch // n
    seq = seq_len or SHAPES["train_4k"].seq_len
    batch_meta = {k: torch.empty((n, local_batches, *v.shape), dtype=v.dtype, device="meta")
                  for k, v in _token_spec(cfg, per_node, seq).items()}
    text_len = seq - cfg.n_frontend_tokens
    batch_meta["targets"] = torch.empty((n, local_batches, per_node, text_len), dtype=torch.int32, device="meta")
    nax = tuple(node_ax) if len(node_ax) > 1 else node_ax[0]
    bspecs = {k: P(nax, *([None] * (v.ndim - 1))) for k, v in batch_meta.items()}
    in_shardings = (
        shard_rules.shardings_for(node_pspecs, mesh),
        shard_rules.shardings_for(ospecs, mesh),
        shard_rules.shardings_for(bspecs, mesh),
    )
    out_shardings = (in_shardings[0], in_shardings[1], shard_rules.shardings_for(P(), mesh))
    args = tuple(_fake(t, fake_mode, device) for t in (params_meta, opt_meta, batch_meta))

    sub = mesh["model"]
    mixer: dict = {}

    def per_node_view(x: DTensor, j: int) -> DTensor:
        """Node j's leaf (of this rank's nodes) on the model sub-mesh."""
        pm = x.placements[model_dim]
        pm = Shard(pm.dim - 1) if isinstance(pm, Shard) else Replicate()
        return DTensor.from_local(x.to_local()[j], sub, [pm], run_check=False)

    def mix(local: PyTree) -> PyTree:
        """One DecAvg round on this rank's (nps, ...) rows of every leaf."""
        if "plan" not in mixer:
            group = mesh_group(mesh, node_ax)
            size = torch.distributed.get_world_size(group)
            mixer["plan"] = plan if (plan.backend == "ppermute" and size == 1) else shard_plan(plan, group=group)
        m = mixer["plan"]
        with fake_mode_of(tree_leaves(local)[0][1]):  # the mix's buffers are fake too on fake shards
            return m.mix(local) if m is plan else m.local_mix(local)

    def step(params, opt_state, batch):
        p_leaves = [t for _, t in tree_leaves(params)]
        struct = tree_structure(params)
        s_leaves = _state_leaves(opt_state)
        nps = p_leaves[0].to_local().shape[0]
        new_local, losses = [[] for _ in p_leaves], []
        with implicit_replication():
            for j in range(nps):
                ps = [per_node_view(t, j) for t in p_leaves]
                ss = [[per_node_view(f, j) for f in fields] for fields in s_leaves]
                node_losses = []
                for b in range(local_batches):
                    batch_j = {k: DTensor.from_local(v.to_local()[j, b], sub, [Replicate()], run_check=False)
                               for k, v in batch.items()}
                    ps = [t.detach().requires_grad_(True) for t in ps]
                    loss = loss_fn(tree_unflatten(struct, ps), batch_j)
                    # a leaf the loss does not reach has a zero gradient, as jax.grad gives
                    grads = torch.autograd.grad(loss, ps, allow_unused=True)
                    nxt_p, nxt_s = [], []
                    for p, g, fields in zip(ps, grads, ss):
                        g = torch.zeros_like(p) if g is None else g
                        # a replicated leaf's gradient is a pending sum over
                        # the model ranks: reduce it (one all-reduce)
                        g = g if g.placements == p.placements else g.redistribute(sub, p.placements)
                        upd, st = opt.update(g, type(opt_state)(*fields), p)
                        nxt_p.append((p + upd.to(p.dtype)).detach())
                        nxt_s.append([f.detach() for f in st])
                    ps, ss = nxt_p, nxt_s
                    node_losses.append(loss.detach().full_tensor().float())
                losses.append(torch.stack(node_losses).mean())
                for i, p in enumerate(ps):
                    new_local[i].append(p.to_local())
            mixed = mix(tree_unflatten(struct, [torch.stack(rows) for rows in new_local]))
            out = [DTensor.from_local(m, t.device_mesh, t.placements, run_check=False)
                   for m, (_, t) in zip([m for _, m in tree_leaves(mixed)], tree_leaves(params))]
            new_params = tree_unflatten(struct, out)
            new_state = _opt_init(opt, new_params)  # Algorithm 1 line 15
            lp = [Replicate()] * mesh.ndim
            for d in node_dims:
                lp[d] = Shard(0)
            loss = DTensor.from_local(torch.stack(losses), mesh, lp, run_check=False).mean()
            loss = loss.redistribute(mesh, [Replicate()] * mesh.ndim)
        return new_params, new_state, loss

    return step, args, in_shardings, out_shardings


def _plan_device(device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


# ===================================================================== serve
def _out(x: DTensor, sh: NamedSharding) -> DTensor:
    """x laid out as the step's out sharding."""
    if not is_dtensor(x) or tuple(x.placements) == tuple(sh.placements):
        return x
    return x.redistribute(sh.mesh, sh.placements)


def build_prefill_step(cfg: ArchConfig, mesh, *, multi_pod: bool = False, seq_len: int | None = None,
                       fake_mode=None):
    shape = SHAPES["prefill_32k"]
    nax = ("pod", "data") if multi_pod else "data"
    fake_mode = fake_mode or FakeTensorMode(allow_non_fake_inputs=True)
    device = mesh.device_type

    params_meta = abstract_params(cfg, 1.0)
    batch_meta = _token_spec(cfg, shape.global_batch, seq_len or shape.seq_len)
    pspecs = shard_rules.param_pspecs(params_meta, cfg, mesh)
    bdiv = shape.global_batch % _ax_size(mesh, nax) == 0
    bspecs = {k: P(nax if bdiv else None, *([None] * (v.ndim - 1))) for k, v in batch_meta.items()}
    in_shardings = (shard_rules.shardings_for(pspecs, mesh), shard_rules.shardings_for(bspecs, mesh))
    vdiv = cfg.vocab_size % _ax_size(mesh, "model") == 0
    out_shardings = shard_rules.shardings_for(P(nax if bdiv else None, "model" if vdiv else None), mesh)

    def step(params, batch):
        fe = batch.get("frontend")
        with torch.no_grad(), implicit_replication():
            hidden, _ = tfm.forward(params, cfg, batch["tokens"], fe, remat=False)
            logits = tfm.hidden_to_logits(params, cfg, hidden[..., -1:, :])[..., 0, :]
            return _out(logits, out_shardings)

    args = (_fake(params_meta, fake_mode, device), _fake(batch_meta, fake_mode, device))
    return step, args, in_shardings, out_shardings


def build_decode_step(cfg: ArchConfig, mesh, *, shape_name: str = "decode_32k", multi_pod: bool = False,
                      fake_mode=None):
    shape = SHAPES[shape_name]
    nax = ("pod", "data") if multi_pod else "data"
    b = shape.global_batch
    bdiv = b % _ax_size(mesh, nax) == 0
    fake_mode = fake_mode or FakeTensorMode(allow_non_fake_inputs=True)
    device = mesh.device_type

    params_meta = abstract_params(cfg, 1.0)
    cache_meta = tfm.init_cache(cfg, (b,), shape.seq_len, device="meta")
    pspecs = shard_rules.param_pspecs(params_meta, cfg, mesh)
    batch_axis = ("+".join(nax) if isinstance(nax, tuple) else nax) if bdiv else None
    seq_axis = None if bdiv else ("+".join(nax) if isinstance(nax, tuple) else nax)
    cspecs = shard_rules.cache_pspecs(cache_meta, cfg, mesh, batch_axis=batch_axis, seq_axis=seq_axis)
    in_shardings = (
        shard_rules.shardings_for(pspecs, mesh),
        shard_rules.shardings_for(cspecs, mesh),
        shard_rules.shardings_for(P(nax if bdiv else None, None), mesh),
        shard_rules.shardings_for(P(), mesh),
    )
    vdiv = cfg.vocab_size % _ax_size(mesh, "model") == 0
    out_shardings = (
        shard_rules.shardings_for(P(nax if bdiv else None, None, "model" if vdiv else None), mesh),
        shard_rules.shardings_for(cspecs, mesh),
    )

    def step(params, cache, tokens, pos):
        with torch.no_grad(), implicit_replication():
            logits, cache = tfm.decode_step(params, cfg, cache, tokens, int(pos.to_local() if is_dtensor(pos) else pos))
            return _out(logits, out_shardings[0]), cache

    with fake_mode:
        tokens = torch.empty((b, 1), dtype=torch.int32, device=device)
        # the decode position is read on the host (the cache slot): a fake
        # constant, as a traced scalar would be
        pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32, device=device)
    args = (_fake(params_meta, fake_mode, device), _fake(cache_meta, fake_mode, device), tokens, pos)
    return step, args, in_shardings, out_shardings


def _ax_size(mesh, nax) -> int:
    sizes = shard_rules.mesh_axes(mesh).shape
    if isinstance(nax, tuple):
        return math.prod(sizes[a] for a in nax)
    return sizes[nax]


def build(
    cfg: ArchConfig,
    shape_name: str,
    mesh,
    *,
    multi_pod: bool = False,
    mixing: str = "dense",
    seq_len: int | None = None,
    fake_mode=None,
):
    """Dispatch: (arch, shape) → (step_fn, args, in_shardings, out_shardings)."""
    kind = SHAPES[shape_name].kind
    if kind == "train":
        return build_train_step(cfg, mesh, multi_pod=multi_pod, mixing=mixing, seq_len=seq_len, fake_mode=fake_mode)
    if kind == "prefill":
        return build_prefill_step(cfg, mesh, multi_pod=multi_pod, seq_len=seq_len, fake_mode=fake_mode)
    return build_decode_step(cfg, mesh, shape_name=shape_name, multi_pod=multi_pod, fake_mode=fake_mode)
