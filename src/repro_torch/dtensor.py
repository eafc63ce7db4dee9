"""The distributed-tensor layer of the launch layer's step functions, in one
place.

``launch/steps.py`` runs the decoders on DTensors over a ``DeviceMesh``:
every parameter and input is a ``torch.distributed.tensor.DTensor`` whose
placements come from ``launch/shardings.py``, and DTensor's sharding
propagation inserts the collectives (the GSPMD partitioner's part in the
JAX package).  The decoders stay written for plain tensors; where a step
must know of the mesh, they call a helper here, which passes a plain
tensor through untouched:

* ``split_heads``: the (..., n·hd) → (..., n, hd) view of a projection.
  When the last dim is sharded over a mesh dim whose size does not divide
  n (GQA's 2 K/V heads over a 16-wide ``model`` axis; qwen1.5's 20 heads),
  DTensor cannot shard the head dim, so that mesh dim is gathered first:
  one all-gather of the projection over it.  (GSPMD shards within a head
  there instead.)
* ``on_local_heads``: an attention core on the local shards, as
  ``local_map`` runs a function.  Heads are local to a model rank, so the
  core (a kernel on the card, its plain version on the CPU) runs on each
  rank's own heads: on the card it launches on the local tensors, which
  have pointers, where a DTensor has none.  With q's heads sharded and
  GQA's K/V replicated, each rank reads the K/V heads its q heads use, and
  the K/V gradients are pending sums over the heads' mesh dims (a
  reduce-scatter in the backward of ``split_heads``' gather).
* ``on_local_batch``: a core whose heads are all needed together (the
  RWKV time-mix: its heads are gathered whenever the mesh cannot split
  them) on each rank's own batch rows, every head computed there; a
  shared weight's gradient is a pending sum over the batch's mesh dims.
* ``replicate``: a DTensor gathered over every mesh dim (the MoE
  dispatch and combine index tokens and expert slots by the global
  routing, which DTensor's own index strategy marks for a masked reduction
  that its backward cannot carry out).
* ``replicated``: a function with no sharding rule (MoE routing's
  ``searchsorted``) run on full, replicated tensors: each input is
  gathered, the outputs are replicated DTensors.
* ``embed``: the token embedding's lookup, on DTensors that autograd
  does not record through ``F.embedding`` (DTensor's vocab-parallel rule)
  rather than an index, whose sharding rule torch 2.11 lacks for tokens
  split over two mesh dims (the multi-pod batch of the serving steps).
  Under autograd it stays an index: the vocab-parallel rule's gradient is
  a masked pending sum that cannot join a tied head's.
* ``batch_layout``: the residual stream's layout between blocks, its
  batch split as the tokens' and replicated over every other mesh dim
  (the Megatron layout: a block's row-parallel output projection ends in
  one all-reduce over ``model``).  DTensor's propagation alone chose
  layouts that replicated whole layers' products.
* ``residual``: x + y with y laid out as x first, so a row-parallel
  projection's pending sum (``Partial``) is reduced before the add, not
  carried into the next norm.
* ``gather_last``: ``torch.gather`` of one entry a row along a sharded
  last dim (the cross-entropy's target logit over a vocab-sharded head):
  each rank picks the targets in its own vocab range and the picks are a
  pending sum (``Partial``) over the vocab's mesh dims, the vocab-parallel
  cross-entropy.  (DTensor's own gather strategy there marks its output
  for a masked reduction that later fails on this shape.)
* ``implicit_replication``: plain tensors a decoder makes (positions,
  RoPE's trig, a token shift's zeros) count as replicated.

The fake world of the dry run (``fake_world``): a ``"fake"`` process group
of 256 or 512 ranks in this one process (``FakeStore``), which moves no
data, and ``FakeTensorMode``, whose tensors carry shapes and dtypes but no
storage.  ``FakeStore``, ``torch.distributed.tensor.experimental`` and the
fake mode are private or experimental APIs that change between torch
releases, so they are imported here and nowhere else.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = [
    "DTensor",
    "FakeTensorMode",
    "Replicate",
    "Shard",
    "batch_layout",
    "embed",
    "fake_mode_of",
    "fake_world",
    "gather_last",
    "implicit_replication",
    "is_dtensor",
    "local_shape",
    "mesh_group",
    "on_local_batch",
    "on_local_heads",
    "replicate",
    "replicated",
    "residual",
    "split_heads",
]


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def implicit_replication():
    """Plain tensors mixed with DTensors count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication as ir

    return ir()


def FakeTensorMode(**kw):  # noqa: N802 — the class it stands for
    from torch._subclasses.fake_tensor import FakeTensorMode as ftm

    return ftm(**kw)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``"fake"`` default process group of ``world_size`` ranks, this
    process rank 0, destroyed on exit (also when the body raises).  Raises
    when a default group exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group exists; the fake world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_shape(shape, mesh, placements) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(shape, offset) of this rank's shard of a ``shape`` tensor laid out
    by ``placements`` on ``mesh``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(tuple(shape), mesh, list(placements))
    return tuple(shape), tuple(offset)


def mesh_group(mesh, names: tuple[str, ...]):
    """The process group of this rank along the mesh dims ``names``: one
    dim's own group, or the flattened group of several (the multi-pod node
    axis ``("pod", "data")``)."""
    if len(names) == 1:
        return mesh.get_group(names[0])
    return mesh[tuple(names)]._flatten().get_group()


def fake_mode_of(t):
    """The fake mode of a fake tensor (the dry run's shards), to enter while
    a core makes tensors of its own; a null context for a real tensor."""
    return getattr(t, "fake_mode", None) or contextlib.nullcontext()


def _gather_dims(x: DTensor, mesh_dims) -> DTensor:
    placements = list(x.placements)
    for m in mesh_dims:
        placements[m] = Replicate()
    return x.redistribute(x.device_mesh, placements) if placements != list(x.placements) else x


def _no_partial(x: DTensor) -> DTensor:
    """x with every pending reduction (``Partial``) carried out."""
    return _gather_dims(x, [m for m, p in enumerate(x.placements) if p.is_partial()])


def split_heads(y: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n·hd) → (..., n, hd).  A DTensor whose last dim is sharded over
    a mesh dim that does not divide n is gathered over that dim first."""
    if is_dtensor(y):
        last, sizes = y.ndim - 1, y.device_mesh.shape
        y = _gather_dims(y, [m for m, p in enumerate(y.placements)
                             if isinstance(p, Shard) and p.dim == last and n % sizes[m]])
    return y.reshape(*y.shape[:-1], n, hd)


def embed(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``w[tokens]``: rows of the (V, D) table; a DTensor table that
    autograd does not record through ``F.embedding``, the same rows."""
    if is_dtensor(w) and not (torch.is_grad_enabled() and w.requires_grad):
        return torch.nn.functional.embedding(tokens, w)
    return w[tokens]


def batch_layout(x: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """x (..., S, D) with its leading dims placed as ``tokens``' (..., S)
    and replicated over every other mesh dim.  A plain x passes through."""
    if not is_dtensor(x):
        return x
    lead = tokens.ndim - 1
    want = [p if isinstance(p, Shard) and p.dim < lead else Replicate()
            for p in (tokens.placements if is_dtensor(tokens) else [Replicate()] * x.device_mesh.ndim)]
    return x.redistribute(x.device_mesh, want) if want != list(x.placements) else x


def residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y, y first redistributed to x's placements when both are DTensors."""
    if is_dtensor(x) and is_dtensor(y) and y.placements != x.placements:
        y = y.redistribute(x.device_mesh, x.placements)
    return x + y


def gather_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, index[..., None])[..., 0]``.  On a DTensor
    whose last dim is sharded, each rank picks the indices in its own
    range (zero elsewhere) and the result is a pending sum over those mesh
    dims; ``index`` must hold the same rows on every rank of them."""
    from torch.distributed.tensor import Partial

    last = x.ndim - 1
    if is_dtensor(x):
        x = _no_partial(x)  # (a head sharded on d_model gives pending sums)
    vdims = _head_mesh_dims(x, last) if is_dtensor(x) else []
    if not vdims:
        return torch.gather(x, -1, index[..., None])[..., 0]
    xl = x.to_local()
    width = xl.shape[-1]
    rel = (index.to_local() if is_dtensor(index) else index).long() - _local_index(x, vdims) * width
    inside = (rel >= 0) & (rel < width)
    picked = torch.gather(xl, -1, rel.clamp(0, width - 1)[..., None])[..., 0]
    picked = torch.where(inside, picked, torch.zeros((), dtype=picked.dtype, device=picked.device))
    placements = [Partial() if m in vdims else p for m, p in enumerate(x.placements)]
    return DTensor.from_local(picked, x.device_mesh, placements, run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous.  A core run
    on local tensors can hand back a permuted gradient (an einsum's
    backward), and DTensor's matmul backward then views it as a matrix,
    which a non-contiguous local tensor refuses."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _into_local(t: DTensor, partial_grad: tuple[int, ...] | list[int] = ()) -> torch.Tensor:
    """t's local tensor.  Its gradient is taken as a pending sum (``Partial``)
    over the mesh dims ``partial_grad``, where t is replicated but each rank
    uses its own part of it (or t with its own rows of another input), and
    as laid out like t elsewhere."""
    from torch.distributed.tensor import Partial

    grad = [Partial() if m in partial_grad else p for m, p in enumerate(t.placements)] if partial_grad else None
    local = t.to_local(grad_placements=grad)
    return _ContiguousGrad.apply(local) if local.requires_grad else local


def _head_mesh_dims(t: DTensor, head_dim: int) -> list[int]:
    return [m for m, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == head_dim]


def _local_index(t: DTensor, mesh_dims: list[int]) -> int:
    """This rank's shard index over ``mesh_dims`` (in mesh order, major first)."""
    mesh, coord, idx = t.device_mesh, t.device_mesh.get_coordinate(), 0
    for m in mesh_dims:
        idx = idx * mesh.shape[m] + coord[m]
    return idx


def on_local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *args, head_dim: int = -2, **kw):
    """``fn(q, k, v, *args, **kw)`` with the head dim at ``head_dim``, on
    each rank's own heads.  Plain tensors pass straight through.  DTensors:
    k and v take q's placements on every mesh dim that does not split q's
    heads; on those that do, they keep their own heads split alike, or are
    replicated, and then each rank reads the K/V heads its q heads use
    (GQA: q head i reads K/V head i // (H / KVH)).  The result has q's
    placements."""
    if not is_dtensor(q):
        return fn(q, k, v, *args, **kw)
    hdim = head_dim % q.ndim
    q = _no_partial(q)
    heads = _head_mesh_dims(q, hdim)

    def like_q(t: DTensor) -> DTensor:
        t = _no_partial(t)
        want = [(t.placements[m] if t.placements[m] == p else Replicate()) if m in heads else p
                for m, p in enumerate(q.placements)]
        return t.redistribute(t.device_mesh, want) if want != list(t.placements) else t

    k, v = like_q(k), like_q(v)
    kv_split = [m for m in heads if k.placements[m] == q.placements[m]]
    # K/V replicated where q's heads are split: each rank reads its q heads'
    # K/V heads, so the K/V gradients are pending sums over those mesh dims
    kl, vl = (_into_local(t, heads if heads and not kv_split else ()) for t in (k, v))
    if heads and not kv_split:
        hl = q.to_local().shape[hdim]
        group = q.shape[hdim] // k.shape[hdim]
        if hl % group and group % hl:
            raise ValueError(f"{hl} local q heads do not align with K/V groups of {group}")
        lo = _local_index(q, heads) * hl // group
        kl, vl = kl.narrow(hdim, lo, max(1, hl // group)), vl.narrow(hdim, lo, max(1, hl // group))
    elif kv_split != heads:
        raise NotImplementedError(f"K/V heads split over mesh dims {kv_split}, q's over {heads}")
    ql = _into_local(q)
    with fake_mode_of(ql):  # a mask the core makes is fake too on fake shards
        out = fn(ql, kl, vl, *args, **kw)
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False)


def on_local_batch(fn, *args, shared: tuple[int, ...] = ()):
    """``fn(*args)`` on local tensors: every DTensor argument laid out as
    the first one's batch split (its Shard(0) mesh dims) and replicated over
    the other mesh dims, except those at the positions ``shared``, which are
    replicated everywhere (weights).  The outputs (a tensor or a tuple)
    come back with that batch layout.  Plain arguments pass straight
    through."""
    first = next((a for a in args if is_dtensor(a)), None)
    if first is None:
        return fn(*args)
    mesh = first.device_mesh
    batch = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in first.placements]
    rep = [Replicate()] * mesh.ndim
    # a shared argument meets each rank's own batch rows: its gradient is a
    # pending sum over the batch's mesh dims
    batch_dims = [m for m, p in enumerate(batch) if isinstance(p, Shard)]

    def local(i, a):
        if not is_dtensor(a):
            return a
        want = rep if i in shared else batch
        a = _no_partial(a)
        return _into_local(a.redistribute(mesh, want) if list(a.placements) != want else a,
                           batch_dims if i in shared else ())

    locals_ = [local(i, a) for i, a in enumerate(args)]
    with fake_mode_of(next(a for a in locals_ if isinstance(a, torch.Tensor))):
        out = fn(*locals_)

    def wrap(t):
        return DTensor.from_local(t, mesh, batch, run_check=False) if isinstance(t, torch.Tensor) else t

    return tuple(wrap(t) for t in out) if isinstance(out, tuple) else wrap(out)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """x gathered over every mesh dim (pending sums reduced); a plain
    tensor passes through."""
    if not is_dtensor(x):
        return x
    rep = [Replicate()] * x.device_mesh.ndim
    return x if list(x.placements) == rep else x.redistribute(x.device_mesh, rep)


def replicated(fn, *args):
    """``fn(*args)`` on full tensors: each DTensor argument gathered over
    every mesh dim; the outputs (tensors, or a NamedTuple / tuple of them)
    come back as replicated DTensors on the first argument's mesh.  Without
    a DTensor argument, ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    full = [a.full_tensor() if is_dtensor(a) else a for a in args]
    with fake_mode_of(next(a for a in full if isinstance(a, torch.Tensor))):
        out = fn(*full)
    rep = [Replicate()] * mesh.ndim

    def wrap(t):
        return DTensor.from_local(t, mesh, rep, run_check=False) if isinstance(t, torch.Tensor) else t

    if isinstance(out, tuple):
        items = [wrap(t) for t in out]
        return type(out)(*items) if hasattr(out, "_fields") else tuple(items)
    return wrap(out)
