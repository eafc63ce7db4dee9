"""Meshes (counterpart of ``repro/launch/mesh.py``): the production
``("data", "model")`` / ``("pod", "data", "model")`` mesh of the launch
layer, and the node axis of the node-sharded DecAvg rendering.

The production mesh.  ``make_production_mesh`` renders the JAX package's
pod shapes (256 ranks as (data=16, model=16), two pods as (pod=2, data=16,
model=16)) as a ``torch.distributed.device_mesh.DeviceMesh`` with the JAX
axis names, over whatever default process group exists: the fake group of
the dry run (``launch/dryrun.py``: one process plays rank 0 of 256 or 512),
NCCL ranks (one a card) or gloo ranks on the CPU.  FL nodes map to
``data`` (one model-parallel slice a node), tensor parallelism to
``model``.  The shape logic is one pure function, ``production_shape``,
so ``n_fl_nodes`` and the tests need no world.  Importing this module
never touches process-group state; only ``make_production_mesh`` reads the
default group, when called.

The node axis.  The JAX package runs its sharded round from one controller inside
``shard_map`` over a 1-D ``Mesh`` whose axis is ``NODE_AXIS``.  The port is
SPMD over processes instead: one process a shard, and one
``torch.distributed`` process group stands where the mesh axis stood.  Rank
r owns the contiguous node rows ``[r·nps, (r+1)·nps)``
(``core.shardplan.shard_plan``).  On the card each rank takes
``cuda:{local_rank}`` and the NCCL backend; with ``device="cpu"`` it takes
the CPU and gloo.

There is no fallback: a failed NCCL init, a missing group at more than one
shard, a group of another size or backend, or fewer cards than ranks each
raise.  Nothing switches quietly to gloo or to one process.

Launching S ranks is the caller's: ``torchrun --nproc-per-node S`` (which
sets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and the store, the script
then calling ``init_process_group``), or ``spawn_ranks`` here, which starts
S processes with ``torch.multiprocessing`` over a ``file://`` store (no
port) and gathers what each returns.  At one shard ``node_group`` makes the
world-size-1 group itself, as ``shard_plan`` builds its own mesh from
``n_shards``.
"""
from __future__ import annotations

import math
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

__all__ = [
    "NODE_AXIS",
    "N_CHIPS",
    "backend_for",
    "make_production_mesh",
    "n_fl_nodes",
    "node_axis",
    "node_group",
    "production_shape",
    "rank_device",
    "spawn_ranks",
]

N_CHIPS = {"single": 256, "multi": 512}
NODE_AXIS = "node"
# the stores of the world-size-1 groups ``node_group`` makes: one directory
# a process, removed when the process exits, a fresh file a group
_STORE_DIR: tempfile.TemporaryDirectory | None = None
_N_STORES = 0


def production_shape(*, multi_pod: bool = False, n_devices: int | None = None) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the production mesh, the JAX
    ``make_production_mesh``'s shape logic and errors: the pod shapes
    (16, 16) / (2, 16, 16) by default; with ``n_devices`` the model axis
    shrinks first (data keeps one slice a FL node, at most 16 a pod)."""
    if n_devices is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    else:
        pods = 2 if multi_pod else 1
        per_pod = n_devices // pods
        if per_pod < 1 or n_devices % pods:
            raise ValueError(f"n_devices={n_devices} cannot fill {pods} pod(s)")
        data = min(16, per_pod)
        if per_pod % data:
            raise ValueError(f"n_devices={n_devices}: per-pod {per_pod} not divisible by data={data}")
        shape = (pods, data, per_pod // data) if multi_pod else (data, per_pod // data)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, n_devices: int | None = None):
    """The (pod,) data × model ``DeviceMesh`` over the default process
    group, whose world size must equal the mesh's rank count (256 / 512 by
    default, ``n_devices`` otherwise).  Its device type is the group's:
    ``cuda`` for NCCL, ``cpu`` for gloo and the fake group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = production_shape(multi_pod=multi_pod, n_devices=n_devices)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs the default process group of its {math.prod(shape)} ranks: "
                           "none is initialised")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, the mesh {shape} "
                         f"needs {math.prod(shape)}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def node_axis(*, multi_pod: bool = False) -> tuple[str, ...]:
    """The mesh axis (or axes) the FL node dimension shards over."""
    return ("pod", "data") if multi_pod else ("data",)


def n_fl_nodes(*, multi_pod: bool = False, n_devices: int | None = None) -> int:
    """FL node slots on the production mesh (the size of the node axis)."""
    shape, axes = production_shape(multi_pod=multi_pod, n_devices=n_devices)
    size = dict(zip(axes, shape))
    return math.prod(size[a] for a in node_axis(multi_pod=multi_pod))


def backend_for(device: torch.device) -> str:
    """The collective backend a node axis on ``device`` runs: NCCL on the
    card, gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` on the card (the rank
    itself when no launcher set ``LOCAL_RANK``), the CPU for ``"cpu"``.
    Raises when the host holds fewer cards than the ranks that want one."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local} needs card {local}, but this host has {torch.cuda.device_count()}: "
            "launch at most one rank a card"
        )
    return torch.device("cuda", local)


def node_group(n_shards: int, *, device: str | torch.device | None = None):
    """The process group the node axis of ``n_shards`` shards runs over.

    With a group already initialised (by the launcher), its world must have
    ``n_shards`` ranks and the backend ``device`` needs.  Without one,
    ``n_shards == 1`` makes the world-size-1 group here (NCCL on the card,
    gloo on the CPU, through a ``file://`` store in one temporary directory a
    process, removed when the process exits),
    and ``n_shards > 1`` raises: those ranks are the launcher's to start.
    """
    global _STORE_DIR, _N_STORES
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be at least 1")
    dev = rank_device(device)
    backend = backend_for(dev)
    if not dist.is_initialized():
        if n_shards != 1:
            raise RuntimeError(
                f"{n_shards} shards need the process group their launcher made (torchrun, or "
                "torch.multiprocessing with init_process_group): none is initialised"
            )
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if _STORE_DIR is None:
            _STORE_DIR = tempfile.TemporaryDirectory(prefix="repro_node_group_", ignore_cleanup_errors=True)
        _N_STORES += 1
        store = os.path.join(_STORE_DIR.name, f"store{_N_STORES}")
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=1, rank=0,
                                device_id=dev if dev.type == "cuda" else None)
    have_size, have_backend = dist.get_world_size(), dist.get_backend()
    if have_size != n_shards:
        raise ValueError(f"the process group has {have_size} ranks, the node axis wants {n_shards}")
    if have_backend != backend:
        raise ValueError(f"the process group runs {have_backend}, a node axis on {dev.type} needs {backend}")
    return dist.group.WORLD


def _rank_main(rank: int, n_ranks: int, store: str, device: str, call: str, results) -> None:
    """One rank of ``spawn_ranks``: join the group, run the call, report."""
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)  # S ranks at the default thread count oversubscribe the host's cores
    try:
        with open(call, "rb") as fh:
            fn, args = pickle.load(fh)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
        dist.init_process_group(backend_for(dev), init_method=f"file://{store}", world_size=n_ranks, rank=rank,
                                device_id=dev if dev.type == "cuda" else None)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # noqa: BLE001 — every failure goes back to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, n_ranks: int, *args, device: str = "cpu", timeout: float = 600.0) -> list:
    """``fn(rank, *args)`` on ``n_ranks`` fresh processes that form one
    process group (NCCL, rank r on card r, for ``device="cuda"``; gloo for
    ``"cpu"``) through a ``file://`` store in a temporary directory.
    Returns what each rank returned, in rank order.  ``fn`` and its
    arguments and results must pickle.  Raises with a rank's traceback when
    one fails, and when ``timeout`` seconds pass before all have returned;
    either way every process is stopped before it returns or raises.
    Each rank runs one CPU thread."""
    if device.startswith("cuda") and torch.cuda.device_count() < n_ranks:
        raise RuntimeError(f"{n_ranks} NCCL ranks need {n_ranks} cards, this host has {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_spawn_", ignore_cleanup_errors=True) as tmp:
        store, call = os.path.join(tmp, "store"), os.path.join(tmp, "call.pkl")
        # the call goes through a file: a child reads its process arguments
        # only after importing the parent's main module, so large arguments
        # in the pipe would start the ranks one after another
        with open(call, "wb") as fh:
            pickle.dump((fn, args), fh)
        procs = [ctx.Process(target=_rank_main, args=(r, n_ranks, store, device, call, results),
                             daemon=True) for r in range(n_ranks)]
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n_ranks:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{n_ranks} ranks: {len(got)} returned within {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank died with exit code {dead[0]} before it reported") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n{value}")
                got[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10 if len(got) == n_ranks else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(n_ranks)]
