"""Pytree checkpoints through ``torch.save`` (counterpart of ``repro/checkpoint/io.py``).

One ``.ckpt`` file is a ``torch.save`` of ``{structure, leaves, meta}``:
the leaves as CPU tensors in their own dtype (bf16 stays
``torch.bfloat16``), numpy leaves stored through ``torch.from_numpy`` and
given back as numpy, so that ``torch.load(weights_only=True)`` reads the
file without unpickling any code.  The contract is the JAX package's:
*durable* atomic writes (write tmp → fsync → ``os.replace`` → fsync of the
directory), a step-numbered directory (``step_{step:08d}.ckpt``) with an
atomically replaced JSON ``LATEST`` pointer, and ``keep_last=`` garbage
collection that never removes the file LATEST names.  The files are not
the JAX package's msgpack files: neither package reads the other's.

The rebuild contract is the JSON-able ``structure`` skeleton: dicts in
**sorted key order**, lists and tuples by index, NamedTuples by field, so a
template-less ``load_pytree`` reassembles the leaves for any key insertion
order.  NamedTuples come back as plain dicts unless a ``template`` supplies
the exact structure.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

PyTree = Any

__all__ = ["save_pytree", "load_pytree", "save_train_state", "restore_train_state"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: PyTree) -> list:
    """The leaves in the JAX package's order: dict items by sorted key,
    NamedTuples by field, lists and tuples by index."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _unflatten(template: PyTree, leaves: list) -> PyTree:
    """``leaves`` (consumed from the front) in ``template``'s structure."""
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return leaves.pop(0)


def _structure_of(tree: PyTree):
    """JSON-able skeleton (dicts / lists / markers) to rebuild the tree
    from; dict items in sorted key order, as ``_flatten`` yields them.  A
    leaf records whether it was a torch tensor or is to come back as numpy."""
    if isinstance(tree, dict):
        return {"__kind__": "dict", "items": {k: _structure_of(tree[k]) for k in sorted(tree)}}
    if _is_namedtuple(tree):  # checked before tuple
        return {
            "__kind__": "namedtuple",
            "name": type(tree).__name__,
            "items": {k: _structure_of(getattr(tree, k)) for k in tree._fields},
        }
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {"__kind__": kind, "items": [_structure_of(v) for v in tree]}
    return {"__kind__": "leaf", "numpy": not isinstance(tree, torch.Tensor)}


def _pack_leaf(x) -> torch.Tensor:
    """A CPU tensor holding exactly the leaf's elements (a view of a larger
    storage is copied, so the file holds no more than the leaf)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
    else:
        t = torch.from_numpy(np.array(x, order="C"))  # a writable copy, 0-d kept
    if t.untyped_storage().nbytes() != t.numel() * t.element_size() or not t.is_contiguous():
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _rebuild(structure, leaves: list) -> PyTree:
    kind = structure["__kind__"]
    if kind == "leaf":
        return leaves.pop(0)
    if kind in ("dict", "namedtuple"):
        # a NamedTuple comes back as a plain dict: restore through a template to re-wrap it
        return {k: _rebuild(v, leaves) for k, v in structure["items"].items()}
    if kind == "list":
        return [_rebuild(v, leaves) for v in structure["items"]]
    if kind == "tuple":
        return tuple(_rebuild(v, leaves) for v in structure["items"])
    raise ValueError(f"unknown structure kind {kind}")


def _leaf_kinds(structure) -> list[bool]:
    """Each leaf's ``numpy`` marker, in leaf order."""
    if structure["__kind__"] == "leaf":
        return [structure["numpy"]]
    items = structure["items"]
    return [k for v in (items.values() if isinstance(items, dict) else items) for k in _leaf_kinds(v)]


def _fsync_dir(path: str) -> None:
    """Flush a directory entry (the rename) to disk; best effort: some
    filesystems refuse an fsync on a directory opened read-only."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _replace_durable(tmp: str, path: str) -> None:
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def save_pytree(path: str, tree: PyTree, meta: dict | None = None) -> None:
    """Durably write ``tree`` (tensors, numpy arrays or scalars in dicts,
    lists, tuples and NamedTuples) and the JSON-able ``meta`` to ``path``.
    A failed write raises; the file at ``path`` is then the old one."""
    payload = {
        "structure": _structure_of(tree),
        "leaves": [_pack_leaf(x) for x in _flatten(tree)],
        "meta": meta or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    _replace_durable(tmp, path)


def load_pytree(path: str, template: PyTree | None = None) -> tuple[PyTree, dict]:
    """Load a checkpoint: ``(tree, meta)``, its leaves CPU tensors or numpy
    arrays as they were saved.  With ``template`` the leaves go into the
    template's exact structure (NamedTuples included); without it, into the
    stored dict / list skeleton."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    leaves = [t.numpy() if as_np else t for t, as_np in zip(payload["leaves"], _leaf_kinds(payload["structure"]))]
    if template is not None:
        want = len(_flatten(template))
        if want != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, template wants {want}")
        return _unflatten(template, leaves), payload["meta"]
    return _rebuild(payload["structure"], leaves), payload["meta"]


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.ckpt")


def save_train_state(
    ckpt_dir: str,
    step: int,
    state: PyTree,
    meta: dict | None = None,
    keep_last: int | None = None,
) -> str:
    """Durably save ``state`` as ``step_{step:08d}.ckpt`` and repoint LATEST.

    LATEST is written tmp + fsync + atomic replace, so a crash at any
    instant leaves the old pointer or the new one, never a torn one, and the
    file it names is already on disk.  ``keep_last`` (when given) removes
    older ``step_*.ckpt`` files, keeping the newest ``keep_last``; the file
    LATEST names is always kept.  Returns the file's path.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _step_path(ckpt_dir, step)
    save_pytree(path, state, meta={"step": step, **(meta or {})})
    tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(tmp, "w") as f:
        json.dump({"step": step, "path": path}, f)
        f.flush()
        os.fsync(f.fileno())
    _replace_durable(tmp, os.path.join(ckpt_dir, "LATEST"))
    if keep_last is not None and keep_last >= 1:
        kept = sorted(p for p in os.listdir(ckpt_dir) if p.startswith("step_") and p.endswith(".ckpt"))
        for name in kept[:-keep_last]:
            victim = os.path.join(ckpt_dir, name)
            if os.path.abspath(victim) == os.path.abspath(path):
                continue
            try:
                os.remove(victim)
            except OSError:
                pass
    return path


def restore_train_state(ckpt_dir: str, template: PyTree | None = None) -> tuple[PyTree, dict] | None:
    """``(state, meta)`` of the step LATEST names in ``ckpt_dir``, or None
    when the directory holds no LATEST (a file's path has none either).
    The step file is looked up by its name inside ``ckpt_dir``, so a
    directory that was moved as a whole still restores."""
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        info = json.load(f)
    return load_pytree(os.path.join(ckpt_dir, os.path.basename(info["path"])), template=template)
