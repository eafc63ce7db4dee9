"""Host-side run-log export: JSONL records and the run manifest (counterpart of ``repro/obs/export.py``).

A run log is newline-delimited JSON: the first record is the **manifest**
(``kind: "manifest"``: config, seed, git revision, backend, schema
version), then one record per recorded round or bin (:func:`history_rows`)
and the summary records the driver appends (final metrics, gossip health).
Everything is strict JSON: NaN / Inf become null, numpy and torch scalars
Python numbers.  The schema is the JAX package's, so its
``validate_run_log`` (``tools/check_bench.py --run-log``) accepts the
port's logs.  The port cannot import jax: its manifest writes
``"jax_version": null`` and names its own stack beside it
(``torch_version``, ``cuda``, ``device_name``, ``n_devices``).

:func:`profile_trace` is the opt-in ``torch.profiler`` capture behind
``launch/train.py --profile-trace DIR``.  The executors mark their phases
with :func:`scope` ranges named as the JAX ``named_scope``s: ``dfl_local``
(the local steps), ``dfl_mix`` (the aggregation) and ``dfl_eval`` (the
recorded round's eval); they show up in the trace, and cost nothing while
no profiler records.
"""
from __future__ import annotations

import contextlib
import json
import math
import platform
import subprocess
from pathlib import Path
from typing import Any, Iterable, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = [
    "SCHEMA_VERSION",
    "git_rev",
    "history_rows",
    "profile_trace",
    "read_run_log",
    "run_manifest",
    "scope",
    "validate_run_log",
    "write_run_log",
]

SCHEMA_VERSION = 1

# keys every manifest must carry: the JAX package's list, which the
# check_bench --run-log gate enforces
MANIFEST_KEYS = ("kind", "schema", "config", "seed", "git_rev", "backend", "jax_version")

TRACE_FILE = "trace.json"


def _sanitize(obj: Any) -> Any:
    """Strict-JSON form: NaN / Inf → None, numpy and torch scalars → Python."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return _sanitize(obj.tolist())
    if hasattr(obj, "item") and not hasattr(obj, "__len__"):
        return _sanitize(obj.item())
    if hasattr(obj, "tolist"):
        return _sanitize(obj.tolist())
    return str(obj)


def git_rev(cwd: str | Path | None = None) -> str:
    """Short git revision of the working tree, or "unknown" outside a repository."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=str(cwd) if cwd else None,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip() if out.returncode == 0 and out.stdout.strip() else "unknown"


def run_manifest(config: dict, *, seed: int, argv: list[str] | None = None,
                 device: str | torch.device | None = None) -> dict:
    """The run log's head record: everything needed to rerun or diff it.
    ``backend`` is the type of ``device`` (default: cuda when a card is
    present); ``jax_version`` is null, the port's stack stands beside it."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    return _sanitize({
        "kind": "manifest",
        "schema": SCHEMA_VERSION,
        "config": config,
        "seed": int(seed),
        "argv": list(argv) if argv is not None else None,
        "git_rev": git_rev(),
        "backend": dev.type,
        "jax_version": None,
        "torch_version": torch.__version__,
        "cuda": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(dev) if on_card else (platform.processor() or platform.machine()),
        "n_devices": torch.cuda.device_count() if on_card else 1,
    })


def history_rows(hist: dict, kind: str = "round") -> list[dict]:
    """History dict → one record per recorded index.

    The index channel is ``round`` (synchronous executors) or ``bin``
    (event-driven); only keys whose list length matches the index ride
    along: scalars and other extras are the driver's to append as summary
    records."""
    index_key = "bin" if "bin" in hist and hist.get("bin") else "round"
    index = hist.get(index_key) or []
    n = len(index)
    if n == 0:
        return []
    keys = [k for k, v in hist.items() if isinstance(v, (list, tuple)) and len(v) == n]
    return [_sanitize({"kind": kind, **{k: hist[k][i] for k in keys}}) for i in range(n)]


def write_run_log(path: str | Path, records: Iterable[dict]) -> int:
    """Write records as JSONL (strict JSON, one object a line); returns the
    record count.  Callers compose ``[manifest, *rows, *summaries]``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with path.open("w") as fh:
        for rec in records:
            fh.write(json.dumps(_sanitize(rec), allow_nan=False) + "\n")
            n += 1
    return n


def read_run_log(path: str | Path) -> list[dict]:
    """Parse a JSONL run log back into its records."""
    with Path(path).open() as fh:
        return [json.loads(line) for line in fh if line.strip()]


def validate_run_log(records: list[dict] | str | Path) -> list[str]:
    """Schema-gate a run log; returns human-readable problems (empty = ok).

    Checks: non-empty, manifest first with :data:`MANIFEST_KEYS` and the
    schema version, every record a dict with a ``kind``, and at least one
    data (non-manifest) record: the JAX package's gate, line for line."""
    if isinstance(records, (str, Path)):
        try:
            records = read_run_log(records)
        except (OSError, json.JSONDecodeError) as exc:
            return [f"unreadable run log: {exc}"]
    problems: list[str] = []
    if not records:
        return ["empty run log"]
    head = records[0]
    if not isinstance(head, dict) or head.get("kind") != "manifest":
        problems.append("first record is not a manifest")
    else:
        missing = [k for k in MANIFEST_KEYS if k not in head]
        if missing:
            problems.append(f"manifest missing keys: {missing}")
        if head.get("schema") != SCHEMA_VERSION:
            problems.append(f"manifest schema {head.get('schema')!r} != {SCHEMA_VERSION}")
    for i, rec in enumerate(records[1:], start=2):
        if not isinstance(rec, dict) or "kind" not in rec:
            problems.append(f"record {i} has no 'kind'")
            break
    if sum(1 for r in records if isinstance(r, dict) and r.get("kind") != "manifest") == 0:
        problems.append("no data records after the manifest")
    return problems


def scope(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records, else a no-op (a range costs ~9 µs of host time on a
    CPU even with no profiler)."""
    if getattr(_autograd_profiler, "_is_profiler_enabled", True):
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def profile_trace(trace_dir: str | Path | None) -> Iterator[Any]:
    """Capture a ``torch.profiler`` trace of the block into
    ``trace_dir/trace.json`` (Chrome trace format); a falsy ``trace_dir`` is
    a no-op.  CPU activity always, CUDA activity when a card is present; the
    executors' ``dfl_local`` / ``dfl_mix`` / ``dfl_eval`` ranges annotate
    it."""
    if not trace_dir:
        yield
        return
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))
