"""``repro_torch.obs``: telemetry of the executors (counterpart of ``repro.obs``).

The synchronous, event-driven and elastic executors record their
per-round metrics through :class:`MetricsSpec` / :class:`Recorder` (the
event executor's bins through :class:`BinSpec`), take every wire count from
the :mod:`~repro_torch.obs.wirecost` accountant, and mark their phases with
``torch.profiler`` ranges (``dfl_local``, ``dfl_mix``, ``dfl_eval``);
:mod:`~repro_torch.obs.export` writes JSONL run logs in the JAX package's
schema and :func:`profile_trace` captures a trace.  The sharded executor
prices its halo traffic with :func:`sharded_wire_per_round`.
"""

from .export import (
    SCHEMA_VERSION,
    git_rev,
    history_rows,
    profile_trace,
    read_run_log,
    run_manifest,
    validate_run_log,
    write_run_log,
)
from .health import consensus_distance, gossip_health, mass_drift_trace, staleness_histogram
from .spec import BinChannel, BinSpec, Channel, MetricsSpec, Recorder
from .wirecost import (
    make_wire_fn,
    param_row_bytes,
    sharded_wire_per_round,
    static_wire_messages,
)

__all__ = [
    "SCHEMA_VERSION",
    "BinChannel",
    "BinSpec",
    "Channel",
    "MetricsSpec",
    "Recorder",
    "consensus_distance",
    "git_rev",
    "gossip_health",
    "history_rows",
    "make_wire_fn",
    "mass_drift_trace",
    "param_row_bytes",
    "profile_trace",
    "read_run_log",
    "run_manifest",
    "sharded_wire_per_round",
    "staleness_histogram",
    "static_wire_messages",
    "validate_run_log",
    "write_run_log",
]
