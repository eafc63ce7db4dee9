"""Roofline table from the dry-run records (counterpart of
``benchmarks/roofline_report.py``).

Reads ``build/dryrun/*.json`` (or ``$DRYRUN_RESULTS``), written by
``python -m repro_torch.launch.dryrun``, and emits one row per (arch ×
shape × mesh) with the three roofline terms at the H100's data-sheet
peaks, the dominant one and the useful-FLOPs ratio, then
``roofline.summary``.  It reads records only: ``device`` is accepted for
the harness's sake and nothing runs on it.
"""
from __future__ import annotations

import glob
import json
import os

from .common import emit

RESULTS_DIR = os.environ.get("DRYRUN_RESULTS", os.path.join("build", "dryrun"))

__all__ = ["RESULTS_DIR", "run"]


def run(quick: bool = True, device: str | None = None) -> None:
    del quick, device
    files = sorted(glob.glob(os.path.join(RESULTS_DIR, "*.json")))
    if not files:
        emit("roofline.NOTE", 0.0,
             f"no dry-run records in {RESULTS_DIR}; run python -m repro_torch.launch.dryrun --all")
        return
    n_ok = n_err = 0
    for f in files:
        with open(f) as fh:
            rec = json.load(fh)
        tag = f"roofline.{rec['arch']}.{rec['shape']}.{rec['mesh']}"
        if rec.get("mixing") and rec["mixing"] != "dense":
            tag += f".{rec['mixing']}"
        if rec["status"] != "ok":
            n_err += 1
            emit(tag, 0.0, f"ERROR={rec.get('error', '?')[:80]}")
            continue
        n_ok += 1
        t = rec["terms"]
        emit(
            tag,
            rec.get("wall_s", 0.0) * 1e6,
            f"dominant={t['dominant']};compute_s={t['compute_s']:.3e};"
            f"memory_s={t['memory_s']:.3e};collective_s={t['collective_s']:.3e};"
            f"useful_ratio={rec.get('useful_flops_ratio', 0):.2f}",
        )
    emit("roofline.summary", 0.0, f"ok={n_ok};errors={n_err}")


if __name__ == "__main__":
    run()
