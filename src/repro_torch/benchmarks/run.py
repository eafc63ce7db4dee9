"""Benchmark harness of the port (counterpart of ``benchmarks/run.py``): one
module per paper figure, the kernel micro-benchmarks, the round-loop and
the estimation benchmarks.

Usage:
    python -m repro_torch.benchmarks.run [--full|--quick] [--device cpu] [fig1 fig5 ...]

Prints ``name,us_per_call,derived`` CSV rows (also collected in
``benchmarks.common.ROWS``); the drivers that write JSON write it under
``build/``.  Runs go on ``cuda`` unless ``--device cpu`` is given.  A
module that raises prints ``<name>.FAILED`` and the harness goes on to the
next, then exits 1.  ``fig10`` (sharded scaling) and ``roofline`` (the
dry-run's roofline report) need the multi-GPU launch path, which is not
ported: naming either is an error that cites ROADMAP.md Queue 1 item 17.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from . import (
    estimates_bench,
    fig1_scaling,
    fig2_failures,
    fig3_dynamics,
    fig4_estimates,
    fig5_vsteady,
    fig6_env,
    fig7_constant_data,
    fig8_churn,
    fig9_async,
    fig11_elastic,
    fig12_compress,
    fig13_serve,
    kernels_bench,
    rounds_bench,
)
from .common import emit

MODULES = {
    "fig1": fig1_scaling,
    "fig2": fig2_failures,
    "fig3": fig3_dynamics,
    "fig4": fig4_estimates,
    "fig5": fig5_vsteady,
    "fig6": fig6_env,
    "fig7": fig7_constant_data,
    "fig8": fig8_churn,
    "fig9": fig9_async,
    "fig11": fig11_elastic,
    "fig12": fig12_compress,
    "fig13": fig13_serve,
    "kernels": kernels_bench,
    "rounds": rounds_bench,
    "estimates": estimates_bench,
}
# the JAX harness's modules that need the sharded launch path
NOT_PORTED = {
    "fig10": "benchmarks/fig10_scaling.py (core/shardplan.py, launch/dryrun.py)",
    "roofline": "benchmarks/roofline_report.py (launch/dryrun.py, launch/roofline.py)",
}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--full", action="store_true", help="paper-scale (slow) settings")
    p.add_argument("--quick", action="store_true", help="CI-scale settings (the default)")
    p.add_argument("--only", type=str, default=None, help="comma-separated subset")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("modules", nargs="*", help="module subset (same names as --only)")
    args = p.parse_args(argv)
    if args.full and args.quick:
        p.error("--full and --quick are mutually exclusive")
    quick = args.quick or not args.full
    if args.modules and args.only:
        p.error("give modules positionally or via --only, not both")

    names = args.modules or (list(MODULES) if not args.only else [s.strip() for s in args.only.split(",")])
    refused = [x for x in names if x in NOT_PORTED]
    if refused:
        p.error("; ".join(f"{x}: {NOT_PORTED[x]} is not yet ported; see ROADMAP.md Queue 1 "
                          "item 17 (multi-GPU)" for x in refused))
    unknown = [x for x in names if x not in MODULES]
    if unknown:
        p.error(f"unknown modules {unknown}; available: {list(MODULES)}")
    print("name,us_per_call,derived")
    failures = 0
    for name in names:
        t0 = time.time()
        try:
            MODULES[name].run(quick=quick, device=args.device)
        except Exception as e:  # noqa: BLE001 — keep the harness sweeping
            failures += 1
            emit(f"{name}.FAILED", 0.0, f"{type(e).__name__}: {e}")
            traceback.print_exc(file=sys.stderr)
        print(f"# {name} done in {time.time() - t0:.0f}s", flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
