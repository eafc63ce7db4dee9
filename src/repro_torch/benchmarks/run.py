"""Benchmark harness of the port (counterpart of ``benchmarks/run.py``): one
module per paper figure, the kernel micro-benchmarks, the round-loop and
the estimation benchmarks.

Usage:
    python -m repro_torch.benchmarks.run [--full|--quick] [--device cpu] [fig1 fig5 ...]

Prints ``name,us_per_call,derived`` CSV rows (also collected in
``benchmarks.common.ROWS``); the drivers that write JSON write it under
``build/``.  Runs go on ``cuda`` unless ``--device cpu`` is given.  A
module that raises prints ``<name>.FAILED`` and the harness goes on to the
next, then exits 1.  ``fig10`` is the sharded rendering's weak scaling
(``fig10_scaling``: S = 1 in this process, larger S spawned as ranks of
their own, all on ``--device``; on the card, the S the host's cards
cover).  ``roofline`` reports the dry run's records (``build/dryrun/``,
written by ``python -m repro_torch.launch.dryrun``); it reads files only.
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
    fig10_scaling,
    fig11_elastic,
    fig12_compress,
    fig13_serve,
    kernels_bench,
    roofline_report,
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
    "fig10": fig10_scaling,
    "fig11": fig11_elastic,
    "fig12": fig12_compress,
    "fig13": fig13_serve,
    "kernels": kernels_bench,
    "rounds": rounds_bench,
    "estimates": estimates_bench,
    "roofline": roofline_report,
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
