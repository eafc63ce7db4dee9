"""Figure 2: robustness to link / node failures, activation probability p
(counterpart of ``benchmarks/fig2_failures.py``).

Paper claim: with the proposed init the system keeps a much better learning
trajectory than He init even at low p; inactive nodes still train locally.

Run:  python -m repro_torch.benchmarks.fig2_failures [--device cpu]
"""
from __future__ import annotations

from .common import driver_main, emit, run_dfl_mlp


def run(quick: bool = True, device=None) -> None:
    n = 16
    rounds = 60 if quick else 150
    for mode in ("link", "node"):
        for p in (0.2, 0.5, 1.0):
            kw = {"link_p": p} if mode == "link" else {"node_p": p}
            hist_prop, spr = run_dfl_mlp(n_nodes=n, rounds=rounds, device=device, **kw)
            hist_he, _ = run_dfl_mlp(n_nodes=n, gain=1.0, rounds=rounds, device=device, **kw)
            emit(
                f"fig2.{mode}_p{p:g}",
                spr * 1e6,
                f"final_proposed={hist_prop['test_loss'][-1]:.3f};final_he={hist_he['test_loss'][-1]:.3f}",
            )


main = driver_main(run, __doc__)

if __name__ == "__main__":
    main()
