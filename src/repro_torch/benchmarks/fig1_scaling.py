"""Figure 1: the plateau of the uncorrected init scales with system size
n^μ; the proposed ‖v_steady‖⁻¹ gain removes it (counterpart of
``benchmarks/fig1_scaling.py``).

Paper claim: dashed (He) curves plateau for a number of rounds growing as
n^μ, 0.4 ≤ μ ≤ 1; solid (proposed) curves descend immediately.  Measured:
rounds to (test loss < threshold) for both inits at several n on the
complete graph (cfg A), and the fitted μ.

Run:  python -m repro_torch.benchmarks.fig1_scaling [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import topology as T
from repro_torch.core.initialisation import gain_from_graph

from .common import driver_main, emit, rounds_to_loss, run_dfl_mlp_sweep


def run(quick: bool = True, device=None) -> dict[int, tuple[dict, dict]]:
    """Emits the rows; returns {n: (He history, proposed history)}."""
    ns = [8, 16, 32] if quick else [8, 16, 32, 64]
    rounds = 400 if quick else 1000  # the He plateau at n=32 runs past 300 rounds
    threshold = 2.25  # just below the log(10) = 2.303 plateau
    plateau_rounds, out = [], {}
    for n in ns:
        # both inits over one upload of the data through the sweep
        grid, spr = run_dfl_mlp_sweep(
            n_nodes=n, gains=[1.0, gain_from_graph(T.complete(n))], rounds=rounds, eval_every=4, device=device,
        )
        hist_plain, hist_corr = grid[0][0], grid[1][0]
        out[n] = (hist_plain, hist_corr)
        r_plain = rounds_to_loss(hist_plain, threshold)
        r_corr = rounds_to_loss(hist_corr, threshold)
        plateau_rounds.append(r_plain)
        emit(
            f"fig1.n{n}",
            spr / rounds * 1e6,  # µs per round per trajectory, like fig2-fig7
            f"plateau_he={r_plain};plateau_proposed={r_corr};"
            f"final_he={hist_plain['test_loss'][-1]:.3f};final_proposed={hist_corr['test_loss'][-1]:.3f}",
        )
    finite = [(n, r) for n, r in zip(ns, plateau_rounds) if np.isfinite(r) and r > 0]
    if len(finite) >= 2:
        mu = float(np.polyfit(np.log([n for n, _ in finite]), np.log([r for _, r in finite]), 1)[0])
    else:
        mu = float("nan")
    emit("fig1.scaling_exponent", 0.0, f"mu={mu:.2f};paper_range=0.4..1.0")
    return out


main = driver_main(run, __doc__)

if __name__ == "__main__":
    main()
