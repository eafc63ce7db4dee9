"""Figure 4: robustness of the proposed init to imperfect knowledge
(counterpart of ``benchmarks/fig4_estimates.py``).

* **gossip-budget sweep (primary)**: every node runs the gossip engine
  (``repro_torch.gossip``) for B power-iteration + B push-sum rounds over a
  random 4-regular graph, and its own noisy ``‖v̂_steady‖⁻¹`` feeds the
  estimate → init → train warmup.  Small budgets give per-node, wrong
  gains; training still beats the unscaled He baseline by a wide margin.
  The budgets run one after another over one upload
  (``run_dfl_mlp_uncoordinated_sweep``).
* **hand-made reference (``fig4.ref.*``)**: controlled n × factor and
  exponent distortions of one global gain, the curve the sweep is read
  against; with the exact-gain and He anchors.

Rows are printed through ``emit``; nothing is written to a file.

Run:  python -m repro_torch.benchmarks.fig4_estimates [--device cpu]
"""
from __future__ import annotations

from repro_torch.core import topology as T
from repro_torch.core.initialisation import gain_from_estimates

from .common import driver_main, emit, run_dfl_mlp, run_dfl_mlp_uncoordinated_sweep


def run(quick: bool = True, device=None) -> None:
    n = 16
    rounds = 60 if quick else 150
    # a sparse graph: gossip needs several rounds to converge there, so small
    # budgets give honest per-node noise (on the complete graph one round is exact)
    g = T.random_k_regular(n, 4, seed=0)

    hist_exact, spr = run_dfl_mlp(n_nodes=n, graph=g, rounds=rounds, device=device)
    emit("fig4.exact_gain", spr * 1e6, f"final={hist_exact['test_loss'][-1]:.3f}")
    hist_he, spr = run_dfl_mlp(n_nodes=n, graph=g, gain=1.0, rounds=rounds, device=device)
    emit("fig4.he_baseline", spr * 1e6, f"final={hist_he['test_loss'][-1]:.3f}")

    # budgets start at the graph's diameter: below it some nodes have not
    # heard from the leader and have no size estimate at all
    budgets = (4, 8, 16) if quick else (4, 8, 16, 32, 64)
    grid, spr = run_dfl_mlp_uncoordinated_sweep(n_nodes=n, graph=g, budgets=budgets, rounds=rounds, device=device)
    for budget, row in zip(budgets, grid):
        hist, gains = row[0]
        emit(
            f"fig4.gossip_budget{budget}",
            spr / rounds * 1e6,  # per-round µs, the unit of every other row
            f"gain_mean={gains.mean():.2f};gain_spread={gains.max() - gains.min():.3f};"
            f"final={hist['test_loss'][-1]:.3f}",
        )

    base = None
    for factor in (0.25, 0.5, 1.0, 2.0, 4.0):
        gain = gain_from_estimates(n * factor)
        hist, spr = run_dfl_mlp(n_nodes=n, graph=g, gain=gain, rounds=rounds, device=device)
        if factor == 1.0:
            base = hist["test_loss"][-1]
        emit(f"fig4.ref.n_estimate_x{factor:g}", spr * 1e6, f"gain={gain:.2f};final={hist['test_loss'][-1]:.3f}")
    # exponent mis-estimation (α = 0.25 vs the true 0.5 of k-regular graphs)
    for alpha in (0.25, 0.5, 0.75):
        gain = gain_from_estimates(n, family_exponent=alpha)
        hist, spr = run_dfl_mlp(n_nodes=n, graph=g, gain=gain, rounds=rounds, device=device)
        emit(
            f"fig4.ref.alpha{alpha:g}",
            spr * 1e6,
            f"gain={gain:.2f};final={hist['test_loss'][-1]:.3f};proposed_exact={base:.3f}",
        )


main = driver_main(run, __doc__)

if __name__ == "__main__":
    main()
