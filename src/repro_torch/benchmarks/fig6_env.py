"""Figure 6: environmental parameters under the proposed init (counterpart
of ``benchmarks/fig6_env.py``): (a) network density k, (b) training samples
per node, (c) system size with proportional data, (d) communication
frequency (local minibatches b).

Paper claims: trajectories agree across densities well above the
connectivity threshold; more data per node approaches the centralised
limit; larger systems use proportional data; more frequent communication
converges faster to a lower loss.

Run:  python -m repro_torch.benchmarks.fig6_env [--device cpu]
"""
from __future__ import annotations

from repro_torch.core import topology as T

from .common import driver_main, emit, run_dfl_mlp


def run(quick: bool = True, device=None) -> None:
    n = 16
    rounds = 50 if quick else 150

    # (a) density
    for k in (2, 4, 8):
        g = T.random_k_regular(n, k, seed=0)
        hist, spr = run_dfl_mlp(n_nodes=n, graph=g, rounds=rounds, device=device)
        emit(f"fig6a.k{k}", spr * 1e6, f"final={hist['test_loss'][-1]:.3f}")

    # (b) samples per node
    for per in (32, 128, 512) if not quick else (32, 128):
        hist, spr = run_dfl_mlp(n_nodes=n, per_node=per, rounds=rounds, device=device)
        emit(f"fig6b.samples{per}", spr * 1e6, f"final={hist['test_loss'][-1]:.3f}")

    # (c) system size with proportional total data
    for nn in (8, 16, 32):
        g = T.random_k_regular(nn, 8, seed=0) if nn > 8 else T.complete(8)
        hist, spr = run_dfl_mlp(n_nodes=nn, graph=g, per_node=128, rounds=rounds, device=device)
        emit(f"fig6c.n{nn}", spr * 1e6, f"final={hist['test_loss'][-1]:.3f}")

    # (d) communication frequency: b minibatches between aggregations,
    # wall-clock equivalent = rounds × b held constant
    for b in (1, 2, 4):
        r = max(10, rounds * 2 // b) if quick else rounds * 4 // b
        hist, spr = run_dfl_mlp(n_nodes=n, b_local=b, rounds=r, device=device)
        emit(f"fig6d.freq_b{b}", spr * 1e6, f"final={hist['test_loss'][-1]:.3f}")


main = driver_main(run, __doc__)

if __name__ == "__main__":
    main()
