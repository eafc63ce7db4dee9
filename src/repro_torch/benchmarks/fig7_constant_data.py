"""Figure 7: constant TOTAL data spread over more nodes (counterpart of
``benchmarks/fig7_constant_data.py``): per-node computation to reach a given
loss stays roughly constant, the isolated single node included.

Run:  python -m repro_torch.benchmarks.fig7_constant_data [--device cpu]
"""
from __future__ import annotations

from repro_torch.core import topology as T

from .common import driver_main, emit, run_dfl_mlp


def run(quick: bool = True, device=None) -> None:
    total = 2048 if quick else 8192
    rounds = 60 if quick else 200
    base_final = None
    for n in (1, 4, 16):
        per = total // n
        if n == 1:
            # isolated node: no aggregation (the centralised reference)
            hist, spr = run_dfl_mlp(n_nodes=1, per_node=per, rounds=rounds, aggregate=False, gain=1.0,
                                    device=device)
        else:
            hist, spr = run_dfl_mlp(n_nodes=n, graph=T.complete(n), per_node=per, rounds=rounds, device=device)
        if base_final is None:
            base_final = hist["test_loss"][-1]
        emit(f"fig7.n{n}_per{per}", spr * 1e6, f"final={hist['test_loss'][-1]:.3f};isolated_ref={base_final:.3f}")


main = driver_main(run, __doc__)

if __name__ == "__main__":
    main()
