"""Figure 5: ‖v_steady‖ against n per network family (a, b) and its
invariance under degree-preserving assortativity rewiring (c) (counterpart
of ``benchmarks/fig5_vsteady.py``; numpy only, no device).

Paper claims: homogeneous families (ER, k-regular) give ‖v‖ = n^-1/2; BA
and heavy-tailed configuration models smaller exponents depending on γ;
rewiring the assortativity leaves ‖v‖ unchanged.

Run:  python -m repro_torch.benchmarks.fig5_vsteady
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import mixing as M
from repro_torch.core import topology as T

from .common import driver_main, emit


def run(quick: bool = True, device=None) -> None:
    del device  # graph algebra on the host
    ns = [128, 512, 2048] if quick else [128, 512, 2048, 8192]
    fams = {
        "kregular8": lambda n: T.random_k_regular(n, 8, seed=0),
        "er_gnm": lambda n: T.erdos_renyi_gnm(n, 4 * n, seed=0),
        "ba_m4": lambda n: T.barabasi_albert(n, 4, seed=0),
        "conf_g2.2": lambda n: T.configuration_heavy_tail(n, 2.2, seed=0),
        "conf_g3.0": lambda n: T.configuration_heavy_tail(n, 3.0, seed=0),
    }
    for fam, build in fams.items():
        t0 = time.time()
        vs = [M.v_steady_norm(build(n)) for n in ns]
        alpha = -float(np.polyfit(np.log(ns), np.log(vs), 1)[0])
        emit(f"fig5.{fam}", (time.time() - t0) * 1e6 / len(ns), f"alpha={alpha:.3f};vnorm_n{ns[-1]}={vs[-1]:.4f}")

    # (c) assortativity invariance
    n_c = 512 if quick else 2048
    g = T.erdos_renyi_gnp(n_c, 8 / n_c, seed=5)
    before = M.v_steady_norm(g)
    t0 = time.time()
    drift = 0.0
    for rho in (-0.3, 0.0, 0.3):
        g2 = M.rewire_to_assortativity(g, rho, steps=40000, seed=1)
        drift = max(drift, abs(M.v_steady_norm(g2) - before))
    emit("fig5.assortativity_invariance", (time.time() - t0) * 1e6 / 3, f"max_vnorm_drift={drift:.2e}")


main = driver_main(run, __doc__)

if __name__ == "__main__":
    main()
