"""Simplified numerical model of early-stage DFL dynamics, paper §4.2–4.3
(counterpart of ``repro/core/diffusion.py``).

Each of n nodes holds a d-vector drawn from N(0, σ_init²).  Per iteration:
aggregate with the DecAvg receive operator, then add N(0, σ_noise²) noise
(standing in for the local-training update).  The observables are

    σ_an — mean over parameters of the std *across nodes*,
    σ_ap — mean over nodes of the std *across parameters*,

with the §4.3 predictions σ_ap → σ_init · ‖v_steady‖ (up to the
accumulated-noise floor) and σ_an → O(σ_noise) after about the mixing time.

The product is ``decavg.mix_array``, the plain fp32 product (the JAX
package computes it outside any Pallas kernel too).  The draws come from an
explicit CPU ``torch.Generator`` and are moved to the device, so a seed
gives the same w0 and noise on every device (the card's trajectory is the
CPU's up to summation order); ``diffusion_step`` takes each round's noise
as an argument, so a caller can inject the draws.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from repro_torch.device import resolve_device

from .decavg import mix_array
from .mixing import receive_matrix, v_steady_norm
from .topology import Graph

__all__ = ["DiffusionResult", "diffusion_step", "run_diffusion", "sigma_ap_prediction", "simulate"]


@dataclasses.dataclass(frozen=True)
class DiffusionResult:
    sigma_an: np.ndarray  # (rounds+1,)
    sigma_ap: np.ndarray  # (rounds+1,)
    sigma_ap_prediction: float
    v_steady_norm: float


def _sigmas(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w (n, d) node-major → (σ_an, σ_ap), population stds as ``jnp.std``."""
    return w.std(dim=0, correction=0).mean(), w.std(dim=1, correction=0).mean()


def diffusion_step(m: torch.Tensor, w: torch.Tensor, noise: torch.Tensor, sigma_noise: float) -> torch.Tensor:
    """One iteration: mix with M, then add ``sigma_noise · noise``."""
    return mix_array(m, w) + sigma_noise * noise


def simulate(
    m: torch.Tensor, w0: torch.Tensor, noises: Iterable[torch.Tensor], sigma_noise: float
) -> tuple[np.ndarray, np.ndarray]:
    """(σ_an, σ_ap) at w0 and after each step, one step per noise draw;
    read back from the device once, at the end."""
    w = w0
    an0, ap0 = _sigmas(w)
    an, ap = [an0], [ap0]
    for noise in noises:
        w = diffusion_step(m, w, noise, sigma_noise)
        s_an, s_ap = _sigmas(w)
        an.append(s_an)
        ap.append(s_ap)
    return torch.stack(an).cpu().numpy(), torch.stack(ap).cpu().numpy()


def run_diffusion(
    graph: Graph,
    d: int = 1024,
    sigma_init: float = 1.0,
    sigma_noise: float = 1e-3,
    rounds: int = 200,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> DiffusionResult:
    """Run the §4.2 numerical model on ``device`` (default cuda) and return
    the σ trajectories; w0 and the noise come from one CPU generator seeded
    with ``seed``, whatever the device."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    w0 = (sigma_init * torch.randn(graph.n, d, generator=g)).to(dev)
    m = torch.as_tensor(receive_matrix(graph), dtype=torch.float32, device=dev)
    noises = (torch.randn(graph.n, d, generator=g).to(dev) for _ in range(rounds))
    an, ap = simulate(m, w0, noises, sigma_noise)
    vnorm = v_steady_norm(graph)
    return DiffusionResult(
        sigma_an=an, sigma_ap=ap, sigma_ap_prediction=sigma_init * vnorm, v_steady_norm=vnorm
    )


def sigma_ap_prediction(graph: Graph, sigma_init: float) -> float:
    """§4.3 closed form: lim σ_ap ≈ σ_init‖v_steady‖ (noise floor excluded)."""
    return sigma_init * v_steady_norm(graph)
