"""Uncoordinated, network-aware initialisation (counterpart of ``repro/core/initialisation.py``).

Each node draws its parameters independently with a standard initialiser and
rescales every random draw by ``gain = ‖v_steady‖⁻¹`` (paper §4, Algorithm 1).
The gain functions are numpy and agree with the JAX package exactly; the
draws come from an explicit ``torch.Generator`` and agree with the JAX
package's in distribution only (the two frameworks' bit streams differ).

``InitConfig.gain`` may be a float or an ``(n,)`` tensor of per-node gains:
with a tensor every initialiser returns a node-stacked ``(n, *shape)`` draw
whose row i is scaled by ``gain[i]`` (the initialisers are linear in the
gain), so a whole ensemble is drawn in one call on the generator's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

from .mixing import v_steady_norm, v_steady_norm_from_degree_sample
from .topology import Graph

__all__ = [
    "InitConfig",
    "gain_from_graph",
    "gain_from_estimates",
    "he_normal",
    "he_uniform",
    "glorot_normal",
    "glorot_uniform",
    "trunc_normal",
    "scaled_init",
]

Distribution = Literal["he_normal", "he_uniform", "glorot_normal", "glorot_uniform", "trunc_normal"]
Gain = float | torch.Tensor


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """How to initialise parameters: the distribution and the paper's gain
    (1.0 reproduces the uncorrected He baseline of Fig. 1)."""

    distribution: Distribution = "he_normal"
    gain: Gain = 1.0

    def replace(self, **kw) -> "InitConfig":
        return dataclasses.replace(self, **kw)


def gain_from_graph(graph: Graph) -> float:
    """Perfect-knowledge gain ``‖v_steady‖⁻¹`` from the full topology (§4.3)."""
    return 1.0 / v_steady_norm(graph)


def gain_from_estimates(
    n_estimate: float | np.ndarray,
    degree_sample: np.ndarray | None = None,
    family_exponent: float | None = None,
) -> float | np.ndarray:
    """Imperfect-knowledge gain (§4.4): from a polled degree sample, else from
    a family exponent α (``gain = n̂^α``), else α = 1/2.  Vectorised over
    per-node estimates; scalar inputs return a float."""
    if degree_sample is not None and family_exponent is not None:
        raise ValueError(
            "gain_from_estimates: give either degree_sample or family_exponent, not both"
        )
    n_est = np.asarray(n_estimate, dtype=np.float64)
    if degree_sample is not None:
        out = 1.0 / v_steady_norm_from_degree_sample(degree_sample, np.round(n_est))
    else:
        alpha = 0.5 if family_exponent is None else family_exponent
        out = n_est**alpha
    out = np.asarray(out)
    return float(out) if out.ndim == 0 else out


def _fans(shape: tuple[int, ...]) -> tuple[float, float]:
    """fan_in/fan_out for dense (in, out), conv (kh, kw, cin, cout) and stacked shapes."""
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    receptive = math.prod(shape[:-2])
    return float(shape[-2] * receptive), float(shape[-1] * receptive)


def _scaled(scale: float, gain: Gain, draw, shape, dtype) -> torch.Tensor:
    """``scale · gain · draw``; a per-node gain tensor prepends the node axis."""
    if isinstance(gain, torch.Tensor) and gain.ndim == 1:
        x = draw((gain.shape[0], *shape))
        g = gain.to(device=x.device, dtype=torch.float32).reshape(-1, *([1] * len(shape)))
        return (x * (scale * g)).to(dtype)
    return (draw(tuple(shape)) * (scale * float(gain))).to(dtype)


def _normal(generator: torch.Generator):
    return lambda s: torch.randn(s, generator=generator, device=generator.device)


def _uniform_pm1(generator: torch.Generator):
    return lambda s: torch.rand(s, generator=generator, device=generator.device) * 2.0 - 1.0


def he_normal(generator: torch.Generator, shape, dtype=torch.float32, gain: Gain = 1.0) -> torch.Tensor:
    """He et al. fan-in normal init × the paper's gain correction."""
    fan_in, _ = _fans(tuple(shape))
    return _scaled(math.sqrt(2.0 / fan_in), gain, _normal(generator), shape, dtype)


def he_uniform(generator: torch.Generator, shape, dtype=torch.float32, gain: Gain = 1.0) -> torch.Tensor:
    fan_in, _ = _fans(tuple(shape))
    return _scaled(math.sqrt(6.0 / fan_in), gain, _uniform_pm1(generator), shape, dtype)


def glorot_normal(generator: torch.Generator, shape, dtype=torch.float32, gain: Gain = 1.0) -> torch.Tensor:
    fan_in, fan_out = _fans(tuple(shape))
    return _scaled(math.sqrt(2.0 / (fan_in + fan_out)), gain, _normal(generator), shape, dtype)


def glorot_uniform(generator: torch.Generator, shape, dtype=torch.float32, gain: Gain = 1.0) -> torch.Tensor:
    fan_in, fan_out = _fans(tuple(shape))
    return _scaled(math.sqrt(6.0 / (fan_in + fan_out)), gain, _uniform_pm1(generator), shape, dtype)


def trunc_normal(
    generator: torch.Generator, shape, dtype=torch.float32, gain: Gain = 1.0, std: float | None = None
) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal truncated at ±2
    *standard* units, then scaled (as ``jax.random.truncated_normal(-2, 2)``)."""
    fan_in, _ = _fans(tuple(shape))
    s = std if std is not None else math.sqrt(1.0 / fan_in)

    def draw(sh):
        t = torch.empty(sh, device=generator.device)
        return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)

    return _scaled(s, gain, draw, shape, dtype)


_DISTS = {
    "he_normal": he_normal,
    "he_uniform": he_uniform,
    "glorot_normal": glorot_normal,
    "glorot_uniform": glorot_uniform,
    "trunc_normal": trunc_normal,
}


def scaled_init(cfg: InitConfig, generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Draw one weight tensor per ``cfg`` (Algorithm 1, lines 3–6)."""
    return _DISTS[cfg.distribution](generator, shape, dtype, gain=cfg.gain)
