"""Typed metric channels of the executors (counterpart of ``repro/obs/spec.py``).

A :class:`MetricsSpec` names the per-round channels one executor records;
the :class:`Recorder` builds each round's values in spec order and
assembles the host history from the per-round columns at the end (one
device→host transfer a channel).  ``gated`` channels follow the eval
cadence: the JAX package computes them under one ``lax.cond`` on the
round's eval flag with a NaN skip branch; here the branch is a Python
``if`` on the flag, and the skipped rounds hold NaN.

:class:`BinSpec` is the event-driven sibling: named fixed-width
accumulators (per-wall-time-bin sums and counts, set-style slots).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = ["BinChannel", "BinSpec", "Channel", "MetricsSpec", "Recorder"]

# every history dict carries these keys (empty when unrecorded): the
# train_loop contract the executors share
BASE_KEYS = ("round", "train_loss", "test_loss", "sigma_ap", "sigma_an")


@dataclasses.dataclass(frozen=True)
class Channel:
    """One named per-round scalar channel.

    ``gated`` channels follow the eval cadence (NaN on the other rounds);
    ungated channels record every round.  A value is a device scalar or a
    host number; ``ints`` renders the channel as Python ints in the history.
    """

    name: str
    gated: bool = False
    ints: bool = False


@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    """Ordered channel registry of one executor's per-round values."""

    channels: tuple[Channel, ...]

    def __post_init__(self):
        names = [c.name for c in self.channels]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate channel names: {names}")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.channels)

    @property
    def gated(self) -> tuple[Channel, ...]:
        return tuple(c for c in self.channels if c.gated)

    @classmethod
    def legacy(cls, has_eval: bool, track_sigmas: bool, *, wire: bool = False) -> "MetricsSpec":
        """The executors' channel set in the JAX package's order: train loss,
        then the gated test loss and σ pair, then the delivered-message count."""
        ch = [Channel("train_loss")]
        if has_eval:
            ch.append(Channel("test_loss", gated=True))
        if track_sigmas:
            ch += [Channel("sigma_ap", gated=True), Channel("sigma_an", gated=True)]
        if wire:
            ch.append(Channel("wire_messages", ints=True))
        return cls(tuple(ch))


def host_values(values: Sequence[Any]) -> list[float]:
    """Device scalars and host numbers → Python floats, the device ones
    read back in one transfer."""
    out = list(values)
    at = [i for i, v in enumerate(out) if isinstance(v, torch.Tensor)]
    if at:
        got = torch.stack([out[i].detach().reshape(()).to(torch.float64) for i in at]).cpu().tolist()
        for i, g in zip(at, got):
            out[i] = g
    return [float(v) for v in out]


class Recorder:
    """Spec-ordered channel recording in a round loop.

    ``step`` builds one round's values; ``assemble`` turns the per-round
    columns into the history dict at the recorded rounds."""

    def __init__(self, spec: MetricsSpec):
        self.spec = spec

    def step(self, values: dict, gate: bool = False, gated_fn: Callable[[Any], dict] | None = None,
             operand=None) -> tuple:
        """One round's values in spec order.  ``values`` holds the ungated
        channels; the gated ones are ``gated_fn(operand)`` when ``gate`` is
        true, else NaN.  Floating device scalars are cast to float32."""
        out = dict(values)
        gated = self.spec.gated
        if gated:
            if gate:
                d = gated_fn(operand)
                out.update({c.name: d[c.name] for c in gated})
            else:
                out.update({c.name: math.nan for c in gated})
        missing = [c.name for c in self.spec.channels if c.name not in out]
        if missing:
            raise ValueError(f"round body did not provide channels {missing}")
        return tuple(_f32(out[c.name]) for c in self.spec.channels)

    def assemble(self, mask: np.ndarray, cols, constants: dict | None = None) -> dict[str, list]:
        """(n_rounds,) per-channel columns → the history at the recorded
        rounds (``mask``).  ``constants`` adds host-side per-round-constant
        channels."""
        if len(cols) != len(self.spec.channels):
            raise ValueError(f"{len(cols)} metric buffers for {len(self.spec.channels)} channels")
        rounds = np.nonzero(np.asarray(mask))[0]
        hist: dict[str, list] = {k: [] for k in BASE_KEYS}
        hist["round"] = [int(r) for r in rounds]
        for c, col in zip(self.spec.channels, cols):
            vals = host_values([col[int(r)] for r in rounds])
            hist[c.name] = [int(v) for v in vals] if c.ints else vals
        for name, value in (constants or {}).items():
            hist[name] = [value] * len(rounds)
        return hist


def _f32(v):
    if isinstance(v, torch.Tensor) and v.is_floating_point():
        return v.to(torch.float32)
    return v


@dataclasses.dataclass(frozen=True)
class BinChannel:
    """One named accumulator buffer of the event executor.

    ``width`` 0 means the spec's ``n_bins``; ``fill`` is the initial value
    (0 for sum-style channels, NaN for set-style slots)."""

    name: str
    width: int = 0
    fill: float = 0.0


@dataclasses.dataclass(frozen=True)
class BinSpec:
    """Named fixed-width float32 accumulators of the event-driven executor."""

    n_bins: int
    channels: tuple[BinChannel, ...]

    def __post_init__(self):
        names = [c.name for c in self.channels]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate bin channel names: {names}")

    def init(self, device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
        """Fresh accumulators, float32 on ``device``."""
        return {
            c.name: torch.full((c.width or self.n_bins,), c.fill, dtype=torch.float32, device=device)
            for c in self.channels
        }
