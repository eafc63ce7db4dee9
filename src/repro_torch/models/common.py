"""Shared building blocks of the decoder zoo (counterpart of ``repro/models/common.py``).

Everything is functional: ``init_*`` returns a nested-dict parameter tree
with the JAX package's leaf names and layout, the forward functions are
plain.  Every random weight draw goes through
``repro_torch.core.initialisation.scaled_init``, so the paper's
‖v_steady‖⁻¹ gain reaches every architecture; structured parameters (norm
scales, biases) bypass it.  The JAX package's ``KeyGen`` becomes one
``torch.Generator`` threaded through the init functions.

Leading axes.  ``lead`` prepends axes to a leaf: a node axis first when
``init_cfg.gain`` is an ``(n,)`` tensor of per-node gains, then a period
axis for the stacked blocks.  Weights are drawn one ``shape`` slice at a
time, so fans come from the per-layer shape (as the JAX package's vmapped
init sees it) and no fp32 copy of a whole stacked leaf is ever built.
"""
from __future__ import annotations

import itertools
from typing import Any

import torch

from repro_torch.core.initialisation import InitConfig, scaled_init

Tree = dict[str, Any]

__all__ = [
    "apply_rope",
    "dense_init",
    "node_lead",
    "norm_apply",
    "norm_init",
    "rope_freqs",
]


def node_lead(init_cfg: InitConfig) -> tuple[int, ...]:
    """``(n,)`` for a per-node gain tensor (a node-stacked ensemble), else ``()``."""
    g = init_cfg.gain
    return (g.shape[0],) if isinstance(g, torch.Tensor) and g.ndim == 1 else ()


def dense_init(
    init_cfg: InitConfig,
    generator: torch.Generator,
    shape: tuple[int, ...],
    dtype: torch.dtype = torch.bfloat16,
    bias: bool = False,
    lead: tuple[int, ...] = (),
) -> Tree:
    """A (gain-corrected) dense weight ``lead + shape``, optionally with a zero bias."""
    nodes = node_lead(init_cfg)
    if lead[: len(nodes)] != nodes:
        raise ValueError(f"lead {lead} must start with the node axis {nodes}")
    w = torch.empty(*lead, *shape, dtype=dtype, device=generator.device)
    for idx in itertools.product(*map(range, lead)):
        gain = float(init_cfg.gain[idx[0]]) if nodes else init_cfg.gain
        w[idx] = scaled_init(init_cfg.replace(gain=gain), generator, shape)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(*lead, shape[-1], dtype=dtype, device=generator.device)
    return p


def norm_init(d: int, kind: str, dtype=torch.bfloat16, lead: tuple[int, ...] = (), device=None) -> Tree:
    """RMSNorm (scale only) or LayerNorm (scale + bias); structured init,
    not gain-corrected."""
    p = {"scale": torch.ones(*lead, d, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(*lead, d, dtype=dtype, device=device)
    return p


def norm_apply(p: Tree, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32 and cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    raise ValueError(f"unknown norm kind {kind}")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings, (head_dim // 2,) fp32.

    Built on the device from scalars: no host-to-device copy, which would
    stall the host once per layer and decode step."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding.

    x (..., S, H, hd); positions broadcastable to (..., S) absolute indices.
    fp32 trig, cast back to x's dtype.
    """
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., :, None].float() * inv[None, :]  # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
