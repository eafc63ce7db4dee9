"""Dense FFN variants: SwiGLU / GeGLU / classic GELU MLP (counterpart of ``repro/models/mlp.py``).

The matrix products are ``torch.matmul`` (cuBLAS on the card), as the JAX
package leaves its einsums to XLA.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.initialisation import InitConfig

from .common import dense_init

Tree = dict[str, Any]

__all__ = ["init_ffn", "ffn_forward"]


def init_ffn(init_cfg: InitConfig, generator: torch.Generator, cfg: ArchConfig, lead: tuple[int, ...] = ()) -> Tree:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(init_cfg, generator, (d, f), dt, lead=lead),
            "w_in": dense_init(init_cfg, generator, (d, f), dt, lead=lead),
            "w_out": dense_init(init_cfg, generator, (f, d), dt, lead=lead),
        }
    if cfg.mlp_type == "gelu_mlp":
        return {
            "w_in": dense_init(init_cfg, generator, (d, f), dt, lead=lead),
            "w_out": dense_init(init_cfg, generator, (f, d), dt, lead=lead),
        }
    raise ValueError(f"unknown mlp_type {cfg.mlp_type}")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def ffn_forward(p: Tree, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x (..., S, D) → (..., S, D)."""
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_type == "swiglu" else _gelu
        g = torch.matmul(x, p["w_gate"]["w"])
        h = torch.matmul(x, p["w_in"]["w"])
        return torch.matmul(act(g) * h, p["w_out"]["w"])
    h = _gelu(torch.matmul(x, p["w_in"]["w"]))
    return torch.matmul(h, p["w_out"]["w"])
