"""Mamba (selective SSM) block (counterpart of ``repro/models/mamba.py``):
the "mamba" entries of jamba's 1:7 interleave.

Recurrence (diagonal selective SSM), per channel i and state n:

    h_t = exp(Δ_t A) ⊙ h_{t-1} + (Δ_t B_t) x_t          h ∈ R^{d_inner × N}
    y_t = C_t · h_t + D ⊙ x_t

with Δ_t = softplus(dt_proj(x) + dt_bias) and (B_t, C_t) read from x.

The JAX package scans chunks of 256 tokens with ``jax.lax.associative_scan``
inside each; here each chunk is a log-depth doubling scan (Hillis–Steele,
⌈log₂ chunk⌉ steps of whole-chunk tensor products, no in-place write, so
autograd records it), the state carried from chunk to chunk.  Forward and
prefill share it: the ragged last chunk is scanned as it is, so the state
after it is the state at the last token, the exact decode cache the JAX
single-chunk prefill returns, with a (B, chunk, d_inner, N) fp32 transient
instead of (B, L, d_inner, N) (2.1 GB a sequence of 2048 at jamba's width).
The summation order differs from XLA's scan: fp32 results agree to a
tolerance, not bitwise.  The module is plain torch: the JAX block has no
Pallas kernel.

Structured parameters (``a_log`` the S4D-real spectrum, ``conv_w`` /
``conv_b``, ``dt_bias`` the inverse softplus of a log-uniform step in
[1e-3, 1e-1], ``d_skip``) are not gain-corrected; ``a_log``, ``dt_bias``
and ``d_skip`` stay fp32 in a bf16 model.  The dense projections
(``in_proj``, ``x_proj``, ``dt_proj``, ``out_proj``) are gain-corrected
draws.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.initialisation import InitConfig

from .common import dense_init

Tree = dict[str, Any]

__all__ = ["init_mamba", "init_mamba_cache", "mamba_decode", "mamba_forward", "mamba_prefill"]

CHUNK = 256  # tokens a scan step (the JAX package's _CHUNK)


def _dt_rank(cfg: ArchConfig) -> int:
    return max(1, -(-cfg.d_model // 16))  # ceil(d_model / 16), mamba's default


def init_mamba(init_cfg: InitConfig, generator: torch.Generator, cfg: ArchConfig, lead: tuple[int, ...] = ()) -> Tree:
    d, n, dc, r = cfg.d_model, cfg.mamba_d_state, cfg.mamba_d_conv, _dt_rank(cfg)
    di = cfg.mamba_expand * d
    dt, dev = cfg.param_dtype, generator.device

    def dense(shape):
        return dense_init(init_cfg, generator, shape, dt, lead=lead)

    # log(1..N) correctly rounded to fp32 (XLA's CPU log rounds log 7 up by an ulp)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float64)).float().to(dev).expand(*lead, di, n).clone()
    lo, hi = math.log(0.001), math.log(0.1)
    dt_init = torch.exp(torch.rand(*lead, di, generator=generator, device=dev) * (hi - lo) + lo)
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # the inverse softplus, fp32
    conv_w = (torch.rand(*lead, dc, di, generator=generator, device=dev) * 2 - 1) / math.sqrt(dc)
    return {
        "in_proj": dense((d, 2 * di)),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros(*lead, di, dtype=dt, device=dev),
        "x_proj": dense((di, r + 2 * n)),
        "dt_proj": dense((r, di)),
        "dt_bias": dt_bias,
        "a_log": a_log,
        "d_skip": torch.ones(*lead, di, dtype=torch.float32, device=dev),
        "out_proj": dense((di, d)),
    }


def _ssm_params(p: Tree, cfg: ArchConfig, xc: torch.Tensor):
    """xc (..., L, di) → decay (..., L, di, N), drive bx (..., L, di, N), c (..., L, N), all fp32."""
    n, r = cfg.mamba_d_state, _dt_rank(cfg)
    proj = torch.matmul(xc, p["x_proj"]["w"])
    dt_r, b, c = proj[..., :r], proj[..., r : r + n], proj[..., r + n :]
    dt = F.softplus(torch.matmul(dt_r, p["dt_proj"]["w"]).float() + p["dt_bias"])  # (..., L, di)
    a = -torch.exp(p["a_log"])  # (di, N)
    decay = torch.exp(dt[..., None] * a)
    bx = (dt * xc.float())[..., None] * b[..., None, :].float()
    return decay, bx, c.float()


def _conv1d(p: Tree, x: torch.Tensor, carry: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv over the sequence in x's dtype, the taps summed
    in the JAX package's order; ``carry`` (..., dc-1, di) holds the tokens
    before x (None: zeros).  Returns (silu(conv), the new carry)."""
    dc, l = p["conv_w"].shape[-2], x.shape[-2]
    if carry is None:
        carry = torch.zeros(*x.shape[:-2], dc - 1, x.shape[-1], dtype=x.dtype, device=x.device)
    xp = torch.cat([carry, x], dim=-2)
    out = sum(xp[..., i : i + l, :] * p["conv_w"][i].to(x.dtype) for i in range(dc)) + p["conv_b"].to(x.dtype)
    return F.silu(out), xp[..., xp.shape[-2] - (dc - 1) :, :]


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis -3 from h = 0:
    (A_t = Π_{s≤t} a_s, B_t = h_t).  After step k every position holds the
    composition of the 2^k elements ending at it."""
    k, l = 1, a.shape[-3]
    while k < l:
        b = torch.cat([b[..., :k, :, :], a[..., k:, :, :] * b[..., : l - k, :, :] + b[..., k:, :, :]], dim=-3)
        a = torch.cat([a[..., :k, :, :], a[..., k:, :, :] * a[..., : l - k, :, :]], dim=-3)
        k *= 2
    return a, b


def _selective_scan(p: Tree, cfg: ArchConfig, xc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xc (..., L, di) → (y = C·h (..., L, di) fp32, the state after token L (..., di, N) fp32)."""
    l, di = xc.shape[-2:]
    h = torch.zeros(*xc.shape[:-2], di, cfg.mamba_d_state, dtype=torch.float32, device=xc.device)
    ys = []
    for c0 in range(0, l, CHUNK):
        decay, bx, c = _ssm_params(p, cfg, xc[..., c0 : c0 + CHUNK, :])
        a_acc, b_acc = _doubling_scan(decay, bx)
        h_all = a_acc * h[..., None, :, :] + b_acc  # (..., chunk, di, N)
        ys.append(torch.einsum("...lin,...ln->...li", h_all, c))
        h = h_all[..., -1, :, :]
        del decay, bx, a_acc, b_acc, h_all
    return torch.cat(ys, dim=-2), h


def _out(p: Tree, x: torch.Tensor, xc: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = y + xc.float() * p["d_skip"]
    return torch.matmul(y.to(x.dtype) * F.silu(z), p["out_proj"]["w"])


def _in(p: Tree, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xin, z = torch.matmul(x, p["in_proj"]["w"]).chunk(2, dim=-1)
    return xin, z


def mamba_forward(p: Tree, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Training / prefill pass over a full sequence: x (..., L, D) → (..., L, D)."""
    return mamba_prefill(p, cfg, x)[0]


def mamba_prefill(p: Tree, cfg: ArchConfig, x: torch.Tensor) -> tuple[torch.Tensor, Tree]:
    """Full-prompt pass that also returns the decode cache: the conv tail
    ``_conv1d`` leaves (param dtype) and the fp32 state after the last
    prompt token, what token-by-token ``mamba_decode`` would have reached."""
    xin, z = _in(p, x)
    xc, conv = _conv1d(p, xin)
    y, h = _selective_scan(p, cfg, xc)
    return _out(p, x, xc, y, z), {"conv": conv.to(cfg.param_dtype), "ssm": h}


def init_mamba_cache(cfg: ArchConfig, batch_shape: tuple[int, ...], dtype=None, device=None) -> Tree:
    di = cfg.mamba_expand * cfg.d_model
    return {
        "conv": torch.zeros(*batch_shape, cfg.mamba_d_conv - 1, di, dtype=dtype or cfg.param_dtype, device=device),
        "ssm": torch.zeros(*batch_shape, di, cfg.mamba_d_state, dtype=torch.float32, device=device),
    }


def mamba_decode(p: Tree, cfg: ArchConfig, x: torch.Tensor, cache: Tree) -> tuple[torch.Tensor, Tree]:
    """One token: x (..., 1, D) → ((..., 1, D), the cache), its conv tail
    and state updated in place (static buffers for a CUDA-graph step)."""
    xin, z = _in(p, x)
    xc, conv = _conv1d(p, xin, cache["conv"].to(xin.dtype))
    decay, bx, c = _ssm_params(p, cfg, xc)  # L = 1
    h = cache["ssm"] * decay[..., 0, :, :] + bx[..., 0, :, :]
    y = torch.einsum("...in,...n->...i", h, c[..., 0, :])[..., None, :]
    cache["conv"].copy_(conv)
    cache["ssm"].copy_(h)
    return _out(p, x, xc, y, z), cache
