"""RWKV-6 "Finch" block (counterpart of ``repro/models/rwkv.py``): attention-free
time-mix with data-dependent decay, and the channel-mix FFN.

Per head (head_dim = M), with data-dependent per-channel decay w_t ∈ (0, 1):

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t               S ∈ R^{M×M}
    o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)           u = time_first "bonus"

Every full-sequence time-mix (``rwkv_time_mix``: forward and prefill) goes
through ``repro_torch.kernels.rwkv.rwkv6_attention``: the hand-written CUDA
kernel on the card, its plain chunked version on the CPU.  Both return the
wkv output in fp32 and the final state, which is the decode cache.  When
autograd records the call (training) it runs the plain chunked form
``kernels/rwkv/ref.py::rwkv6_chunked_ref`` on either device, the JAX
package's ``_wkv_chunked`` (the kernel has no backward, nor has the JAX
package: its gradients are autodiff of that form), as ``attention_forward``
runs the plain softmax.  The one-token step ``rwkv_time_mix_step`` stays
plain torch, the direct recurrence, as in the JAX package.

Structured parameters (decay base, bonus, token-shift mixes, the output
layernorm) are deterministic formulas, bitwise the JAX package's and in its
dtypes (fp32 leaves inside a bf16 model); the dense projections are
gain-corrected draws.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.initialisation import InitConfig
from repro_torch.dtensor import on_local_batch, split_heads
from repro_torch.kernels.rwkv import rwkv6_attention
from repro_torch.kernels.rwkv.ref import rwkv6_chunked_ref, wkv_step

from .common import dense_init, norm_apply, norm_init

Tree = dict[str, Any]

__all__ = ["init_rwkv", "init_rwkv_cache", "rwkv_channel_mix", "rwkv_time_mix", "rwkv_time_mix_step"]

# the JAX package raises the ratio to float32(0.7); its fp32 pow is pow in
# double rounded to fp32 (bitwise at the configs' widths, 128 and 2560)
_DECAY_EXP = float(torch.tensor(0.7, dtype=torch.float32))


def _n_heads(cfg: ArchConfig) -> int:
    assert cfg.d_model % cfg.rwkv_head_dim == 0
    return cfg.d_model // cfg.rwkv_head_dim


def init_rwkv(init_cfg: InitConfig, generator: torch.Generator, cfg: ArchConfig, lead: tuple[int, ...] = ()) -> Tree:
    d, h, m, f = cfg.d_model, _n_heads(cfg), cfg.rwkv_head_dim, cfg.d_ff
    dt, dev = cfg.param_dtype, generator.device
    lora = max(32, d // 16)  # decay LoRA rank (rwkv6 uses 64 at 2k..4k widths)

    def structured(t: torch.Tensor) -> torch.Tensor:
        return t.to(dev).expand(*lead, *t.shape).clone()

    def mix(value: float) -> torch.Tensor:
        return structured((value * torch.ones(d, dtype=torch.float32)).to(dt))

    def dense(shape):
        return dense_init(init_cfg, generator, shape, dt, lead=lead)

    ratio = torch.arange(d, dtype=torch.float32) / max(d - 1, 1)
    decay_base = -6.0 + 5.0 * (ratio.double() ** _DECAY_EXP).float()  # w over a broad range
    bonus = torch.zeros(h, m, dtype=torch.float32) + 0.5 * (1 - ratio).reshape(h, m)
    return {
        "tmix": {
            "mix_r": mix(0.5),
            "mix_k": mix(0.7),
            "mix_v": mix(0.7),
            "mix_g": mix(0.5),
            "mix_w": mix(0.6),
            "wr": dense((d, d)),
            "wk": dense((d, d)),
            "wv": dense((d, d)),
            "wg": dense((d, d)),
            "wo": dense((d, d)),
            "decay_lora_a": dense((d, lora)),
            "decay_lora_b": dense((lora, d)),
            "decay_base": structured(decay_base),  # fp32 structured
            "bonus": structured(bonus),  # fp32 structured
            "out_norm": norm_init(d, "layernorm", torch.float32, lead, dev),
        },
        "cmix": {
            "mix_k": mix(0.7),
            "mix_r": mix(0.5),
            "wk": dense((d, f)),
            "wv": dense((f, d)),
            "wr": dense((d, d)),
        },
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x (..., L, D) shifted right by one; position 0 takes ``prev`` (..., 1, D)."""
    return torch.cat([prev, x[..., :-1, :]], dim=-2)


def _tmix_projections(p: Tree, x: torch.Tensor, xs: torch.Tensor, cfg: ArchConfig):
    h, m = _n_heads(cfg), cfg.rwkv_head_dim

    def lerp(mix):
        return x + (xs - x) * mix.to(x.dtype)

    r = torch.matmul(lerp(p["mix_r"]), p["wr"]["w"])
    k = torch.matmul(lerp(p["mix_k"]), p["wk"]["w"])
    v = torch.matmul(lerp(p["mix_v"]), p["wv"]["w"])
    g = F.silu(torch.matmul(lerp(p["mix_g"]), p["wg"]["w"]))
    # data-dependent decay (the "Finch" feature): base + LoRA(x)
    dw = torch.matmul(torch.tanh(torch.matmul(lerp(p["mix_w"]), p["decay_lora_a"]["w"])), p["decay_lora_b"]["w"])
    # the JAX package's stability clamp: per-step log-decay >= -e, so the
    # chunked exponent spans stay inside fp32's range
    z = torch.clamp(p["decay_base"] + dw.float(), -8.0, 1.0)
    w = torch.exp(-torch.exp(z))  # (..., L, D) fp32 in (0, 1)
    return split_heads(r, h, m), split_heads(k, h, m), split_heads(v, h, m), g, split_heads(w, h, m)


def init_rwkv_cache(cfg: ArchConfig, batch_shape: tuple[int, ...], dtype=None, device=None) -> Tree:
    d, h, m = cfg.d_model, _n_heads(cfg), cfg.rwkv_head_dim
    dt = dtype or cfg.param_dtype
    return {
        "tshift": torch.zeros(*batch_shape, 1, d, dtype=dt, device=device),
        "cshift": torch.zeros(*batch_shape, 1, d, dtype=dt, device=device),
        "state": torch.zeros(*batch_shape, h, m, m, dtype=torch.float32, device=device),
    }


def _tmix_out(p: Tree, x: torch.Tensor, out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The fp32 wkv output (..., L, H·M) through the output layernorm, gated, projected."""
    out = norm_apply(p["out_norm"], out, "layernorm")
    return torch.matmul(out.to(x.dtype) * g, p["wo"]["w"])


def _heads_flattened(wkv):
    """``wkv`` with its output's (H, M) dims flattened to H·M where the
    heads are computed (on a rank's local shard for DTensors, so the
    gradient never unflattens a dim split over the mesh)."""

    def run(*args):
        out, state = wkv(*args)
        return out.reshape(*out.shape[:-2], -1), state

    return run


def rwkv_time_mix(
    p: Tree, cfg: ArchConfig, x: torch.Tensor, prev: torch.Tensor, state: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time-mix through the kernel, or through its plain
    chunked form when autograd records the call; ``state`` None is the zero
    state.  Returns (y, last token of x, state' (..., H, M, M) fp32)."""
    xs = _token_shift(x, prev)
    r, k, v, g, w = _tmix_projections(p, x, xs, cfg)
    inputs = (r, k, v, w, p["bonus"], state)
    grad = torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs)
    out, state = on_local_batch(_heads_flattened(rwkv6_chunked_ref if grad else rwkv6_attention), *inputs,
                                shared=(4,))
    y = _tmix_out(p, x, out, g)
    return y, x[..., -1:, :], state


def rwkv_channel_mix(p: Tree, x: torch.Tensor, prev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xs = _token_shift(x, prev)

    def lerp(mix):
        return x + (xs - x) * mix.to(x.dtype)

    k = torch.relu(torch.matmul(lerp(p["mix_k"]), p["wk"]["w"])).square()
    v = torch.matmul(k, p["wv"]["w"])
    r = torch.sigmoid(torch.matmul(lerp(p["mix_r"]), p["wr"]["w"]))
    return r * v, x[..., -1:, :]


def rwkv_time_mix_step(
    p: Tree, cfg: ArchConfig, x: torch.Tensor, tshift: torch.Tensor, state: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token time-mix (L = 1): the direct recurrence, O(1) state.

    x (..., 1, D); tshift (..., 1, D) = previous token's input; state
    (..., H, M, M).  Returns (y (..., 1, D), new tshift, new state)."""
    r, k, v, g, w = _tmix_projections(p, x, tshift.to(x.dtype), cfg)
    r32, k32, v32, w32 = (t[..., 0, :, :].float() for t in (r, k, v, w))
    out, new_state = wkv_step(state, r32, k32, v32, w32, p["bonus"])
    y = _tmix_out(p, x, out.reshape(*x.shape[:-2], 1, -1), g)
    return y, x, new_state
