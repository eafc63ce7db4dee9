"""Plain PyTorch versions of the RWKV-6 time-mix (mirror ``repro/kernels/rwkv/ref.py``
and ``repro/models/rwkv.py::_wkv_chunked``).

``rwkv6_ref`` is the per-token scan, the oracle of the tests; its step
``wkv_step`` is also the model's one-token decode recurrence.
``rwkv6_chunked_ref`` is the chunked form the CUDA kernel computes: the
model's chunks of ``min(32, L)`` tokens, its mid-chunk-referenced decay
factorisation, and its padding of a ragged L with k = v = 0 and w = 1.
CPU tensors run it on the model's path; on the card it is what the kernel
is held against.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CHUNK", "rwkv6_chunked_ref", "rwkv6_ref", "wkv_step"]

CHUNK = 32


def wkv_step(
    state: torch.Tensor, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One token of the recurrence, fp32: r/k/v/w (..., M), u broadcast to
    them, state (..., M, M) → (out (..., M), the next state)."""
    kv = k[..., :, None] * v[..., None, :]
    out = torch.einsum("...m,...mn->...n", r, state + u[..., :, None] * kv)
    return out, state * w[..., :, None] + kv


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r/k/v/w (BH, L, M), u (BH, M) → out (BH, L, M) in r's dtype; fp32
    state from zero, one token at a time."""
    bh, l, m = r.shape
    r32, k32, v32, w32 = (t.float() for t in (r, k, v, w))
    u32 = u.float()
    state = torch.zeros(bh, m, m, dtype=torch.float32, device=r.device)
    outs = []
    for t in range(l):
        out, state = wkv_step(state, r32[:, t], k32[:, t], v32[:, t], w32[:, t], u32)
        outs.append(out)
    return torch.stack(outs, dim=1).to(r.dtype)


def rwkv6_chunked_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w (..., L, H, M); u (H, M); state (..., H, M, M) fp32 or None
    (zero) → (out (..., L, H, M) fp32, the state after token L)."""
    lead = r.shape[:-3]
    l, h, m = r.shape[-3:]
    if state is None:
        state = torch.zeros(*lead, h, m, m, dtype=torch.float32, device=r.device)
    c = min(CHUNK, l)
    pad = -l % c
    r, k, v, w = (t.float() for t in (r, k, v, w))
    if pad:
        padt = lambda t, value=0.0: F.pad(t, (0, 0, 0, 0, 0, pad), value=value)  # noqa: E731
        r, k, v, w = padt(r), padt(k), padt(v), padt(w, 1.0)
    u = u.float()
    tri = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    outs = []
    for c0 in range(0, l + pad, c):
        rr, kk, vv, ww = (t[..., c0 : c0 + c, :, :] for t in (r, k, v, w))
        logw = torch.log(ww.clamp_min(1e-20))
        cum = torch.cumsum(logw, dim=-3)  # log W_t, inclusive
        # state-in contribution r_t W_{t-1} S: exponent cum_{t-1} <= 0
        out = torch.einsum("...thm,...hmn->...thn", rr * torch.exp(cum - logw), state)
        # pairs s < t through the mid-chunk reference: each factor's exponent
        # stays within half the chunk's log-decay span
        mid = cum[..., c // 2 : c // 2 + 1, :, :]
        rq2 = rr * torch.exp(cum - logw - mid)
        kd2 = kk * torch.exp(mid - cum)
        scores = torch.einsum("...thm,...shm->...hts", rq2, kd2)
        scores = torch.where(tri, scores, torch.zeros((), device=r.device))
        out = out + torch.einsum("...hts,...shm->...thm", scores, vv)
        # bonus (current-token) term r_t diag(u) k_tᵀ v_t
        out = out + torch.einsum("...thm,hm,...thm->...th", rr, u, kk)[..., None] * vv
        # S' = W_c S + Σ_s (W_c / W_s) k_sᵀ v_s: exponents <= 0
        last = cum[..., -1:, :, :]
        kfac = kk * torch.exp(last - cum)
        state = state * torch.exp(last[..., 0, :, :])[..., :, None] + torch.einsum(
            "...shm,...shn->...hmn", kfac, vv
        )
        outs.append(out)
    return torch.cat(outs, dim=-3)[..., :l, :, :], state
