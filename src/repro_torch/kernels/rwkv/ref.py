"""Plain PyTorch versions of the RWKV-6 time-mix (mirror ``repro/kernels/rwkv/ref.py``
and ``repro/models/rwkv.py::_wkv_chunked``).

``rwkv6_ref`` is the per-token scan, the oracle of the tests; its step
``wkv_step`` is also the model's one-token decode recurrence.
``rwkv6_chunked_ref`` is the chunked form the CUDA kernel computes: the
model's chunks of ``min(32, L)`` tokens, its mid-chunk-referenced decay
factorisation, and its padding of a ragged L with k = v = 0 and w = 1.
CPU tensors run it on the model's path; on the card it is what the kernel
is held against.  ``rwkv6_spans_ref`` is the span decomposition the Hopper
kernel (``csrc/rwkv_sm90.cu``) computes, with its split-operand products
optionally emulated; only the tests use it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.split import split_parts, split_product

__all__ = ["CHUNK", "SPAN", "rwkv6_chunked_ref", "rwkv6_ref", "rwkv6_spans_ref", "split_parts", "wkv_step"]

CHUNK = 32
SPAN = 4 * CHUNK  # tokens a state step of the Hopper kernel (csrc/rwkv_sm90.cu's kSpan)


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


def rwkv6_spans_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None = None,
    *,
    split: str | None = None,
    single_span: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``rwkv6_chunked_ref``'s function in the Hopper kernel's three phases:
    the sequence cut into spans of SPAN tokens, each span into CHUNK-token
    sub-chunks with the model's exponents.

    A. per span, all in parallel: the state it adds from a zero state, by
       the recurrence itself over its sub-chunks j,
       ΔS = e^{last_j} ΔS + Σ_{s ∈ j} (k_s e^{last_j − cum_s})ᵀ v_s (cum the
       log-decay scan of sub-chunk j, last its final value), and the span's
       decay W = Π_j e^{last_j};
    B. the only sequential loop, elementwise: S_in[span] = S, S = W S + ΔS;
    C. per span, all in parallel: each sub-chunk's output from the state
       entering it (S_in, then S = e^{last_j} S + kf_jᵀ v_j within the span),
       its pairs through the mid-chunk factorisation and the bonus.

    ``split`` emulates the kernel's products ("bf16" or "tf32" hi + lo
    parts, see ``split_product``); None takes them in fp32.  With
    ``single_span`` (L ≤ SPAN: the kernel's one-launch path) C runs alone:
    it starts from the given state and carries it through every sub-chunk,
    the last included, to the final state, so ``out`` is the three phases'
    bit for bit and the state sums in another order.  Shapes as
    ``rwkv6_chunked_ref``."""
    lead = r.shape[:-3]
    l, h, m = r.shape[-3:]
    if single_span and l > SPAN:
        raise ValueError(f"single_span takes L <= {SPAN}, got {l}")
    if state is None:
        state = torch.zeros(*lead, h, m, m, dtype=torch.float32, device=r.device)
    n_sub, n_span = SPAN // CHUNK, -(-l // SPAN)
    pad = n_span * SPAN - l
    r, k, v, w = (t.float() for t in (r, k, v, w))
    if pad:
        padt = lambda t, value=0.0: F.pad(t, (0, 0, 0, 0, 0, pad), value=value)  # noqa: E731
        r, k, v, w = padt(r), padt(k), padt(v), padt(w, 1.0)
    # (..., NS, n_sub, CHUNK, H, M): spans, their sub-chunks, tokens
    rr, kk, vv, ww = (t.reshape(*lead, n_span, n_sub, CHUNK, h, m) for t in (r, k, v, w))
    logw = torch.log(ww.clamp_min(1e-20))
    cum = torch.cumsum(logw, dim=-3)
    last = cum[..., -1:, :, :]
    wl = torch.exp(last)  # (..., NS, n_sub, 1, H, M)
    kf = kk * torch.exp(last - cum)  # sub-chunk-local state factor, exponent <= 0

    # A. every span from a zero state, its sub-chunks in order
    d_state = torch.zeros(*lead, n_span, h, m, m, dtype=torch.float32, device=r.device)
    w_span = torch.ones(*lead, n_span, h, m, dtype=torch.float32, device=r.device)
    for j in range(n_sub):
        wl_j = wl[..., j, 0, :, :]  # (..., NS, H, M)
        d_state = d_state * wl_j[..., :, None] + split_product("...shm,...shn->...hmn", kf[..., j, :, :, :],
                                                          vv[..., j, :, :, :], split)
        w_span = w_span * wl_j

    # B. the state entering each span
    s_in = []
    for i in range(n_span):
        s_in.append(state)
        state = state * w_span[..., i, :, :, None] + d_state[..., i, :, :, :]
    s = torch.stack(s_in, dim=-4)  # (..., NS, H, M, M)

    # C. every span at once, its sub-chunks in order
    u = u.float()
    tri = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=r.device).tril(-1)
    mid = cum[..., CHUNK // 2 : CHUNK // 2 + 1, :, :]
    outs = []
    for j in range(n_sub):
        rj, kj, vj, cj, lj, mj = (t[..., j, :, :, :] for t in (rr, kk, vv, cum, logw, mid))
        rq = rj * torch.exp(cj - lj)
        out = split_product("...thm,...hmn->...thn", rq, s, split)
        scores = split_product("...thm,...shm->...hts", rj * torch.exp(cj - lj - mj), kj * torch.exp(mj - cj), split)
        bonus = torch.einsum("...thm,hm,...thm->...ht", rj, u, kj)
        p = torch.where(tri, scores, torch.zeros((), device=r.device)) + torch.diag_embed(bonus)
        outs.append(out + split_product("...hts,...shm->...thm", p, vj, split))
        if j + 1 < n_sub or single_span:
            s = s * wl[..., j, 0, :, :, None] + split_product("...shm,...shn->...hmn", kf[..., j, :, :, :], vj, split)
    out = torch.stack(outs, dim=-4).reshape(*lead, n_span * SPAN, h, m)
    return out[..., :l, :, :], s[..., 0, :, :, :] if single_span and n_span else state
