"""Plain PyTorch versions of the DecAvg mixing kernels (counterpart of
``repro/kernels/mix/ref.py`` and of the oracle in ``repro/kernels/mix/quant.py``).

The quantised mix works on a *chunk table*: ``bounds`` is a ``(C + 1,)``
int64 tensor of column boundaries, ``bounds[0] = 0`` and ``bounds[C] = d``;
chunk j of a row is columns ``[bounds[j], bounds[j + 1])`` and carries one
fp32 absmax scale.  The arithmetic is the JAX package's as XLA compiles it
(``jit``), which is what its executors run:

* scale — codec floor ``max(amax, 1e-30) · fl(1/qmax)`` (``core/compress.py``;
  XLA turns the division by the constant into that product), or the Pallas
  kernel's floor ``max(amax · fl(1/qmax), 1e-30)`` (``kernels/mix/quant.py``);
* code — a true division ``t / scale``, then int8: round half to even and
  clip to ±127; fp8: a cast to e4m3 (round to nearest even) and back;
* dequantised value — ``q · scale`` rounded once, or with a mirror h,
  ``h + q · scale`` rounded once (XLA contracts it into one FMA).
"""
from __future__ import annotations

import torch

__all__ = [
    "QMAX",
    "chunk_bounds",
    "decavg_mix_ref",
    "dequantise_ref",
    "fma_f32",
    "pair_mix_ref",
    "pair_round_ref",
    "pallas_bounds",
    "quant_mix_ref",
    "quant_scales_ref",
    "quantised_decavg_mix_ref",
]

QMAX = {"int8": 127.0, "fp8": 448.0}  # e4m3fn's largest finite value is 448
FLOORS = ("codec", "pallas")
_TINY = 1e-30


def decavg_mix_ref(m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Y = M @ W with fp32 accumulation, cast back to w.dtype."""
    return torch.matmul(m.to(torch.float32), w.to(torch.float32)).to(w.dtype)


def pair_mix_ref(pair: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exchange of one asynchronous event on its gathered endpoints, in
    the JAX package's form: ``pair`` (2, ...) holds node u in row 0 and v in
    row 1, ``w`` the (2,) weights ``[w_uv, w_vu]``; row 0 becomes
    ``x_u + w_uv·(x_v − x_u)``, row 1 ``x_v + w_vu·(x_u − x_v)``, as
    separate fp32 sub, mul and add, cast back to ``pair``'s dtype."""
    p = pair.to(torch.float32)
    return (p + w.to(torch.float32).reshape(2, *([1] * (p.ndim - 1))) * (p.flip(0) - p)).to(pair.dtype)


def pair_round_ref(
    m2: torch.Tensor,
    x: torch.Tensor,
    h: torch.Tensor | None,
    bounds: torch.Tensor,
    scales: torch.Tensor,
    *,
    codec: str,
    gamma: float,
    error_feedback: bool = True,
):
    """An event's compressed exchange in the pair kernel's arithmetic
    (``csrc/quant_mix.cu::quant_pair_kernel``, and the dense round's at
    n = 2): H' = ``dequantise_ref``; output row r is ``acc = fma(M[r, 1],
    h'_1, fma(M[r, 0], h'_0, 0))`` and ``X' = fma(γ, acc − h'_r, x_r)`` in X's
    dtype.  Returns (X', H')."""
    ef = error_feedback and h is not None
    hq = dequantise_ref(x, h, bounds, scales, codec=codec, error_feedback=ef)
    m2 = m2.to(torch.float32)
    acc = fma_f32(m2[:, 1:2], hq[1:2], fma_f32(m2[:, 0:1], hq[0:1], torch.zeros_like(hq)))
    g = torch.tensor(gamma, dtype=torch.float32, device=hq.device)
    return fma_f32(g, acc - hq, x.to(torch.float32)).to(x.dtype), hq


def chunk_bounds(sizes, chunk: int, device=None) -> torch.Tensor:
    """The chunk table of a flat row of leaves of ``sizes`` elements, each
    cut on its own into chunks of ``min(chunk, size)`` (the codec's per-leaf
    chunking, ``core/compress.py``); a leaf's last chunk may be short."""
    edges, off = [0], 0
    for size in sizes:
        if size:
            c = min(chunk, size)
            edges += [off + k for k in range(c, size, c)] + [off + size]
            off += size
    return torch.tensor(edges, dtype=torch.int64, device=device)


def pallas_bounds(d: int, block_d: int = 512, device=None) -> torch.Tensor:
    """The Pallas kernel's chunk table: ``min(block_d, next_pow2(d))``
    columns a chunk over the whole row (``kernels/mix/quant.py``)."""
    return chunk_bounds((d,), min(block_d, 1 << max(d - 1, 0).bit_length()), device)


def check_codec(codec: str, floor: str = "codec") -> None:
    if codec not in QMAX:
        raise ValueError(f"unknown kernel codec {codec!r} (int8 | fp8)")
    if floor not in FLOORS:
        raise ValueError(f"unknown scale floor {floor!r}, want one of {FLOORS}")


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a · b + c`` rounded once, as one fused multiply-add.

    ``a · b`` must be exact in float64 (a quantisation code times a scale:
    at most 8 + 24 significant bits).  The sum is taken in float64 with its
    exact error (TwoSum); rounding that to fp32 is the single rounding
    except where the float64 sum lies exactly halfway between two fp32
    values, and there the error's sign picks the neighbour.
    """
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    rd = r.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > rd, inf, -inf))
    tie = (s != rd) & ((rd + other.double()) * 0.5 == s) & (err != 0)
    toward_other = (err > 0) == (other.double() > rd)
    return torch.where(tie & toward_other, other, r)


def _col_chunk(bounds: torch.Tensor, device) -> torch.Tensor:
    """Chunk index of every column: (d,) int64 (the plain version only)."""
    lengths = (bounds[1:] - bounds[:-1]).to(device)
    return torch.repeat_interleave(torch.arange(lengths.numel(), device=device), lengths)


def _delta(x: torch.Tensor, h: torch.Tensor | None, error_feedback: bool) -> torch.Tensor:
    t = x.to(torch.float32)
    return t - h if error_feedback else t


def quant_scales_ref(
    x: torch.Tensor,
    h: torch.Tensor | None,
    bounds: torch.Tensor,
    *,
    codec: str,
    error_feedback: bool = True,
    floor: str = "codec",
) -> torch.Tensor:
    """One fp32 scale per (row, chunk) of ``x − h`` (of ``x`` when
    ``error_feedback`` is off or ``h`` is None): ``(n, C)``."""
    check_codec(codec, floor)
    t = _delta(x, h, error_feedback and h is not None).abs()
    n, c = t.shape[0], bounds.numel() - 1
    idx = _col_chunk(bounds, t.device).expand(n, -1)
    amax = torch.zeros(n, c, dtype=torch.float32, device=t.device).scatter_reduce_(1, idx, t, "amax")
    inv = torch.tensor(1.0 / QMAX[codec], dtype=torch.float32)  # fl(1/qmax)
    if floor == "codec":
        return torch.clamp_min(amax, _TINY) * inv
    return torch.clamp_min(amax * inv, _TINY)


def dequantise_ref(
    x: torch.Tensor,
    h: torch.Tensor | None,
    bounds: torch.Tensor,
    scales: torch.Tensor,
    *,
    codec: str,
    error_feedback: bool = True,
    keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """What every peer decodes, fp32 (n, d): ``h + Q(x − h)`` with a mirror
    and error feedback, else ``Q(x)``.  Rows where ``keep`` is False keep
    ``h`` (a node that transmitted nothing)."""
    check_codec(codec)
    ef = error_feedback and h is not None
    t = _delta(x, h, ef)
    s = scales[:, _col_chunk(bounds, t.device)]
    v = t / s
    if codec == "int8":
        q = torch.clamp(torch.round(v), -QMAX["int8"], QMAX["int8"])
    else:
        q = v.to(torch.float8_e4m3fn).to(torch.float32)
    out = fma_f32(q, s, h) if ef else q * s
    if keep is not None:
        out = torch.where(keep.to(torch.bool)[:, None], out, h)
    return out


def quant_mix_ref(
    mix_fn,
    x: torch.Tensor,
    h: torch.Tensor | None,
    bounds: torch.Tensor,
    scales: torch.Tensor,
    *,
    codec: str,
    gamma: float | None,
    error_feedback: bool = True,
    keep: torch.Tensor | None = None,
):
    """The quantised mix around a plain ``mix_fn`` (fp32 in, fp32 out).

    ``gamma`` None: Y = M·Q(X) in X's dtype (the Pallas kernel's function).
    Else one compressed round, returning (X', H'): H' = the dequantised
    rows, X' = X + γ (M·H' − H') in X's dtype.
    """
    hq = dequantise_ref(x, h, bounds, scales, codec=codec, error_feedback=error_feedback, keep=keep)
    y = mix_fn(hq)
    if gamma is None:
        return y.to(x.dtype)
    return (x.to(torch.float32) + gamma * (y - hq)).to(x.dtype), hq


def quantised_decavg_mix_ref(
    m: torch.Tensor, w: torch.Tensor, *, codec: str = "int8", block_d: int = 512
) -> torch.Tensor:
    """Y = M @ Q(W) with the Pallas kernel's chunking: one chunk per
    ``min(block_d, next_pow2(d))`` columns, its scale floor, fp32
    accumulation, Y in W's dtype."""
    bounds = pallas_bounds(w.shape[1], block_d)
    scales = quant_scales_ref(w, None, bounds, codec=codec, floor="pallas")
    return quant_mix_ref(lambda hq: decavg_mix_ref(m, hq), w, None, bounds, scales, codec=codec, gamma=None)
