"""The port's RWKV-6 path (kernel plain versions, blocks, decoder, serving)
against the JAX package's on the same numpy-seeded inputs, on the CPU.

On a CPU tensor ``rwkv6_chunked`` runs its plain chunked version; it is held
against the JAX Pallas kernel in interpret mode, the JAX per-token oracle and
the model's ``_wkv_chunked`` (out and final state, zero and nonzero initial
state) to |Δ| ≤ 5e-5 · max|ref|, the JAX package's own kernel-vs-oracle
bound.  Blocks to rtol 1e-5 with an atol of 1e-5 · max|ref| (summation
order through four projections and the output layernorm).  The reduced
rwkv6-3b decoder (forward, prefill logits, every cache leaf, four decode
steps) to rtol 1e-4, atol 1e-5, as the attention decoders, with the atol
scaled by max|leaf| where a leaf is larger than 1 (the wkv state sums ~40
decayed k·v products and reaches ~10); greedy tokens exactly.  Parameters are drawn with numpy
in the JAX package's tree layout (``jax.eval_shape`` of its ``init_params``)
and injected into both packages; JAX outputs come from jitted calls in
module fixtures.  The CUDA kernels themselves are held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
3); here the Hopper kernel's span decomposition (``rwkv6_spans_ref``), its
bf16 hi + lo products emulated, is held against the JAX package to the same
5e-5 · max|ref|, and the routing and layout checks of the wrapper run.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.core.initialisation import InitConfig as JInitConfig  # noqa: E402
from repro.fed import serve as JS  # noqa: E402
from repro.kernels.rwkv.ops import rwkv6_attention as jax_rwkv6_attention  # noqa: E402
from repro.kernels.rwkv.ref import rwkv6_ref as jax_rwkv6_ref  # noqa: E402
from repro.kernels.rwkv.rwkv import rwkv6_chunked as jax_rwkv6_chunked  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.initialisation import InitConfig  # noqa: E402
from repro_torch.fed import serve as PS  # noqa: E402
from repro_torch.flat import tree_map  # noqa: E402
from repro_torch.kernels.rwkv import rwkv as PK  # noqa: E402
from repro_torch.kernels.rwkv import rwkv6_attention, rwkv6_chunked, rwkv6_ref  # noqa: E402
from repro_torch.kernels.rwkv.ref import rwkv6_spans_ref, split_parts  # noqa: E402
from repro_torch.models import common as PC  # noqa: E402
from repro_torch.models import rwkv as PR  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402

ARCH = "rwkv6_3b"
TOL = dict(rtol=1e-4, atol=1e-5)
CACHE_LEN, N_DECODE, N_NEW, N_NODES = 64, 4, 6, 3


def _close_scaled(got, want, rel=5e-5):
    """|Δ| ≤ rel · max|want|: the JAX package's kernel-vs-oracle bound."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, float(np.abs(got - want).max()) / scale


def _wkv_inputs(bh, l, m, seed=0):
    """The JAX package's kernel-test inputs, drawn with numpy: (BH, L, M)."""
    rng = np.random.default_rng(seed + 7 * bh + l + m)
    r = rng.standard_normal((bh, l, m)).astype(np.float32)
    k = (0.5 * rng.standard_normal((bh, l, m))).astype(np.float32)
    v = rng.standard_normal((bh, l, m)).astype(np.float32)
    z = np.clip(2.0 * rng.standard_normal((bh, l, m)), -8.0, 1.0)
    w = np.exp(-np.exp(z)).astype(np.float32)
    u = (0.3 * np.abs(rng.standard_normal((bh, m)))).astype(np.float32)
    return r, k, v, w, u


def _as_heads(t):
    """(BH, L, M) numpy → (1, L, BH, M) torch: the BH rows become heads."""
    return torch.as_tensor(t).transpose(0, 1)[None]


# ------------------------------------------------------------------ kernel, plain
@pytest.mark.parametrize(
    "bh,l,m", [(2, 64, 32), (6, 200, 64), (1, 33, 128), (4, 32, 64), (2, 1, 32), (3, 31, 32), (2, 77, 64)]
)
def test_plain_chunked_matches_jax_kernel_and_oracle(bh, l, m):
    r, k, v, w, u = _wkv_inputs(bh, l, m)
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u)]
    want_kernel = np.asarray(jax_rwkv6_chunked(*jargs, interpret=True))
    want_ref = np.asarray(jax_rwkv6_ref(*jargs))
    before = rwkv6_chunked.launches
    out, state = rwkv6_chunked(*(_as_heads(a) for a in (r, k, v, w)), torch.as_tensor(u))
    assert rwkv6_chunked.launches == before, "a CPU tensor must not launch the kernel"
    assert out.dtype == torch.float32 and out.shape == (1, l, bh, m) and state.shape == (1, bh, m, m)
    got = out[0].transpose(0, 1).numpy()
    _close_scaled(got, want_kernel)
    _close_scaled(got, want_ref)
    # the port's per-token oracle is the JAX package's
    _close_scaled(rwkv6_ref(*(torch.as_tensor(a) for a in (r, k, v, w, u))).numpy(), want_ref)


def _model_wkv(r, k, v, w, u, state):
    """The JAX model's ``_wkv_chunked`` with its caller's padding (chunk
    min(32, L), w padded with ones)."""
    l = r.shape[-3]
    c = min(32, l)
    pad = (-l) % c
    padt = lambda t, val=0.0: jnp.pad(t, [(0, 0), (0, pad), (0, 0), (0, 0)], constant_values=val)  # noqa: E731
    out, st = JR._wkv_chunked(padt(r), padt(k), padt(v), padt(w, 1.0), u, state)
    return out[:, :l], st


@pytest.mark.parametrize("b,l,h,m", [(2, 77, 3, 32), (1, 40, 2, 64), (2, 5, 2, 32)])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_chunked_matches_model_wkv_chunked(b, l, h, m, with_state):
    rng = np.random.default_rng(l + h)
    r, k, v = (rng.standard_normal((b, l, h, m)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(np.clip(rng.standard_normal((b, l, h, m)) - 2.0, -8.0, 1.0))).astype(np.float32)
    u = (0.5 * rng.random((h, m))).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((b, h, m, m)) if with_state else np.zeros((b, h, m, m))).astype(np.float32)
    want_out, want_state = jax.jit(_model_wkv)(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    out, state = rwkv6_chunked(*(torch.as_tensor(a) for a in (r, k, v, w, u)),
                               torch.as_tensor(s0) if with_state else None)
    _close_scaled(out.numpy(), want_out)
    _close_scaled(state.numpy(), want_state)


def test_extreme_decay_stays_finite():
    """Decays alternating at the clamp's two ends (0.066, 0.9997) over 128
    tokens: every exponent stays inside fp32's range."""
    bh, l, m = 2, 128, 32
    ones = np.ones((bh, l, m), np.float32)
    w = np.broadcast_to(np.where(np.arange(l)[None, :, None] % 2 == 0, 0.066, 0.9997), (bh, l, m))
    w = w.astype(np.float32)
    u = np.zeros((bh, m), np.float32)
    want = np.asarray(jax_rwkv6_ref(*(jnp.asarray(a) for a in (ones, ones, ones, w, u))))
    out, state = rwkv6_chunked(*(_as_heads(a) for a in (ones, ones, ones, w)), torch.as_tensor(u))
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(state).all())
    np.testing.assert_allclose(out[0].transpose(0, 1).numpy(), want, rtol=1e-4, atol=1e-4)


def test_ops_wrapper_folds_leading_axes():
    """(..., L, H, M) with two leading axes, against the JAX wrapper; the state
    comes back with the leading axes."""
    rng = np.random.default_rng(4)
    shape = (2, 2, 50, 3, 32)
    r, v = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)
    k = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    w = (1 / (1 + np.exp(-(rng.standard_normal(shape) + 2)))).astype(np.float32)
    u = np.abs(rng.standard_normal((3, 32))).astype(np.float32)
    want = np.asarray(jax_rwkv6_attention(*(jnp.asarray(a) for a in (r, k, v, w, u)), interpret=True))
    out, state = rwkv6_attention(*(torch.as_tensor(a) for a in (r, k, v, w, u)))
    assert state.shape == (2, 2, 3, 32, 32)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5)
    # carrying the state across a split prompt gives the unsplit result
    a, s = rwkv6_attention(*(torch.as_tensor(t[:, :, :20]) for t in (r, k, v, w)), torch.as_tensor(u))
    b, s = rwkv6_attention(*(torch.as_tensor(t[:, :, 20:]) for t in (r, k, v, w)), torch.as_tensor(u), s)
    _close_scaled(torch.cat([a, b], dim=2).numpy(), out.numpy())
    _close_scaled(s.numpy(), state.numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 2, 32)
    u = torch.zeros(2, 32)
    with pytest.raises(TypeError, match="w must be float32"):
        rwkv6_chunked(x, x, x, x.bfloat16(), u)
    with pytest.raises(ValueError, match="u"):
        rwkv6_chunked(x, x, x, x, torch.zeros(3, 32))
    with pytest.raises(ValueError, match="state"):
        rwkv6_chunked(x, x, x, x, u, torch.zeros(1, 2, 32, 16))
    with pytest.raises(ValueError, match="meta"):
        rwkv6_chunked(*(t.to("meta") for t in (x, x, x, x, u)))


# ------------------------------------------------ the Hopper kernel's decomposition
def _bf16(x):
    """numpy fp32 rounded to bf16 values (the tc route's r, k, v), kept fp32."""
    return torch.as_tensor(x).bfloat16().float().numpy()


@functools.cache
def _span_case(l, with_state, m=64, dtype="bf16"):
    """r, k, v (bf16-valued for ``dtype`` "bf16", fp32 otherwise); w over the
    clamp's range; u; an optional state; and the JAX package's answers: the
    model's ``_wkv_chunked`` (out, state) and, from a zero state, the Pallas
    kernel in interpret mode."""
    b, h = 2, 3
    rng = np.random.default_rng(100 + l + m)
    rkv = (rng.standard_normal((b, l, h, m)).astype(np.float32) for _ in range(3))
    r, k, v = (_bf16(t) for t in rkv) if dtype == "bf16" else rkv
    w = np.exp(-np.exp(rng.uniform(-6.0, 1.0, (b, l, h, m)))).astype(np.float32)
    u = (0.5 * rng.random((h, m))).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((b, h, m, m)) if with_state else np.zeros((b, h, m, m))).astype(np.float32)
    want = [np.asarray(t) for t in jax.jit(_model_wkv)(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))]
    if not with_state:
        rows = lambda t: jnp.asarray(t.transpose(0, 2, 1, 3).reshape(b * h, l, m))  # noqa: E731
        pallas = jax_rwkv6_chunked(rows(r), rows(k), rows(v), rows(w), jnp.asarray(np.tile(u, (b, 1))),
                                   interpret=True)
        want.append(np.asarray(pallas).reshape(b, h, l, m).transpose(0, 2, 1, 3))
    return (r, k, v, w, u, s0 if with_state else None), want


# (M, r/k/v values): the bf16 route at M 64 as before, and the head dims and
# fp32 inputs the kernel now takes
SPAN_INPUTS = [(64, "bf16"), (64, "fp32"), (32, "bf16"), (32, "fp32"), (128, "bf16"), (128, "fp32")]


@pytest.mark.parametrize("l", [1, 33, 77, 300])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("split", [None, "bf16", "tf32"])
@pytest.mark.parametrize("m,dtype", SPAN_INPUTS)
def test_span_decomposition_matches_jax(l, with_state, split, m, dtype):
    """Phases A, B, C over spans of SPAN tokens, the products in fp32, as the
    kernel's bf16 hi + lo parts, or as the 3×TF32 alternative, against
    ``_wkv_chunked`` (out and state) and the Pallas kernel (out, zero state),
    at M 32 / 64 / 128 with bf16-valued or fp32 r, k, v."""
    args, want = _span_case(l, with_state, m, dtype)
    out, state = rwkv6_spans_ref(*(None if a is None else torch.as_tensor(a) for a in args), split=split)
    _close_scaled(out.numpy(), want[0])
    _close_scaled(state.numpy(), want[1])
    if not with_state:
        _close_scaled(out.numpy(), want[2])


@pytest.mark.parametrize("l", [1, 33, 40, 128])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("m,dtype", SPAN_INPUTS)
def test_single_span_rendering_is_the_three_phases_out(l, with_state, m, dtype):
    """L ≤ SPAN in one launch (phase C alone, carrying the state to the end):
    its out equals the three-phase rendering's bit for bit, and its state,
    summed in another order, is within 5e-5 · max|ref| of ``_wkv_chunked``'s."""
    args, want = _span_case(l, with_state, m, dtype)
    targs = [None if a is None else torch.as_tensor(a) for a in args]
    split = "bf16" if dtype == "bf16" else "tf32"  # the kernel's split for these inputs
    out3, state3 = rwkv6_spans_ref(*targs, split=split)
    out1, state1 = rwkv6_spans_ref(*targs, split=split, single_span=True)
    assert torch.equal(out1, out3)
    _close_scaled(state1.numpy(), want[1])
    _close_scaled(state1.numpy(), state3.numpy())


@pytest.mark.parametrize("split,meets", [("tf32", True), ("bf16", False)])
def test_fp32_decoder_logits_take_the_tf32_split(split, meets):
    """The reduced rwkv6-3b served in fp32 (the card-vs-CPU check: prefill
    logits to rtol 1e-4, atol 1e-5) with its time-mix through the span
    rendering: 3×TF32 products meet it, the bf16 split (which meets the
    kernel's own 5e-5 · max|ref|) does not, so fp32 r, k, v take TF32."""
    cfg = pbase.get_reduced_config(ARCH)
    params = PTF.init_params(torch.Generator().manual_seed(3), cfg, InitConfig("trunc_normal", 1.0), device="cpu")
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40)))
    want = PS.prefill(params, cfg, prompt).numpy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PR, "rwkv6_attention", lambda r, k, v, w, u, state=None: rwkv6_spans_ref(
            r, k, v, w, u, state, split=split, single_span=True))
        got = PS.prefill(params, cfg, prompt).numpy()
    assert not np.array_equal(got, want)  # the rendering ran
    assert np.allclose(got, want, **TOL) == meets


def test_single_span_rendering_refuses_two_spans():
    args, _ = _span_case(33, False)
    long = [torch.as_tensor(np.concatenate([a] * 4, axis=1)) for a in args[:4]]
    with pytest.raises(ValueError, match="single_span"):
        rwkv6_spans_ref(*long, torch.as_tensor(args[4]), single_span=True)


@pytest.mark.parametrize("split", [None, "bf16", "tf32"])
def test_span_decomposition_extreme_decay(split):
    """``test_extreme_decay_stays_finite``'s decays (0.066, 0.9997 alternating)
    at the tc route's M = 64 over 300 tokens: finite, and within 5e-5 ·
    max|ref| of the JAX oracle and the model's ``_wkv_chunked``."""
    bh, l, m = 2, 300, 64
    ones = np.ones((bh, l, m), np.float32)
    w = np.broadcast_to(np.where(np.arange(l)[None, :, None] % 2 == 0, 0.066, 0.9997), (bh, l, m))
    w = np.ascontiguousarray(w, np.float32)
    u = np.zeros((bh, m), np.float32)
    want = np.asarray(jax_rwkv6_ref(*(jnp.asarray(a) for a in (ones, ones, ones, w, u))))
    heads = [_as_heads(a) for a in (ones, ones, ones, w)]
    out, state = rwkv6_spans_ref(*heads, torch.as_tensor(u[0]).expand(bh, m), split=split)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(state).all())
    _close_scaled(out[0].transpose(0, 1).numpy(), want)
    as_model = [a.transpose(0, 1)[None].numpy() for a in map(torch.as_tensor, (ones, ones, ones, w))]
    want_out, want_state = jax.jit(_model_wkv)(*(jnp.asarray(a) for a in as_model), jnp.asarray(u),
                                               jnp.zeros((1, bh, m, m), jnp.float32))
    _close_scaled(out.numpy(), want_out)
    _close_scaled(state.numpy(), want_state)


@pytest.mark.parametrize("split,bits", [("bf16", 8), ("tf32", 11)])
def test_split_parts_keep_the_fp32_operand(split, bits):
    """hi is a value of the input type, lo the nearest one to x − hi: hi + lo
    is x to 2^-2p (p significant bits), and hi carries no bits past p."""
    scale = np.repeat(10.0 ** np.arange(-8, 8, 4), 1024)  # magnitudes 1e-8 .. 1e4
    x = torch.as_tensor((np.random.default_rng(0).standard_normal(4096) * scale).astype(np.float32))
    hi, lo = split_parts(x, split)
    assert torch.equal(split_parts(hi, split)[0], hi) and not bool(split_parts(hi, split)[1].any())
    assert bool(((x - hi).abs() <= 2.0**-bits * x.abs()).all())
    assert bool(((x.double() - hi.double() - lo.double()).abs() <= 2.0 ** (-2 * bits) * x.abs().double()).all())
    kept = hi.view(torch.int32) & ((1 << (24 - bits)) - 1)
    assert not bool(kept.any())


def test_route_takes_bf16_at_head_dim_64():
    """Every (dtype, M) goes to the Hopper kernel: bf16 r/k/v to route tc,
    fp32 to tc_fp32, at each head dim."""
    assert PK.ROUTES == ("tc", "tc_fp32")
    for m in PK.HEAD_DIMS:
        assert PK.route(torch.bfloat16, m) == "tc"
        assert PK.route(torch.float32, m) == "tc_fp32"
    assert rwkv6_chunked.launches_by_route.keys() == set(PK.ROUTES)


@pytest.mark.parametrize("b,l", [(4, 2048), (1, 512), (1, 16384), (2, 1), (2, 2049), (3, 0), (2, 40), (2, 128),
                                 (2, 129)])
@pytest.mark.parametrize("m", [32, 64, 128])
def test_scratch_sizing(b, l, m):
    """One span (L ≤ 128) runs in one launch with no scratch; a longer L
    needs one (M × M) state and one decay row per span of 128 tokens, the
    three launches' scratch, which one span can be given too."""
    h = 40
    spans = b * h * -(-l // 128) * (m * m + m)
    assert PK.span_scratch_floats(b, l, h, m) == spans
    assert PK.scratch_floats(b, l, h, m) == (0 if l <= 128 else spans)
    if (b, l, m) == (4, 2048, 64):  # states of 42.6 MB
        assert PK.scratch_floats(b, l, h, m) == 10_649_600


def test_layout_checks_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 8, 3, 64, dtype=torch.bfloat16)
    w = torch.zeros(2, 8, 3, 64)
    PK.check_layout(x, x, x, w)
    PK.check_layout(x.float(), x.float(), x.float(), w)
    shifted = torch.zeros(2 * 8 * 3 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 8, 3, 64)  # rows 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        PK.check_layout(x, shifted, x, w)
    shifted32 = torch.zeros(2 * 8 * 3 * 64 + 1)[1:].view(2, 8, 3, 64)  # fp32 rows 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        PK.check_layout(x.float(), x.float(), x.float(), shifted32)
    odd_rows = torch.zeros(2, 8, 3, 68, dtype=torch.bfloat16)[..., :64]  # rows 136 bytes apart
    with pytest.raises(ValueError, match="16-byte"):
        PK.check_layout(odd_rows, x, x, w)
    with pytest.raises(ValueError, match="M contiguous"):
        PK.check_layout(x, x, x.transpose(1, 3).contiguous().transpose(1, 3), w)
    y = torch.zeros(2, 8, 3, 32, dtype=torch.bfloat16)
    PK.check_layout(y, y, y, y.float())
    z = torch.zeros(2, 8, 3, 48)
    with pytest.raises(ValueError, match="head_dim 48"):
        PK.check_layout(z, z, z, z)


# ------------------------------------------------------------------ params
def config_pair(**changes):
    return (dataclasses.replace(jbase.get_reduced_config(ARCH), **changes),
            dataclasses.replace(pbase.get_reduced_config(ARCH), **changes))


def jax_shapes(jcfg):
    return jax.eval_shape(lambda key: JTF.init_params(key, jcfg, JInitConfig("trunc_normal")), jax.random.PRNGKey(0))


def numpy_params(jcfg, seed: int = 0, n_nodes: int | None = None):
    """A numpy tree in the JAX package's layout: dense weights normal / √fan_in,
    structured leaves drawn in their working ranges (token-shift mixes in
    (0, 1), decay base in (-6, -1), bonus in (0, 0.5)), norms perturbed."""
    rng = np.random.default_rng(seed)
    lead = (n_nodes,) if n_nodes else ()

    def draw(path, s):
        name, shape = path[-1].key, lead + s.shape
        if name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            x = 0.1 * rng.standard_normal(shape)
        elif name.startswith("mix_"):
            x = rng.random(shape)
        elif name == "decay_base":
            x = rng.uniform(-6.0, -1.0, shape)
        elif name == "bonus":
            x = 0.5 * rng.random(shape)
        else:
            x = rng.standard_normal(shape) / math.sqrt(s.shape[-2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax_shapes(jcfg))


def test_config_matches_jax():
    for getter in ("get_config", "get_reduced_config"):
        j, p = getattr(jbase, getter)(ARCH), getattr(pbase, getter)(ARCH)
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
        assert p.n_params() == j.n_params()
        assert pbase.layer_kinds(p) == jbase.layer_kinds(j) and pbase.ffn_kinds(p) == jbase.ffn_kinds(j)
        assert PTF._split_layers(p) == JTF._split_layers(j)
    assert pbase.get_config("rwkv6-3b").param_dtype == torch.bfloat16


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def test_parameter_tree_matches_jax_at_reduced_width():
    """Layout, shapes and dtypes leaf for leaf; the structured leaves (mixes,
    decay base, bonus, output layernorm, block norms) bitwise."""
    jcfg, pcfg = config_pair()
    want = JTF.init_params(jax.random.PRNGKey(0), jcfg, JInitConfig("trunc_normal", 2.0))
    mine = PTF.init_params(0, pcfg, InitConfig("trunc_normal", 2.0), device="cpu")
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    ml = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in ml] == [p for p, _ in wl]
    assert "ffn" not in mine["stack"][0] and set(mine["stack"][0]) == {"norm1", "rwkv", "norm2"}
    for (path, g), (_, w) in zip(ml, wl):
        assert tuple(g.shape) == w.shape and _dtype_name(g) == str(w.dtype), jax.tree_util.keystr(path)
        name = path[-1].key
        if name.startswith("mix_") or name in ("decay_base", "bonus", "scale", "bias"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=jax.tree_util.keystr(path))
    n = sum(int(t.numel()) for t in jax.tree_util.tree_leaves(mine))
    assert n == sum(a.size for a in jax.tree_util.tree_leaves(want))


def test_structured_leaves_bitwise_at_full_width():
    """decay_base and bonus at d = 2560 (a pow per channel), fp32 inside a
    bf16 block; the FFN width cut to keep the JAX draw small."""
    cfg_j = dataclasses.replace(jbase.get_config(ARCH), d_ff=8)
    cfg_p = dataclasses.replace(pbase.get_config(ARCH), d_ff=8)
    want = JR.init_rwkv(JInitConfig("trunc_normal"), jax.random.PRNGKey(0), cfg_j)
    mine = PR.init_rwkv(InitConfig("trunc_normal"), torch.Generator().manual_seed(0), cfg_p)
    for name in ("decay_base", "bonus", "mix_r", "mix_w"):
        g, w = mine["tmix"][name], want["tmix"][name]
        assert _dtype_name(g) == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32), err_msg=name)
    assert mine["tmix"]["decay_base"].dtype == torch.float32 and mine["tmix"]["mix_r"].dtype == torch.bfloat16


class _MetaGenerator:
    """Stands in for a generator: the tree is built on the meta device."""

    device = torch.device("meta")


def test_full_width_tree_matches_eval_shape(monkeypatch):
    """rwkv6-3b's tree (shapes and dtypes) against ``jax.eval_shape`` of the
    JAX ``init_params``, without allocating: 3,089,290,240 elements, 25 bf16
    and 4 fp32 leaves.  ``n_params()`` (the JAX package's formula) counts
    fewer, 2,852,372,480, and is left as it is."""
    monkeypatch.setattr(PC, "scaled_init",
                        lambda cfg, g, shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta"))
    jcfg, pcfg = jbase.get_config(ARCH), pbase.get_config(ARCH)
    want = jax_shapes(jcfg)
    mine = PTF.init_params(_MetaGenerator(), pcfg, InitConfig("trunc_normal"), device="meta")
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    ml = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in ml] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(ml, wl):
        assert tuple(g.shape) == w.shape and _dtype_name(g) == str(w.dtype), jax.tree_util.keystr(path)
    assert sum(int(t.numel()) for _, t in ml) == 3_089_290_240
    dtypes = [_dtype_name(t) for _, t in ml]
    assert (dtypes.count("bfloat16"), dtypes.count("float32")) == (25, 4)
    assert pcfg.n_params() == jcfg.n_params() == 2_852_372_480


# ------------------------------------------------------------------ blocks
@pytest.fixture(scope="module")
def block():
    """One reduced block's numpy params and inputs, with the JAX outputs."""
    jcfg, pcfg = config_pair()
    p = jax.tree_util.tree_map(lambda a: a[0], numpy_params(jcfg, seed=5)["stack"][0]["rwkv"])
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 45, 128)).astype(np.float32)
    prev = rng.standard_normal((2, 1, 128)).astype(np.float32)
    state = (0.2 * rng.standard_normal((2, 4, 32, 32))).astype(np.float32)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    tmix = jax.jit(JR.rwkv_time_mix, static_argnums=1)(pj["tmix"], jcfg, jnp.asarray(x), jnp.asarray(prev),
                                                       jnp.asarray(state))
    cmix = jax.jit(JR.rwkv_channel_mix)(pj["cmix"], jnp.asarray(x), jnp.asarray(prev))
    step = jax.jit(JR.rwkv_time_mix_step, static_argnums=1)(pj["tmix"], jcfg, jnp.asarray(x[:, :1]),
                                                            jnp.asarray(prev), jnp.asarray(state))
    want = {k: [np.asarray(a) for a in v] for k, v in (("tmix", tmix), ("cmix", cmix), ("step", step))}
    return pcfg, p, (x, prev, state), want


def _block_close(got, want):
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_time_mix_channel_mix_and_step_match_jax(block):
    pcfg, p, (x, prev, state), want = block
    pt = params_from_numpy(p, device="cpu")
    xt, prevt, st = map(torch.as_tensor, (x, prev, state))
    before = rwkv6_chunked.launches
    for got, w in zip(PR.rwkv_time_mix(pt["tmix"], pcfg, xt, prevt, st), want["tmix"]):
        _block_close(got, w)
    assert rwkv6_chunked.launches == before
    for got, w in zip(PR.rwkv_channel_mix(pt["cmix"], xt, prevt), want["cmix"]):
        _block_close(got, w)
    for got, w in zip(PR.rwkv_time_mix_step(pt["tmix"], pcfg, xt[:, :1], prevt, st), want["step"]):
        _block_close(got, w)


def test_cache_layout_matches_jax():
    jcfg, pcfg = config_pair()
    want = JTF.init_cache(jcfg, (2,), CACHE_LEN)
    mine = PTF.init_cache(pcfg, (2,), CACHE_LEN, device="cpu")
    wl, ml = jax.tree_util.tree_flatten_with_path(want)[0], jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in ml] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(ml, wl):
        assert tuple(g.shape) == w.shape and _dtype_name(g) == str(w.dtype), jax.tree_util.keystr(path)
    # the cache ignores cache_len: an O(1) state
    assert tree_map(lambda t: t.shape, PTF.init_cache(pcfg, (2,), 7, device="cpu")) == tree_map(
        lambda t: t.shape, mine)


# ------------------------------------------------------------------ decoder
# a 40-token prompt crosses a chunk boundary and ends ragged; 5 is shorter
# than a chunk.  3 layers: the JAX package scans its periods (n_full > 2).
DECODER_CASES = {"rwkv_40": ({}, 40), "rwkv_5": ({}, 5), "rwkv_3layers_40": ({"n_layers": 3}, 40)}


@pytest.fixture(scope="module", params=list(DECODER_CASES))
def decoder(request):
    changes, s = DECODER_CASES[request.param]
    jcfg, pcfg = config_pair(**changes)
    params = numpy_params(jcfg, seed=s)
    prompt = np.random.default_rng(s).integers(0, jcfg.vocab_size, (2, s)).astype(np.int32)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    hidden, _ = jax.jit(JTF.forward, static_argnums=1)(pj, jcfg, jnp.asarray(prompt))
    logits0, cache = jax.jit(JTF.prefill_cache, static_argnums=(1, 3))(pj, jcfg, jnp.asarray(prompt), CACHE_LEN)
    want = {"hidden": np.asarray(hidden), "prefill_logits": np.asarray(logits0),
            "prefill_cache": jax.tree_util.tree_map(np.asarray, cache), "steps": []}
    step = jax.jit(JTF.decode_step, static_argnums=1)
    tok = np.asarray(logits0).argmax(-1).astype(np.int32)[:, None]
    for i in range(N_DECODE):
        logits, cache = step(pj, jcfg, cache, jnp.asarray(tok), jnp.int32(s + i))
        want["steps"].append((tok, np.asarray(logits), jax.tree_util.tree_map(np.asarray, cache)))
        tok = np.asarray(logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
    return pcfg, params, prompt, want


def _assert_tree_close(got, want):
    """rtol 1e-4; atol 1e-5 · max(1, max|leaf|)."""
    gl, wl = jax.tree_util.tree_flatten_with_path(got)[0], jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        atol = TOL["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=TOL["rtol"], atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_forward_prefill_and_decode_match_jax(decoder):
    pcfg, params, prompt, want = decoder
    p = params_from_numpy(params, device="cpu")
    toks = torch.as_tensor(prompt)
    hidden, aux = PTF.forward(p, pcfg, toks)
    np.testing.assert_allclose(hidden.numpy(), want["hidden"], **TOL)
    assert float(aux) == 0.0
    logits0, cache = PTF.prefill_cache(p, pcfg, toks, CACHE_LEN)
    np.testing.assert_allclose(logits0.numpy(), want["prefill_logits"], **TOL)
    _assert_tree_close(params_to_numpy(cache), want["prefill_cache"])
    for i, (tok, logits_want, cache_want) in enumerate(want["steps"]):
        logits, cache = PTF.decode_step(p, pcfg, cache, torch.as_tensor(tok), prompt.shape[1] + i)
        np.testing.assert_allclose(logits.numpy(), logits_want, **TOL)
        _assert_tree_close(params_to_numpy(cache), cache_want)


# ------------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def served():
    jcfg, pcfg = config_pair()
    nodes = numpy_params(jcfg, seed=11, n_nodes=N_NODES)
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    nj = jax.tree_util.tree_map(jnp.asarray, nodes)
    cons = JS.consensus_params(nj)
    want = {
        "tokens": np.asarray(JS.generate(cons, jcfg, jnp.asarray(prompt), N_NEW, CACHE_LEN)),
        "node_tokens": np.asarray(
            JS.ServeEngine(jcfg, CACHE_LEN).serve(nj, jnp.asarray([2, 0]), jnp.asarray(prompt), N_NEW)
        ),
    }
    return pcfg, nodes, prompt, want


def test_greedy_generate_and_serve_emit_the_jax_tokens(served):
    pcfg, nodes, prompt, want = served
    ens = params_from_numpy(nodes, device="cpu")
    cons = PS.consensus_params(ens)
    engine = PS.ServeEngine(pcfg, CACHE_LEN, device="cpu")
    np.testing.assert_array_equal(PS.generate(cons, pcfg, prompt, N_NEW, CACHE_LEN, device="cpu").numpy(),
                                  want["tokens"])
    np.testing.assert_array_equal(engine.generate(cons, prompt, N_NEW).numpy(), want["tokens"])
    np.testing.assert_array_equal(engine.serve(ens, [2, 0], prompt, N_NEW).numpy(), want["node_tokens"])
    # the prefill path equals the token-wise loop through the decode step
    np.testing.assert_array_equal(
        PS.generate_tokenwise(cons, pcfg, prompt, N_NEW, CACHE_LEN, device="cpu").numpy(), want["tokens"]
    )


def test_consensus_keeps_fp32_leaves_in_a_bf16_ensemble():
    """A bf16 rwkv ensemble carries fp32 structured leaves (decay base, bonus,
    output layernorm); the average keeps every leaf's dtype and matches the
    JAX package's."""
    jcfg, pcfg = config_pair(dtype="bfloat16")
    ens = PTF.init_params(0, pcfg, InitConfig("trunc_normal", torch.tensor([1.0, 2.0, 3.0])), device="cpu")
    cons = PS.consensus_params(ens)
    assert tree_map(lambda t: t.dtype, cons) == tree_map(lambda t: t.dtype, ens)
    assert cons["stack"][0]["rwkv"]["tmix"]["decay_base"].dtype == torch.float32
    assert cons["stack"][0]["rwkv"]["tmix"]["wr"]["w"].dtype == torch.bfloat16
    as_jax = jax.tree_util.tree_map(
        lambda a, t: jnp.asarray(a, jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32),
        params_to_numpy(ens), ens)
    want = JS.consensus_params(as_jax)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(cons)), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=2.0**-7, atol=1e-6)
