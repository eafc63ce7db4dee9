"""Compressed gossip in the port against the JAX package's (``core/compress.py``,
``kernels/mix/quant.py``), on the same numpy inputs.

JAX runs jitted, as its executors run it: XLA turns the scale's division by
the constant qmax into a product with fl(1/qmax) and contracts h + q·scale
into one FMA, so the jitted codec differs from the eager one (trap checked
below).  Against the jitted form the port is bitwise: int8 / fp8 / topk /
qtopk ``encode_decode`` and every round's new mirror h'.  The mixed x' is
held at 1e-5 · max|x| (M·h' summed in another order); the Pallas kernel's
function at its own test's atol 1e-5; the 4-round trajectory at rtol 1e-4,
atol 1e-5, with quantisation-code flips (x/scale within an ulp of a
half-integer, after an ulp of summation-order drift) counted, each held to
one step of its chunk's scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import fed as JF  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.core import commplan as JC  # noqa: E402
from repro.core import compress as JCm  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.data import batch_index_schedule, mnist_like, node_datasets  # noqa: E402
from repro.kernels.mix import bsr_from_dense as jax_bsr_from_dense  # noqa: E402
from repro.kernels.mix import quantised_decavg_mix_ref as jax_quant_ref  # noqa: E402
from repro.kernels.mix import quantised_mix_bsr as jax_quant_bsr  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402
from repro_torch import fed as PF  # noqa: E402
from repro_torch import optim as PO  # noqa: E402
from repro_torch.convert import state_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import compress as PCm  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.mixing import receive_matrix  # noqa: E402
from repro_torch.flat import FlatLayout  # noqa: E402
from repro_torch.kernels.mix import (  # noqa: E402
    bsr_from_dense,
    chunk_bounds,
    pallas_bounds,
    quant_mix_bsr,
    quant_mix_dense,
    quant_scales,
    quantised_decavg_mix_ref,
    quantised_mix_bsr,
)
from repro_torch.kernels.mix import ops as mix_ops  # noqa: E402
from repro_torch.kernels.mix import quant as Q  # noqa: E402
from repro_torch.kernels.mix import mix_bsr_rows_ref  # noqa: E402
from repro_torch.kernels.mix.ref import fma_f32, quant_mix_ref, quant_scales_ref  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import paper_models as PPM  # noqa: E402

MLP_DIMS = (784, 512, 256, 128, 10)
MLP_D = 567_434


def _tree(shapes, n, rng, scale=1.0):
    """Node-stacked numpy tree; every row its own magnitude, so chunks differ."""
    return {
        k: {
            kk: (rng.standard_normal((n, *s)) * rng.uniform(0.01, 5.0, size=(n,) + (1,) * len(s)) * scale)
            .astype(np.float32)
            for kk, s in v.items()
        }
        for k, v in shapes.items()
    }


def _mlp_shapes(dims=MLP_DIMS):
    return {f"fc{i}": {"w": (a, b), "b": (b,)} for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}


SMALL = {"fc0": {"w": (20, 33), "b": (33,)}, "fc1": {"w": (33, 7), "b": (7,)}, "tail": {"one": (1,)}}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(torch.as_tensor, tree)


def _pairs(want, got):
    return zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got))


def _assert_bitwise(want, got):
    for a, b in _pairs(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _assert_close_x(want, got, x):
    atol = 1e-5 * max(float(np.abs(a).max()) for a in jax.tree_util.tree_leaves(x))
    for a, b in _pairs(want, got):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), rtol=0, atol=atol)


# ------------------------------------------------------------- configuration
def test_compression_validation_matches_jax():
    for kw in (dict(codec="lz4"), dict(codec="int8", chunk=0), dict(codec="int8", chunk=1 << 17),
               dict(codec="topk", topk_frac=0.0), dict(codec="topk", topk_frac=1.5),
               dict(codec="int8", gamma=0.0), dict(codec="int8", gamma=1.2)):
        with pytest.raises(ValueError):
            JCm.Compression(**kw)
        with pytest.raises(ValueError):
            PCm.Compression(**kw)
    assert not PCm.Compression().active and PCm.Compression(codec="fp8").active
    assert PCm.CODECS == JCm.CODECS


@pytest.mark.parametrize("codec", ["none", "int8", "fp8", "topk", "qtopk"])
@pytest.mark.parametrize("chunk,frac", [(100, 0.1), (64, 0.25), (2048, 0.1), (1000, 0.3)])
def test_wire_bytes_match_jax(codec, chunk, frac):
    j = JCm.Compression(codec=codec, chunk=chunk, topk_frac=frac)
    p = PCm.Compression(codec=codec, chunk=chunk, topk_frac=frac)
    for elems in (0, 1, 3, 63, 64, 65, 103, 250, 1280, 401_408):
        assert p.topk_count(max(elems, 1)) == j.topk_count(max(elems, 1))
        assert p.leaf_row_bytes(elems, np.float32) == j.leaf_row_bytes(elems, np.float32)
        assert p.leaf_row_bytes(elems, torch.float32) == j.leaf_row_bytes(elems, np.float32)
        assert p.leaf_row_bytes(elems, torch.bfloat16) == j.leaf_row_bytes(elems, jnp.bfloat16)


def test_paper_mlp_row_bytes_and_chunk_table():
    comp = PCm.Compression(codec="int8")
    sizes = [a * b for a, b in zip(MLP_DIMS[:-1], MLP_DIMS[1:])] + list(MLP_DIMS[1:])
    row = sum(comp.leaf_row_bytes(s, np.float32) for s in sizes)
    assert row == 567_434 + 281 * 4 == 568_558
    assert round(4 * MLP_D / row, 3) == 3.992
    layout = FlatLayout.of(_torch({k: {kk: np.zeros((1, *s), np.float32) for kk, s in v.items()}
                                   for k, v in _mlp_shapes().items()}))
    bounds = chunk_bounds(layout.sizes, 2048)
    assert bounds.numel() - 1 == 281 and int(bounds[-1]) == MLP_D
    assert layout.sizes == (512, 401_408, 256, 131_072, 128, 32_768, 10, 1_280)
    lengths = (bounds[1:] - bounds[:-1]).tolist()
    assert max(lengths) == 2048 and min(lengths) == 10 and sorted(set(lengths)) == [10, 128, 256, 512, 1280, 2048]
    assert pallas_bounds(190, 64).tolist() == [0, 64, 128, 190]
    assert pallas_bounds(100).tolist() == [0, 100]


# --------------------------------------------------------------------- codecs
@pytest.mark.parametrize("codec", ["int8", "fp8", "topk", "qtopk"])
def test_encode_decode_mlp_tree_bitwise(codec):
    """The paper MLP's leaves (per-leaf chunks, 281 a row) through both codecs."""
    tree = _tree(_mlp_shapes(), 3, np.random.default_rng(1))
    comp = dict(codec=codec, chunk=2048, topk_frac=0.3)
    want = jax.jit(lambda t: JCm.encode_decode(t, JCm.Compression(**comp)))(_jax(tree))
    got = PCm.encode_decode(_torch(tree), PCm.Compression(**comp))
    _assert_bitwise(want, got)
    # the flat buffer with its layout gives the same numbers
    layout = FlatLayout.of(_torch(tree))
    flat = PCm.encode_decode(layout.flatten(_torch(tree)), PCm.Compression(**comp), layout)
    _assert_bitwise(want, layout.views(flat))


def test_jitted_and_eager_jax_codecs_differ():
    """Trap 1: the port follows the jitted codec, which eager JAX does not."""
    tree = _tree(SMALL, 6, np.random.default_rng(0))
    comp = JCm.Compression(codec="int8", chunk=64)
    jitted = jax.jit(lambda t: JCm.encode_decode(t, comp))(_jax(tree))
    eager = JCm.encode_decode(_jax(tree), comp)
    assert any(np.any(np.asarray(a) != np.asarray(b)) for a, b in _pairs(jitted, eager))
    _assert_bitwise(jitted, PCm.encode_decode(_torch(tree), PCm.Compression(codec="int8", chunk=64)))


EDGE_ROWS = {
    "all_zero_chunk": lambda x: x.__setitem__((0, slice(0, 64)), 0.0),
    "absmax_1e-29": lambda x: x.__setitem__((1, slice(64, 128)), x[1, 64:128] / np.abs(x[1, 64:128]).max() * 1e-29),
    "uniform_rows": lambda x: x.__setitem__((2, slice(None)), np.where(np.arange(x.shape[1]) % 3, 1.0, -1.0)),
}


@pytest.mark.parametrize("codec", ["int8", "fp8", "topk", "qtopk"])
@pytest.mark.parametrize("chunk", [64, 1000])
def test_encode_decode_edge_cases(codec, chunk):
    """An all-zero chunk, a chunk of absmax 1e-29 (the codec's floor and the
    Pallas one differ there), a one-element leaf, a leaf shorter than the
    chunk, and a chunk that is not a power of two."""
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 2300)).astype(np.float32), "b": rng.standard_normal((4, 1)).astype(np.float32),
            "c": rng.standard_normal((4, 37)).astype(np.float32)}
    for edit in EDGE_ROWS.values():
        edit(tree["a"])
    comp = dict(codec=codec, chunk=chunk, topk_frac=0.25)
    want = jax.jit(lambda t: JCm.encode_decode(t, JCm.Compression(**comp)))(_jax(tree))
    got = PCm.encode_decode(_torch(tree), PCm.Compression(**comp))
    _assert_bitwise(want, got)
    assert np.all(got["a"][0, :64].numpy() == 0.0)


def test_topk_ties_go_to_the_lower_index():
    x = np.zeros((2, 40), np.float32)
    x[0, [3, 9, 17, 30]] = [2.0, -2.0, 2.0, -2.0]  # four equal magnitudes, keep 2 of each 20-chunk
    x[1] = np.tile([1.0, -1.0, 0.5, 1.0], 10)
    for codec in ("topk", "qtopk"):
        comp = dict(codec=codec, chunk=20, topk_frac=0.1)
        want = jax.jit(lambda t: JCm.encode_decode(t, JCm.Compression(**comp)))({"x": jnp.asarray(x)})
        got = PCm.encode_decode({"x": torch.as_tensor(x)}, PCm.Compression(**comp))
        _assert_bitwise(want, got)
    kept = np.nonzero(got["x"][0].numpy())[0].tolist()
    assert kept == [3, 9, 30]  # 3 and 9 of the first chunk's 3, 9, 17; 30 alone in the second


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.integers(-127, 128, 200_000).astype(np.float32))
    s = torch.as_tensor((rng.random(200_000) * 1e-2).astype(np.float32))
    h = torch.as_tensor(rng.standard_normal(200_000).astype(np.float32))
    exact = q.double() * s.double() + h.double()
    got = fma_f32(q, s, h)
    # correctly rounded: no fp32 value lies closer to the exact sum
    err = (got.double() - exact).abs()
    for way in (float("inf"), -float("inf")):
        nb = torch.nextafter(got, torch.full_like(got, way))
        assert torch.all(err <= (nb.double() - exact).abs())
    # the float64 sum lands on an fp32 midpoint the exact sum is past:
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24, plus 2^-60
    a = torch.tensor([1.0 + 2.0**-12], dtype=torch.float32)
    tiny = torch.tensor([2.0**-60], dtype=torch.float32)
    assert float((a.double() * a.double() + tiny.double()).float()) == 1.0 + 2.0**-11  # ties to even
    assert float(fma_f32(a, a, tiny)) == 1.0 + 2.0**-11 + 2.0**-23
    assert float(fma_f32(a, a, -tiny)) == 1.0 + 2.0**-11


# ------------------------------------------------------------ one round
def _round_inputs(n, seed):
    rng = np.random.default_rng(seed)
    return _tree(SMALL, n, rng), _tree(SMALL, n, rng, scale=0.7)


ROUND_CASES = [
    (codec, backend, masked, ef, gamma, stream)
    for codec in ("int8", "fp8")
    for backend in ("dense", "sparse")
    for masked in (False, True)
    for ef, gamma, stream in ((True, 1.0, False), (True, 0.5, True), (False, 1.0, False), (False, 0.5, True))
] + [
    (codec, backend, masked, True, 0.3, False)
    for codec in ("topk", "qtopk") for backend in ("dense", "sparse") for masked in (False, True)
]


@pytest.mark.parametrize("codec,backend,masked,ef,gamma,stream", ROUND_CASES)
def test_compressed_round_matches_jax(codec, backend, masked, ef, gamma, stream):
    n = 12
    gj, gp = JT.random_k_regular(n, 4, seed=1), PT.random_k_regular(n, 4, seed=1)
    pj, pp = JC.compile_plan(gj, backend), PC.compile_plan(gp, backend, device="cpu")
    x, h = _round_inputs(n, seed=hash((codec, backend, masked)) % 1000)
    kw = dict(codec=codec, chunk=64, topk_frac=0.25, gamma=gamma, error_feedback=ef, stream=stream)
    cj, cp = JCm.Compression(**kw), PCm.Compression(**kw)
    rng = np.random.default_rng(7)
    active = rng.random(n) < 0.75 if masked else None
    edge_live = rng.random(pj.n_edges) < 0.6 if masked else None

    @jax.jit
    def jround(x, h, active, edge_live):
        return JCm.compressed_mix(pj, x, h, compression=cj, active=active, edge_live=edge_live)

    xj, hj = jround(_jax(x), _jax(h), None if active is None else jnp.asarray(active),
                    None if edge_live is None else jnp.asarray(edge_live))
    xp, hp = pp.mix(_torch(x), compression=cp, residual=_torch(h),
                    active=None if active is None else torch.as_tensor(active),
                    edge_live=None if edge_live is None else torch.as_tensor(edge_live))
    _assert_bitwise(hj, hp)
    _assert_close_x(xj, xp, x)
    # the flat buffer of the training path, its layout naming the leaves
    layout = FlatLayout.of(_torch(x))
    xf, hf = pp.mix(layout.flatten(_torch(x)), compression=cp, residual=layout.flatten(_torch(h)), layout=layout,
                    active=None if active is None else torch.as_tensor(active),
                    edge_live=None if edge_live is None else torch.as_tensor(edge_live))
    _assert_bitwise(hj, layout.views(hf))
    _assert_close_x(xj, layout.views(xf), x)
    if backend == "sparse" and codec in ("int8", "fp8"):
        # the quantised round on the CUDA walk's rendering of M·H'
        op = pp.round_operator(active=None if active is None else torch.as_tensor(active),
                               edge_live=None if edge_live is None else torch.as_tensor(edge_live))
        xt, ht = layout.flatten(_torch(x)), layout.flatten(_torch(h))
        h_in = ht if ef else None
        bounds = chunk_bounds(layout.sizes, 64)
        scales = quant_scales_ref(xt, h_in, bounds, codec=codec, error_feedback=ef)
        xr, hr = quant_mix_ref(lambda hq: mix_bsr_rows_ref(*op, hq), xt, h_in, bounds, scales, codec=codec,
                               gamma=gamma, error_feedback=ef)
        _assert_bitwise(hj, layout.views(hr))
        _assert_close_x(xj, layout.views(xr), x)


SPREAD_CASES = [
    (codec, backend, masked, ef)
    for codec in ("int8", "fp8", "topk", "qtopk")
    for backend in ("dense", "sparse")
    for masked, ef in ((False, True), (True, True), (True, False))
]


@pytest.mark.parametrize("codec,backend,masked,ef", SPREAD_CASES)
def test_compressed_spread_matches_jax(codec, backend, masked, ef):
    """The send form (``CommPlan.spread(compression=)``) over Mᵀ against the
    JAX package's jitted ``compressed_spread``: h' bitwise, v' to 1e-5 ·
    max|v|, and the payload's total conserved (γ (Mᵀ h' − h') sums to 0)."""
    n, k = 14, 3
    gj, gp = JT.barabasi_albert(n, 2, seed=3), PT.barabasi_albert(n, 2, seed=3)
    pj, pp = JC.compile_plan(gj, backend), PC.compile_plan(gp, backend, device="cpu")
    rng = np.random.default_rng(len(codec) + 3 * masked + ef)
    v = (rng.standard_normal((n, k)) * rng.uniform(0.1, 4.0, (n, 1))).astype(np.float32)
    h = (0.5 * rng.standard_normal((n, k))).astype(np.float32)
    kw = dict(codec=codec, chunk=2, topk_frac=0.5, gamma=0.5, error_feedback=ef)
    active = rng.random(n) < 0.75 if masked else None
    edge_live = rng.random(pj.n_edges) < 0.6 if masked else None

    @jax.jit
    def jspread(v, h, active, edge_live):
        return JCm.compressed_spread(pj, v, h, compression=JCm.Compression(**kw), active=active, edge_live=edge_live)

    vj, hj = jspread(jnp.asarray(v), jnp.asarray(h), None if active is None else jnp.asarray(active),
                     None if edge_live is None else jnp.asarray(edge_live))
    vp, hp = pp.spread(torch.as_tensor(v), compression=PCm.Compression(**kw), residual=torch.as_tensor(h),
                       active=None if active is None else torch.as_tensor(active),
                       edge_live=None if edge_live is None else torch.as_tensor(edge_live))
    np.testing.assert_array_equal(hp.numpy(), np.asarray(hj))
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=0, atol=1e-5 * float(np.abs(v).max()))
    np.testing.assert_allclose(vp.numpy().sum(0), v.sum(0), rtol=1e-5, atol=1e-5)
    # a 1-D payload keeps its shape; no residual means zero mirrors
    v1, h1 = PCm.compressed_spread(pp, torch.as_tensor(v[:, 0]), None, compression=PCm.Compression(**kw))
    assert v1.shape == h1.shape == (n,)
    np.testing.assert_allclose(float(v1.sum()), float(v[:, 0].sum()), rtol=1e-5, atol=1e-5)


def test_compressed_spread_conserves_mass_under_failure_draws():
    plan = PC.compile_plan(PT.configuration_heavy_tail(40, 2.2, seed=0), "sparse",
                           failures=PC.FailureModel(link_p=0.5, node_p=0.7), device="cpu")
    v = torch.as_tensor(np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32))
    h = torch.zeros_like(v)
    for r in range(6):
        v, h = plan.spread(v, torch.Generator().manual_seed(r), compression=PCm.Compression("int8", chunk=3),
                           residual=h)
    np.testing.assert_allclose(v.sum(0).numpy(), np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
                               .sum(0), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="Generator"):
        plan.spread(v, compression=PCm.Compression("int8"), residual=h)


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_update_mask_freezes_mirrors_as_jax(codec):
    n = 10
    pj, pp = JC.compile_plan(JT.ring(n)), PC.compile_plan(PT.ring(n), device="cpu")
    x, h = _round_inputs(n, seed=4)
    mask = np.arange(n) % 3 != 0
    kw = dict(codec=codec, chunk=64, topk_frac=0.25)
    xj, hj = jax.jit(lambda x, h, m: JCm.compressed_mix(pj, x, h, compression=JCm.Compression(**kw), update_mask=m))(
        _jax(x), _jax(h), jnp.asarray(mask))
    xp, hp = PCm.compressed_mix(pp, _torch(x), _torch(h), compression=PCm.Compression(**kw),
                                update_mask=torch.as_tensor(mask))
    _assert_bitwise(hj, hp)
    _assert_close_x(xj, xp, x)
    np.testing.assert_array_equal(hp["fc0"]["w"].numpy()[~mask], h["fc0"]["w"][~mask])
    # the generic form around any mixing function gives the same round
    xg, hg = PCm.compressed_mix_with(pp.mix, _torch(x), _torch(h), PCm.Compression(**kw),
                                     update_mask=torch.as_tensor(mask))
    _assert_bitwise(hj, hg)
    _assert_close_x(xj, xg, x)


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_codec_none_is_the_raw_operator(backend):
    plan = PC.compile_plan(PT.random_k_regular(8, 4, seed=3), backend, failures=PC.FailureModel(link_p=0.7),
                           device="cpu")
    x, h = _round_inputs(8, seed=5)
    xt, ht = _torch(x), _torch(h)
    ref = plan.mix(xt, torch.Generator().manual_seed(2))
    # CommPlan.mix returns the raw round alone, as the JAX package's does
    out = plan.mix(xt, torch.Generator().manual_seed(2), compression=PCm.Compression(), residual=ht)
    _assert_bitwise(jax.tree_util.tree_map(lambda t: t.numpy(), ref), out)
    out, h3 = PCm.compressed_mix(plan, xt, ht, torch.Generator().manual_seed(2), compression=PCm.Compression())
    _assert_bitwise(jax.tree_util.tree_map(lambda t: t.numpy(), ref), out)
    assert h3 is ht


def test_failure_draw_consumed_once_per_round():
    """A compressed round draws the failure masks once, as a raw round does,
    so a generator stays in step whichever the codec."""
    plan = PC.compile_plan(PT.random_k_regular(16, 4, seed=0), failures=PC.FailureModel(0.6, 0.8), device="cpu")
    x = torch.randn(16, 300, generator=torch.Generator().manual_seed(0))
    g_raw, g_c = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    plan.mix(x, g_raw)
    xc, hc = plan.mix(x, g_c, compression=PCm.Compression(codec="int8", chunk=64))
    assert torch.equal(g_raw.get_state(), g_c.get_state())
    # with an exact-at-uniform-rows input the compressed round IS the raw one
    u = torch.where(torch.arange(300) % 2 == 0, 1.0, -1.0).expand(16, 300).contiguous() * 3.0
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    raw = plan.mix(u, g1)
    comp, _ = plan.mix(u, g2, compression=PCm.Compression(codec="int8", chunk=64))
    torch.testing.assert_close(comp, raw, atol=1e-6, rtol=0)


def test_kernel_entries_on_cpu_agree():
    """The kernel wrappers take the plain path on CPU tensors: the dense and
    BSR round entries agree, the dense round returns the scales
    ``quant_scales`` gives, and ``quant_scales`` is the codec's scale."""
    g = PT.ring(40)
    m = receive_matrix(g).astype(np.float32)
    bc, tiles, counts = (torch.as_tensor(a) for a in bsr_from_dense(m, 8))
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((40, 300)).astype(np.float32))
    h = torch.as_tensor(rng.standard_normal((40, 300)).astype(np.float32) * 0.3)
    bounds = chunk_bounds((100, 7, 193), 64)
    edges = tuple(bounds.tolist())
    for codec in ("int8", "fp8"):
        s = quant_scales(x, h, bounds, codec=codec)
        (xd, hd), sd = quant_mix_dense(torch.as_tensor(m), x, h, edges, codec=codec, gamma=0.5)
        assert torch.equal(sd, s)
        xb, hb = quant_mix_bsr(bc, tiles, counts, x, h, bounds, s, codec=codec, gamma=0.5)
        assert torch.equal(hd, hb)
        torch.testing.assert_close(xd, xb, atol=1e-5 * float(x.abs().max()), rtol=0)
        with pytest.raises(ValueError, match="raw mode"):
            quant_mix_dense(torch.as_tensor(m), x, h, edges, codec=codec)
    with pytest.raises(ValueError):
        quant_scales(x, h, bounds, codec="zstd")
    with pytest.raises(ValueError):
        quant_scales(x, h, bounds, codec="int8", floor="other")


# ------------------------------------------------ the dense round's tile table
MLP_SIZES = (512, 401_408, 256, 131_072, 128, 32_768, 10, 1_280)  # FlatLayout order of the paper MLP's leaves


@pytest.mark.parametrize(
    "n,edges,itemsize,route",
    [
        (16, ("mlp", 2048), 4, "staged"),
        (64, ("mlp", 2048), 4, "staged"),
        (1, ("mlp", 2048), 4, "staged"),
        (16, ("mlp", 2048), 2, "staged"),
        (16, ("pallas", 512), 4, "staged"),
        (64, ("pallas", 512), 2, "staged"),
        (16, ("mlp", 65536), 4, "wide"),
        (64, ("leaves", (3 * 65536 + 7,), 65536), 4, "wide"),
        (16, ("leaves", (20_001,), 2048), 4, "staged"),
        (33, ("leaves", (500, 1, 300, 201), 64), 2, "staged"),
        (16, ("leaves", (97,), 1), 4, "staged"),
        (200, ("leaves", (3000,), 256), 4, "staged"),
        (200, ("leaves", (5000,), 4096), 2, "wide"),
    ],
    ids=["mlp-n16", "mlp-n64", "mlp-n1", "mlp-n16-bf16", "pallas-n16", "pallas-n64-bf16", "mlp-chunk65536",
         "wide-n64", "odd-d", "leaf-table-n33", "one-column-chunks", "n200", "n200-wide"],
)
def test_tile_plan_covers_the_table(n, edges, itemsize, route):
    """Every column in exactly one tile, in order; tile boundaries on chunk
    boundaries; a tile at most ``tile_chunks`` whole chunks and a cluster's
    staged columns, or one wider chunk (the wide route); the kernel's
    shared memory within a block's."""
    if edges[0] == "mlp":
        table = chunk_bounds(MLP_SIZES, edges[1]).tolist()
    elif edges[0] == "pallas":
        table = pallas_bounds(MLP_D, edges[1]).tolist()
    else:
        table = chunk_bounds(edges[1], edges[2]).tolist()
    plan = Q.plan_tiles(table, n, itemsize)
    assert plan.route == route
    assert plan.cluster in (1, 2, 4, 8) and plan.cols >= 1 and 1 <= plan.tile_chunks <= 16
    assert Q.round_smem_bytes(n, plan.cols, plan.tile_chunks, itemsize) <= Q.SMEM_LIMIT
    col, chunk, wide = 0, 0, 0
    for lo, hi, j_lo, j_hi in plan.tiles:
        assert (lo, j_lo) == (col, chunk) and j_hi > j_lo
        assert (table[j_lo], table[j_hi]) == (lo, hi)
        if hi - lo > plan.cluster * plan.cols:
            assert j_hi - j_lo == 1
            wide += 1
        else:
            assert j_hi - j_lo <= plan.tile_chunks
        col, chunk = hi, j_hi
    assert (col, chunk) == (table[-1], len(table) - 1)
    assert (wide > 0) == (route == "wide")
    # one cached plan per chunk table, row count, dtype and device
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    got, tiles = Q.tile_plan(tuple(table), n, dtype, torch.device("cpu"))
    assert got == plan and Q.tile_plan(tuple(table), n, dtype, torch.device("cpu"))[1] is tiles
    assert tiles.dtype == torch.int64 and tiles.tolist() == [list(t) for t in plan.tiles]


def test_tile_plan_groups_the_mlp_bias_chunks():
    """The MLP table at n = 16: one 2048-column chunk a tile, a cluster of
    eight CTAs on 256 columns each; the bias chunks (512, 256, 128, 10
    columns) and fc3's 1280 share tiles where they fit."""
    table = chunk_bounds(MLP_SIZES, 2048).tolist()
    plan = Q.plan_tiles(table, 16, 4)
    assert (plan.cluster, plan.cols) == (8, 256)
    assert len(plan.tiles) < len(table) - 1
    assert any(j_hi - j_lo > 1 for _, _, j_lo, j_hi in plan.tiles)
    with pytest.raises(ValueError, match="sparse backend"):
        Q.plan_tiles(table, 20_000, 4)


@pytest.mark.parametrize(
    "edges,match",
    [((0, 64, 299), "ends at column 299"), ((0, 64, 301), "ends at column 301"), ((1, 64, 300), "rise from 0"),
     ((0, 200, 100, 300), "rise from 0"), ((0,), "rise from 0"), ((), "rise from 0")],
    ids=["short", "long", "offset", "falling", "no-chunk", "empty"],
)
def test_dense_round_takes_one_table_that_covers_x(edges, match):
    """The dense round's chunk table is one list of host ints: its device
    copy (``table_bounds``) is made from it, once per table and device, and
    a table that does not rise from 0 to X's last column is refused before
    anything is computed."""
    x = torch.zeros(4, 300)
    m = torch.eye(4)
    with pytest.raises(ValueError, match=match):
        quant_mix_dense(m, x, x, edges, codec="int8", gamma=1.0)
    good = (0, 64, 300)
    assert Q.table_bounds(good, x.device) is Q.table_bounds(good, x.device)
    assert Q.table_bounds(good, x.device).tolist() == list(good)
    sizes = (100, 7, 193)
    assert PCm._bounds(sizes, 64, x.device) is Q.table_bounds(PCm._edges(sizes, 64), x.device)
    assert PCm._edges(sizes, 64) == tuple(chunk_bounds(sizes, 64).tolist())


DENSE_ROUND_CASES = [(codec, gamma, ef, masked) for codec in ("int8", "fp8")
                     for gamma, ef, masked in ((1.0, True, False), (0.5, True, True), (0.5, False, False),
                                               (1.0, False, True))]


@pytest.mark.parametrize("codec,gamma,ef,masked", DENSE_ROUND_CASES)
def test_dense_round_on_cpu_matches_jitted_jax(codec, gamma, ef, masked):
    """``quant_mix_dense`` on CPU tensors: the scales it returns are
    ``quant_scales_ref``'s, and its round is the jitted JAX
    ``compressed_mix`` (h' bitwise, x' to 1e-5 · max|x|)."""
    n, d, chunk = 16, 700, 128
    rng = np.random.default_rng(11)
    x = {"w": (rng.standard_normal((n, d)) * rng.uniform(0.01, 5.0, size=(n, 1))).astype(np.float32)}
    h = {"w": (0.3 * rng.standard_normal((n, d))).astype(np.float32)}
    mask = np.arange(n) % 3 != 1 if masked else None
    kw = dict(codec=codec, chunk=chunk, gamma=gamma, error_feedback=ef)
    pj = JC.compile_plan(JT.complete(n), "dense")
    xj, hj = jax.jit(lambda x, h, m: JCm.compressed_mix(pj, x, h, compression=JCm.Compression(**kw), update_mask=m))(
        _jax(x), _jax(h), None if mask is None else jnp.asarray(mask))
    m = PC.compile_plan(PT.complete(n), "dense", device="cpu").receive
    xt, ht = torch.as_tensor(x["w"]), torch.as_tensor(h["w"])
    bounds = chunk_bounds((d,), chunk)
    h_in = ht if (ef or masked) else None
    keep = None if mask is None else torch.as_tensor(mask)
    (xp, hp), scales = quant_mix_dense(m, xt, h_in, tuple(bounds.tolist()), codec=codec, gamma=gamma,
                                       error_feedback=ef, keep=keep)
    assert torch.equal(scales, quant_scales_ref(xt, h_in, bounds, codec=codec, error_feedback=ef and h_in is not None))
    np.testing.assert_array_equal(hp.numpy(), np.asarray(hj["w"]))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj["w"]), rtol=0, atol=1e-5 * float(np.abs(x["w"]).max()))


# ------------------------------------------------ kernel 3: M·Q(W), Pallas
@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("family", ["ring", "kregular", "ba", "complete"])
def test_quantised_mix_bsr_matches_pallas(codec, family):
    """The JAX test's cases (tests/test_compress.py): 40 nodes, d 190,
    block_d 64, bn 8, against the Pallas kernel (interpret) and its oracle."""
    build = {
        "ring": lambda T: T.ring(40),
        "kregular": lambda T: T.random_k_regular(40, 4, seed=0),
        "ba": lambda T: T.barabasi_albert(40, 3, seed=0),
        "complete": lambda T: T.complete(40),
    }[family]
    m = receive_matrix(build(PT)).astype(np.float32)
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(40, 190)) * rng.uniform(0.01, 8, size=(40, 1))).astype(np.float32)
    jbc, jtiles = jax_bsr_from_dense(m, 8)
    pallas = jax_quant_bsr(jnp.asarray(jbc), jnp.asarray(jtiles), jnp.asarray(w), codec=codec, block_d=64,
                           interpret=True)
    oracle = jax_quant_ref(jnp.asarray(m), jnp.asarray(w), codec=codec, block_d=64)
    bc, tiles, counts = (torch.as_tensor(a) for a in bsr_from_dense(m, 8))
    got = quantised_mix_bsr(bc, tiles, counts, torch.as_tensor(w), codec=codec, block_d=64)
    plain = quantised_decavg_mix_ref(torch.as_tensor(m), torch.as_tensor(w), codec=codec, block_d=64)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=1e-5)


def test_quantised_mix_bsr_bf16_and_floor():
    """bf16 W gives bf16 Y (one rounding of the fp32 sum); under the Pallas
    floor a chunk of absmax 1e-29 quantises on the 1e-30 grid."""
    m = receive_matrix(PT.ring(16)).astype(np.float32)
    rng = np.random.default_rng(8)
    w = rng.standard_normal((16, 130)).astype(np.float32)
    w[3, :64] *= 1e-29 / np.abs(w[3, :64]).max()
    jbc, jtiles = jax_bsr_from_dense(m, 8)
    bc, tiles, counts = (torch.as_tensor(a) for a in bsr_from_dense(m, 8))
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 3e-2)):
        wt = torch.as_tensor(w).to(dtype)
        pallas = jax_quant_bsr(jnp.asarray(jbc), jnp.asarray(jtiles), jnp.asarray(w).astype(jdtype), block_d=64,
                               interpret=True)
        got = quantised_mix_bsr(bc, tiles, counts, wt, block_d=64)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas, np.float32), atol=tol, rtol=tol)
    scales = quant_scales(torch.as_tensor(w), None, pallas_bounds(130, 64), codec="int8", floor="pallas")
    assert float(scales[3, 0]) == np.float32(1e-30)
    codec_scale = quant_scales(torch.as_tensor(w), None, pallas_bounds(130, 64), codec="int8")[3, 0]
    assert float(codec_scale) == float(np.float32(np.float32(1e-29) * np.float32(1 / 127)))


def test_quantised_kernel_exact_at_uniform_rows():
    m = receive_matrix(PT.ring(16)).astype(np.float32)
    w = np.tile(np.asarray([1.0, -1.0, 1.0, 1.0], np.float32), (16, 32))
    bc, tiles, counts = (torch.as_tensor(a) for a in bsr_from_dense(m, 8))
    got = quantised_mix_bsr(bc, tiles, counts, torch.as_tensor(w), block_d=64)
    np.testing.assert_allclose(got.numpy(), m @ w, atol=1e-6)


# ------------------------------------------------------------- trajectory
N_T, PER_T, ROUNDS_T, B_T, HIDDEN_T = 6, 32, 4, 2, (16,)


@pytest.fixture(scope="module")
def compressed_runs():
    """make_round_fn(compression=int8, chunk 256) + run_trajectory on ring-6,
    from one injected init, in both packages (tests/test_compress.py's
    integration case)."""
    ds = mnist_like(N_T * PER_T + 64, seed=0)
    xs, ys = node_datasets(ds, [np.arange(i * PER_T, (i + 1) * PER_T) for i in range(N_T)])
    test = (ds.x[-64:], ds.y[-64:])
    sched = batch_index_schedule(PER_T, N_T, 8, ROUNDS_T * B_T, seed=0)
    rng = np.random.default_rng(0)
    dims = (784, *HIDDEN_T, 10)
    params = {
        f"fc{i}": {"w": (rng.standard_normal((N_T, a, b)) * np.sqrt(2.0 / a) * 2.0).astype(np.float32),
                   "b": np.zeros((N_T, b), np.float32)}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
    }
    opt_j, opt_t = JO.sgd(1e-3, 0.5), PO.sgd(1e-3, 0.5)
    common = dict(n_rounds=ROUNDS_T, eval_every=1, eval_batch=test, track_sigmas=True, b_local=B_T)

    def jloss(p, b):
        return JPM.classifier_loss(JPM.mlp_forward(p, b[0]), b[1])

    def tloss(p, b):
        return PPM.classifier_loss(PPM.mlp_forward(p, b[0]), b[1])

    jp = _jax(params)
    s_j = JF.DFLState(params=jp, opt_state=jax.vmap(opt_j.init)(jp), round=jnp.zeros((), jnp.int32),
                      rng=jax.random.PRNGKey(0))
    comp = dict(codec="int8", chunk=256)
    rf_j = JF.make_round_fn(jloss, opt_j, JC.compile_plan(JT.ring(N_T)), compression=JCm.Compression(**comp))
    fin_j, h_j = JF.run_trajectory(s_j, rf_j, xs, ys, sched, eval_fn=JF.make_eval_fn(jloss), **common)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    s_t = state_from_numpy(params, optimizer=opt_t, device="cpu")
    rf_t = PF.make_round_fn(tloss, opt_t, PC.compile_plan(PT.ring(N_T), device="cpu"),
                            compression=PCm.Compression(**comp))
    scales = []  # every round's (n, C) scales, as the dense round returns them: a code step is one of them

    def recording_round(*args, **kw):
        out, round_scales = quant_mix_dense(*args, **kw)
        scales.append(round_scales)
        return out, round_scales

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mix_ops, "quant_mix_dense", recording_round)
        fin_t, h_t = PF.run_trajectory(s_t, rf_t, xs, ys, sched, eval_fn=PF.make_eval_fn(tloss), device="cpu",
                                       **common)
    assert len(scales) == ROUNDS_T
    rf_raw = PF.make_round_fn(tloss, opt_t, PC.compile_plan(PT.ring(N_T), device="cpu"))
    fin_raw, _ = PF.run_trajectory(s_t, rf_raw, xs, ys, sched, device="cpu", n_rounds=ROUNDS_T, b_local=B_T)
    # one code step per column: the largest scale of its chunk over rows and
    # rounds (a flipped code in row j moves row j's h' and, through M and γ
    # ≤ 1, its neighbours' x' by at most that step)
    col = torch.repeat_interleave(torch.arange(scales[0].shape[1]),
                                  (lambda b: b[1:] - b[:-1])(chunk_bounds(fin_t.layout.sizes, 256)))
    step = torch.stack(scales).amax(dim=(0, 1))[col]
    return dict(jax=(to_np(fin_j.params), to_np(fin_j.residual), h_j), torch=(fin_t, h_t), raw=fin_raw,
                step=fin_t.layout.views(step.expand(N_T, -1).contiguous()),
                init=s_t, round_fn=rf_t, data=(xs, ys, sched))


def test_compressed_trajectory_matches_jax(compressed_runs):
    params_j, resid_j, h_j = compressed_runs["jax"]
    fin_t, h_t = compressed_runs["torch"]
    assert h_t["round"] == h_j["round"] == list(range(ROUNDS_T))
    for k in ("train_loss", "test_loss", "sigma_ap", "sigma_an"):
        np.testing.assert_allclose(h_t[k], h_j[k], rtol=1e-4, atol=1e-5, err_msg=k)
    params_t, _, resid_t = to_numpy(fin_t, residual=True)
    assert fin_t.residual is not None and fin_t.residual.dtype == torch.float32
    step = compressed_runs["step"]
    flips, total = {"params": 0, "residual": 0}, 0
    for layer in params_j:
        for leaf in ("w", "b"):
            st = step[layer][leaf].numpy()
            total += st.size
            for name, got, want in (("params", params_t, params_j), ("residual", resid_t, resid_j)):
                g, w = got[layer][leaf], want[layer][leaf]
                off = np.abs(g - w) > 1e-5 + 1e-4 * np.abs(w)  # the trajectory tolerance
                # beyond it only quantisation-code flips: each within one code step
                assert np.all(np.abs(g - w)[off] <= 1.01 * st[off] + 1e-5), (name, layer, leaf)
                flips[name] += int(off.sum())
    print(f"code-step flips beyond rtol 1e-4 / atol 1e-5 of {total} elements: {flips}")
    assert max(flips.values()) <= 1e-3 * total, flips


def test_compressed_trajectory_perturbs_but_not_much(compressed_runs):
    fin_t, _ = compressed_runs["torch"]
    diff = float((fin_t.params - compressed_runs["raw"].params).abs().max())
    assert 0 < diff < 1.0
    assert compressed_runs["round_fn"].compression.codec == "int8"


def test_compressed_sweep_and_state_copies(compressed_runs):
    xs, ys, sched = compressed_runs["data"]
    rf, init = compressed_runs["round_fn"], compressed_runs["init"]
    assert init.residual is None  # the caller's state is not seeded in place
    fin_t, _ = compressed_runs["torch"]
    stacked, _ = PF.run_sweep([init, init], rf, xs, ys, sched, n_rounds=ROUNDS_T, b_local=B_T, device="cpu")
    assert stacked.residual.shape == (2, *fin_t.params.shape)
    for run in PF.unstack_states(stacked):
        assert torch.equal(run.params, fin_t.params) and torch.equal(run.residual, fin_t.residual)
    # a JAX state with a mirror crosses over leaf for leaf
    params, _, mirror = to_numpy(fin_t, residual=True)
    again = state_from_numpy(params, residual=mirror, device="cpu")
    assert torch.equal(again.residual, fin_t.residual)


# ------------------------------------------------------------- contraction
def _consensus_distance(x):
    return float(torch.linalg.norm(x - x.mean(dim=0, keepdim=True)))


@pytest.mark.parametrize("codec,gamma,target", [("int8", 1.0, 1e-3), ("fp8", 1.0, 1e-3), ("topk", 0.3, 0.35),
                                                ("qtopk", 0.3, 0.35)])
def test_compressed_consensus_contracts(codec, gamma, target):
    """The port's copy of the JAX package's contraction test: mirror-form
    compressed DecAvg reaches (near-)consensus on ring-16 and k-regular-16
    over 300 rounds, and conserves the mean."""
    for graph in (PT.ring(16), PT.random_k_regular(16, 4, seed=0)):
        plan = PC.compile_plan(graph, device="cpu")
        x0 = torch.as_tensor(np.random.default_rng(7).standard_normal((16, 400)).astype(np.float32))
        comp = PCm.Compression(codec=codec, chunk=128, gamma=gamma)
        x, h = x0, PCm.init_residuals(x0)
        for _ in range(300):
            x, h = plan.mix(x, compression=comp, residual=h)
        assert _consensus_distance(x) < target * _consensus_distance(x0), graph.name
        torch.testing.assert_close(x.mean(dim=0), x0.mean(dim=0), atol=1e-3, rtol=0)


def test_error_feedback_off_floors_out():
    plan = PC.compile_plan(PT.ring(12), device="cpu")
    x0 = torch.as_tensor(np.random.default_rng(8).standard_normal((12, 256)).astype(np.float32))
    on = PCm.Compression(codec="int8", chunk=64)

    def run(comp):
        x, h = x0, PCm.init_residuals(x0)
        for _ in range(200):
            x, h = plan.mix(x, compression=comp, residual=h)
        return _consensus_distance(x)

    assert run(on) < 0.05 * run(dataclasses.replace(on, error_feedback=False))


# --------------------------------------------------------------------- CLI
@pytest.mark.parametrize("codec", ["int8", "fp8", "topk", "qtopk"])
def test_cli_compressed_runs_on_cpu(codec, capsys):
    hist = cli.main(["--device", "cpu", "--nodes", "4", "--rounds", "2", "--items-per-node", "32",
                     "--local-batches", "1", "--compress", codec, "--topk-frac", "0.3"])
    assert hist["round"] == [0, 1]
    assert all(np.isfinite(hist[k]).all() for k in ("train_loss", "test_loss", "sigma_ap", "sigma_an"))
    out = capsys.readouterr().out
    want = {"int8": "gamma=1 (~4.0x bytes)", "fp8": "gamma=1 (~4.0x bytes)",
            "topk": "topk_frac=0.3 gamma=0.3 (~2.2x bytes)", "qtopk": "topk_frac=0.3 gamma=0.3 (~4.4x bytes)"}[codec]
    assert f"compress: {codec} chunk=2048 " in out and want in out


@pytest.mark.parametrize("argv,error", [
    (["--compress", "zstd"], SystemExit),
    (["--compress", "int8", "--compress-chunk", "0"], ValueError),
    (["--compress", "int8", "--compress-chunk", "70000"], ValueError),
    (["--compress", "topk", "--topk-frac", "0"], ValueError),
    (["--compress", "int8", "--gamma", "1.5"], ValueError),
])
def test_cli_rejects_what_the_jax_cli_rejects(argv, error, monkeypatch):
    from repro.launch import train as jax_cli

    with pytest.raises(error):
        cli.main(["--device", "cpu", "--nodes", "4", "--rounds", "1", *argv])
    monkeypatch.setattr("sys.argv", ["train", "--model", "mlp", "--nodes", "4", "--rounds", "1", *argv])
    with pytest.raises(error):
        jax_cli.main()
