"""The mixing kernels' plain versions against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs.  On CPU tensors
the port's wrappers run the plain versions and never launch a kernel.
``mix_bsr_rows_ref``, the block-sparse CUDA walk rendered bit for bit (each
row's nonzeros in tile-then-column order, exact zeros and padding tiles
skipped, one fp32 FMA each), is held against the plain tile walk and the
Pallas kernel on the same cases.

Tolerances: fp32 1e-5 (both sides accumulate in fp32, in another order);
bf16 3e-2 atol/rtol (one bf16 rounding of the output), as the JAX
package's own kernel tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mixing as JM  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.kernels.mix.mix import mix_matmul as jax_mix_matmul  # noqa: E402
from repro.kernels.mix.ops import decavg_mix as jax_decavg_mix  # noqa: E402
from repro.kernels.mix.sparse import bsr_from_dense as jax_bsr_from_dense  # noqa: E402
from repro.kernels.mix.sparse import mix_bsr as jax_mix_bsr  # noqa: E402
from repro_torch.kernels.mix import mix as mix_kernel  # noqa: E402
from repro_torch.kernels.mix import (  # noqa: E402
    bsr_from_dense,
    bsr_slots,
    decavg_mix,
    mix_bsr,
    mix_bsr_ref,
    mix_bsr_rows_ref,
    mix_matmul,
)
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.commplan import compile_plan  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _row_stochastic(rng, n):
    m = rng.random((n, n)).astype(np.float32)
    return m / m.sum(1, keepdims=True)


# both sides of the CUDA kernel's crossover: the gossip payloads (thin
# route) up to D_THIN columns, the training widths (wide route) past it
CROSSOVER = [(16, 1), (256, 4), (64, mix_kernel.D_THIN), (64, mix_kernel.D_THIN + 1), (8, 3 * mix_kernel.D_THIN + 2)]


@pytest.mark.parametrize("n,d", [(8, 64), (16, 1000), (64, 4096), (100, 257), (256, 128), *CROSSOVER])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_plain_matches_jax_kernel(n, d, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(n * 7919 + d)
    m = _row_stochastic(rng, n)
    w = rng.standard_normal((n, d)).astype(np.float32)
    want = jax_mix_matmul(jnp.asarray(m), jnp.asarray(w).astype(jdt), interpret=True)
    got = mix_matmul(torch.as_tensor(m), torch.as_tensor(w).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (n, d)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def _bsr_cases():
    return [
        ("heavy_tail-40", JT.configuration_heavy_tail(40, 2.2, seed=0), 8),
        ("ring-64", JT.ring(64), 16),
        ("kreg-48", JT.random_k_regular(48, 4, seed=1), 16),
        ("heavy_tail-40 bn16", JT.configuration_heavy_tail(40, 2.2, seed=0), 16),  # n not a multiple of bn
        ("ring-70", JT.ring(70), 32),
    ]


@pytest.mark.parametrize("case", range(5))
def test_bsr_lowering_equals_jax(case):
    _, g, bn = _bsr_cases()[case]
    m = JM.receive_matrix(g).astype(np.float32)
    bc_j, tiles_j = jax_bsr_from_dense(m, bn)
    bc, tiles, counts = bsr_from_dense(m, bn)
    np.testing.assert_array_equal(bc, bc_j)
    np.testing.assert_array_equal(tiles, tiles_j)
    assert bc.dtype == bc_j.dtype and tiles.dtype == tiles_j.dtype
    nonzero = np.abs(tiles).sum(axis=(2, 3)) > 0
    np.testing.assert_array_equal(counts, nonzero.sum(axis=1))
    # padded slots of short row blocks are zero tiles at column block 0
    for i, c in enumerate(counts):
        assert not tiles[i, c:].any() and not bc[i, c:].any()


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("d", [96, 513])
def test_bsr_plain_matches_jax_kernel(case, d):
    """The plain tile walk and the CUDA walk's rendering, both against the
    Pallas kernel (interpret) and M @ W."""
    _, g, bn = _bsr_cases()[case]
    m = JM.receive_matrix(g).astype(np.float32)
    w = np.random.default_rng(d).standard_normal((g.n, d)).astype(np.float32)
    bc_j, tiles_j = jax_bsr_from_dense(m, bn)
    want = jax_mix_bsr(jnp.asarray(bc_j), jnp.asarray(tiles_j), jnp.asarray(w), interpret=True)
    bc, tiles, counts = (torch.as_tensor(a) for a in bsr_from_dense(m, bn))
    got = mix_bsr(bc, tiles, counts, torch.as_tensor(w))
    rows = mix_bsr_rows_ref(bc, tiles, counts, torch.as_tensor(w))
    for y in (got, rows):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(y.numpy(), m @ w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rows.numpy(), got.numpy(), atol=1e-5, rtol=1e-5)


def _masked_ring_round(n, dead=()):
    """A masked round of the port's sparse plan on ring-n (CPU): the BSR
    operator and the same round's dense operator.  ``dead`` rows are
    inactive, so their row block's off-diagonal tiles become all zero."""
    rng = np.random.default_rng(n)
    active = rng.random(n) < 0.8
    active[list(dead)] = False
    plan = compile_plan(PT.ring(n), "sparse", device="cpu")
    edge_live = torch.as_tensor(rng.random(plan.n_edges) < 0.7)
    kw = dict(active=torch.as_tensor(active), edge_live=edge_live)
    dense = compile_plan(PT.ring(n), "dense", device="cpu").round_operator(**kw)
    return plan.round_operator(**kw), dense.numpy()


@pytest.mark.parametrize("variant", ["nan_padding", "masked", "masked_zero_tiles", "bf16"])
def test_bsr_rows_ref_skip_rule(variant):
    """The CUDA walk's rendering skips padding tiles (NaN there changes
    nothing) and the exact zeros of a masked round, including tiles that
    became all zero, and agrees with the plain walk, the Pallas kernel
    (interpret) and the dense operator."""
    rng = np.random.default_rng(11)
    if variant in ("nan_padding", "bf16"):
        m = JM.receive_matrix(JT.configuration_heavy_tail(40, 2.2, seed=0)).astype(np.float32)
        bc, tiles, counts = (torch.as_tensor(a) for a in bsr_from_dense(m, 8))
    else:
        (bc, tiles, counts), m = _masked_ring_round(64, dead=range(8, 16) if variant == "masked_zero_tiles" else ())
        kept = np.abs(tiles.numpy()).sum(axis=(2, 3)) > 0
        real = np.arange(tiles.shape[1])[None, :] < counts.numpy()[:, None]
        if variant == "masked_zero_tiles":
            assert (real[1] & ~kept[1]).sum() == 2  # rows 8-15 keep only their self weights
    w = rng.standard_normal((m.shape[0], 77)).astype(np.float32)
    want = jax_mix_bsr(jnp.asarray(bc.numpy()), jnp.asarray(tiles.numpy()), jnp.asarray(w), interpret=True)
    if variant == "bf16":
        rows = mix_bsr_rows_ref(bc, tiles, counts, torch.as_tensor(w).to(torch.bfloat16))
        assert rows.dtype == torch.bfloat16
        np.testing.assert_allclose(rows.float().numpy(), np.asarray(want), atol=3e-2, rtol=3e-2)
        return
    rows = mix_bsr_rows_ref(bc, tiles, counts, torch.as_tensor(w))
    np.testing.assert_allclose(rows.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rows.numpy(), m @ w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rows.numpy(), mix_bsr_ref(bc, tiles, counts, torch.as_tensor(w)).numpy(),
                               atol=1e-5, rtol=1e-5)
    if variant == "nan_padding":
        dirty = tiles.clone()
        for i, c in enumerate(counts.tolist()):
            dirty[i, c:] = float("nan")
        assert torch.equal(mix_bsr_rows_ref(bc, dirty, counts, torch.as_tensor(w)), rows)


def test_bsr_rows_ref_adds_nothing_for_a_zero_weight():
    """By design: an infinite source element behind an exact zero of M adds
    nothing to the walk over the nonzeros, where the tile product (the plain
    walk, as the Pallas kernel's jnp.dot) gives NaN."""
    m = JM.receive_matrix(JT.ring(16)).astype(np.float32)
    bc, tiles, counts = (torch.as_tensor(a) for a in bsr_from_dense(m, 8))
    w = torch.ones(16, 3)
    w[5, 1] = float("inf")  # row 5 is referenced by rows 4, 5 and 6 only
    rows, tile = mix_bsr_rows_ref(bc, tiles, counts, w), mix_bsr_ref(bc, tiles, counts, w)
    far = [r for r in range(16) if r not in (4, 5, 6)]
    assert torch.isfinite(rows[far]).all() and torch.isinf(rows[[4, 5, 6], 1]).all()
    assert torch.isnan(tile[far[:4], 1]).all()  # rows 0-3 share row 5's tile block


def test_bsr_slots_address_every_entry():
    g = JT.configuration_heavy_tail(40, 2.2, seed=0)
    m = JM.receive_matrix(g).astype(np.float32)
    bc, tiles, counts = bsr_from_dense(m, 8)
    rows, cols = np.nonzero(m)
    slots = bsr_slots(bc, counts, rows, cols, 8)
    np.testing.assert_array_equal(tiles.reshape(-1)[slots], m[rows, cols])
    assert len(np.unique(slots)) == len(slots)
    with pytest.raises(ValueError):
        bsr_slots(bc[:, :1], np.minimum(counts, 1), rows, cols, 8)


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_pytree_decavg_mix_keeps_dtypes(backend):
    n = 12
    rng = np.random.default_rng(3)
    m = _row_stochastic(rng, n) * (rng.random((n, n)) < 0.4) + np.eye(n, dtype=np.float32)
    m = (m / m.sum(1, keepdims=True)).astype(np.float32)
    a = rng.standard_normal((n, 16, 4)).astype(np.float32)
    b = rng.standard_normal((n, 33)).astype(np.float32)
    tree_t = {"a": torch.as_tensor(a), "b": {"w": torch.as_tensor(b).to(torch.bfloat16)}}
    tree_j = {"a": jnp.asarray(a), "b": {"w": jnp.asarray(b).astype(jnp.bfloat16)}}
    got = decavg_mix(torch.as_tensor(m), tree_t, backend=backend, block_n=4)
    want = jax_decavg_mix(jnp.asarray(m), tree_j, backend=backend, block_n=4, interpret=True)
    assert got["a"].dtype == torch.float32 and got["b"]["w"].dtype == torch.bfloat16
    assert tuple(got["a"].shape) == a.shape
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]), atol=1e-5)
    np.testing.assert_allclose(
        got["b"]["w"].float().numpy(), np.asarray(want["b"]["w"], np.float32), atol=3e-2, rtol=3e-2
    )


def test_cpu_tensors_never_launch():
    mix_matmul.launches = mix_bsr.launches = 0
    rng = np.random.default_rng(0)
    m = _row_stochastic(rng, 16)
    w = torch.randn(16, 40)
    mix_matmul(torch.as_tensor(m), w)
    mix_bsr(*(torch.as_tensor(a) for a in bsr_from_dense(m, 8)), w)
    decavg_mix(torch.as_tensor(m), {"x": w}, backend="sparse", block_n=8)
    assert mix_matmul.launches == 0 and mix_bsr.launches == 0


def test_wrappers_reject_bad_inputs():
    m = torch.full((4, 4), 0.25)
    w = torch.randn(4, 10)
    with pytest.raises(TypeError):
        mix_matmul(m.double(), w)
    with pytest.raises(ValueError):
        mix_matmul(torch.full((3, 3), 1 / 3), w)
    with pytest.raises(ValueError):
        mix_matmul(m, torch.randn(10, 4).t())  # not contiguous
    with pytest.raises(TypeError):
        mix_matmul(m, torch.ones(4, 10, dtype=torch.int32))
    bc, tiles, counts = (torch.as_tensor(a) for a in bsr_from_dense(m.numpy(), 2))
    with pytest.raises(ValueError):
        mix_bsr(bc, tiles, counts, torch.randn(6, 10))  # row blocks do not cover n
    with pytest.raises(TypeError):
        mix_bsr(bc.long(), tiles, counts, w)


def test_bsr_plain_skips_padding_tiles():
    """The plain walk stops at counts[i]: garbage past it never contributes."""
    g = JT.configuration_heavy_tail(40, 2.2, seed=0)
    m = JM.receive_matrix(g).astype(np.float32)
    bc, tiles, counts = (torch.as_tensor(a) for a in bsr_from_dense(m, 8))
    w = torch.randn(40, 24)
    clean = mix_bsr_ref(bc, tiles, counts, w)
    dirty = tiles.clone()
    for i, c in enumerate(counts.tolist()):
        dirty[i, c:] = 7.0
    torch.testing.assert_close(mix_bsr_ref(bc, dirty, counts, w), clean, rtol=0, atol=0)


@pytest.mark.parametrize("n,d", CROSSOVER + [(16, 567_434), (64, 33_638_218), (4096, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_route_is_a_function_of_shape_and_dtype(n, d, dtype):
    """The CUDA kernel's route is picked from (n, d, dtype) alone, never from
    a pointer: a W that starts one element into its allocation (every row
    off its 16-byte boundary) takes the route of a fresh one, so a resumed
    or chunked run sums in the same order."""
    import inspect

    assert list(inspect.signature(mix_kernel.dense_route).parameters) == ["n", "d", "dtype"]
    route = mix_kernel.dense_route(n, d, dtype)
    assert route in mix_kernel.ROUTES
    assert route == ("thin" if d <= mix_kernel.D_THIN or n > mix_kernel.WIDE_MAX_N else "wide")
    if n * d <= 2**20:
        fresh = torch.zeros(n, d, dtype=dtype)
        shifted = torch.zeros(n * d + 1, dtype=dtype)[1:].view(n, d)
        assert shifted.data_ptr() % 16 != fresh.data_ptr() % 16
        assert {mix_kernel.dense_route(*t.shape, t.dtype) for t in (fresh, shifted)} == {route}
    assert mix_kernel.thin_tile(min(d, 10**6)) in (1, 2, 4, 8, 16, 32)
