"""The mixing kernels' plain versions against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs.  On CPU tensors
the port's wrappers run the plain versions and never launch a kernel.

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
from repro_torch.kernels.mix import (  # noqa: E402
    bsr_from_dense,
    bsr_slots,
    decavg_mix,
    mix_bsr,
    mix_bsr_ref,
    mix_matmul,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _row_stochastic(rng, n):
    m = rng.random((n, n)).astype(np.float32)
    return m / m.sum(1, keepdims=True)


@pytest.mark.parametrize("n,d", [(8, 64), (16, 1000), (64, 4096), (100, 257), (256, 128)])
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
    ]


@pytest.mark.parametrize("case", range(3))
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


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("d", [96, 513])
def test_bsr_plain_matches_jax_kernel(case, d):
    _, g, bn = _bsr_cases()[case]
    m = JM.receive_matrix(g).astype(np.float32)
    w = np.random.default_rng(d).standard_normal((g.n, d)).astype(np.float32)
    bc_j, tiles_j = jax_bsr_from_dense(m, bn)
    want = jax_mix_bsr(jnp.asarray(bc_j), jnp.asarray(tiles_j), jnp.asarray(w), interpret=True)
    bc, tiles, counts = (torch.as_tensor(a) for a in bsr_from_dense(m, bn))
    got = mix_bsr(bc, tiles, counts, torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), m @ w, atol=1e-5, rtol=1e-5)


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
