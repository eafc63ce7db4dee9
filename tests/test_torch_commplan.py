"""The port's CommPlan against the JAX package's: dense and sparse backends,
clean and masked rounds, on the same numpy inputs (fp32 leaves to 1e-5,
bf16 leaves to one bf16 rounding, 1e-2).  The port's own Bernoulli draws
are held statistically: keep rates within a binomial bound of link_p /
node_p, both directions of an edge agree, rows stay stochastic."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import commplan as JC  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402

FAMILIES = {
    "complete": lambda T, n: T.complete(n),
    "ring": lambda T, n: T.ring(n),
    "kreg": lambda T, n: T.random_k_regular(n, 4, seed=2),
    "ba": lambda T, n: T.barabasi_albert(n, 3, seed=1),
    "heavy_tail": lambda T, n: T.configuration_heavy_tail(n, 2.2, seed=0),
    "torus": lambda T, n: T.torus_lattice((4, n // 4)),
}
BACKENDS = ("dense", "sparse")


def _params_np(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((n, 6, 3)).astype(np.float32),
        "b": {"v": rng.standard_normal((n, 5)).astype(np.float32)},
        "h": rng.standard_normal((n, 17)).astype(np.float32),
    }


def _to_jax(p):
    return {"w": jnp.asarray(p["w"]), "b": {"v": jnp.asarray(p["b"]["v"])}, "h": jnp.asarray(p["h"]).astype(jnp.bfloat16)}


def _to_torch(p):
    return {
        "w": torch.as_tensor(p["w"]),
        "b": {"v": torch.as_tensor(p["b"]["v"])},
        "h": torch.as_tensor(p["h"]).to(torch.bfloat16),
    }


def _assert_tree_close(got, want):
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["b"]["v"].numpy(), np.asarray(want["b"]["v"]), atol=1e-5, rtol=1e-5)
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_allclose(
        got["h"].float().numpy(), np.asarray(want["h"], np.float32), atol=1e-2, rtol=1e-2
    )


def _plans(family, backend, n=16, **kw):
    gj, gp = FAMILIES[family](JT, n), FAMILIES[family](PT, n)
    return gj, JC.compile_plan(gj, backend, **kw), PC.compile_plan(gp, backend, device="cpu", **kw)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_clean_mix_matches_jax(family, backend):
    g, pj, pp = _plans(family, backend)
    p = _params_np(g.n)
    _assert_tree_close(pp.mix(_to_torch(p)), pj.mix(_to_jax(p)))
    # the flat (n, d) buffer of the training path: one launch, same numbers
    flat = np.random.default_rng(1).standard_normal((g.n, 300)).astype(np.float32)
    got = pp.mix(torch.as_tensor(flat))
    np.testing.assert_allclose(got.numpy(), np.asarray(pj.mix({"x": jnp.asarray(flat)})["x"]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("family", ["ring", "ba", "heavy_tail"])
def test_weighted_mix_matches_jax(family, backend):
    sizes = np.linspace(1.0, 3.0, 16)
    g, pj, pp = _plans(family, backend, data_sizes=sizes)
    p = _params_np(g.n, 4)
    _assert_tree_close(pp.mix(_to_torch(p)), pj.mix(_to_jax(p)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("family", ["complete", "ring", "kreg", "heavy_tail"])
def test_masked_mix_matches_jax(family, backend, seed):
    """Injected membership / fault masks: the JAX path is deterministic when
    its failure model is inactive, so both packages see the same operator."""
    sizes = np.linspace(1.0, 2.0, 16) if seed == 2 else None
    g, pj, pp = _plans(family, backend, data_sizes=sizes)
    rng = np.random.default_rng(seed)
    active = rng.random(g.n) < 0.75
    edge_live = rng.random(pj.n_edges) < 0.6
    p = _params_np(g.n, seed)
    want = pj.mix(_to_jax(p), active=jnp.asarray(active), edge_live=jnp.asarray(edge_live))
    got = pp.mix(_to_torch(p), active=torch.as_tensor(active), edge_live=torch.as_tensor(edge_live))
    _assert_tree_close(got, want)
    # a short edge_live pads with True, as in the JAX package
    short = edge_live[: pj.n_edges // 2]
    want = pj.mix(_to_jax(p), edge_live=jnp.asarray(short))
    _assert_tree_close(pp.mix(_to_torch(p), edge_live=torch.as_tensor(short)), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_directed_cycle_matches_jax(backend):
    n = 9
    a = np.zeros((n, n), np.float32)
    a[np.arange(n), (np.arange(n) + 1) % n] = 1.0
    pj = JC.compile_plan(JT.from_adjacency(a, directed=True), backend)
    pp = PC.compile_plan(PT.from_adjacency(a, directed=True), backend, device="cpu")
    x = np.random.default_rng(0).standard_normal((n, 11)).astype(np.float32)
    got = pp.mix(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(pj.mix({"x": jnp.asarray(x)})["x"]), atol=1e-6)
    np.testing.assert_allclose(got, 0.5 * (x + np.roll(x, -1, axis=0)), atol=1e-6)
    active = np.ones(n, bool)
    active[3] = False
    want = pj.mix({"x": jnp.asarray(x)}, active=jnp.asarray(active))["x"]
    np.testing.assert_allclose(pp.mix(torch.as_tensor(x), active=torch.as_tensor(active)).numpy(), np.asarray(want), atol=1e-6)


def test_dense_and_sparse_draw_the_same_operator():
    g = PT.random_k_regular(40, 4, seed=0)
    fm = PC.FailureModel(link_p=0.6, node_p=0.8)
    dense = PC.compile_plan(g, "dense", failures=fm, device="cpu")
    sparse = PC.compile_plan(g, "sparse", failures=fm, device="cpu")
    x = torch.randn(40, 50)
    for seed in range(5):
        a = dense.mix(x, torch.Generator().manual_seed(seed))
        b = sparse.mix(x, torch.Generator().manual_seed(seed))
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        dense.mix(x)  # failure model active: a generator is required


def test_failure_draw_statistics():
    g = PT.random_k_regular(64, 6, seed=1)
    link_p, node_p, rounds = 0.7, 0.85, 200
    plan = PC.compile_plan(g, "dense", failures=PC.FailureModel(link_p, node_p), device="cpu")
    gen = torch.Generator().manual_seed(0)
    keep_n = act_n = 0
    for _ in range(rounds):
        edge_keep, active = plan.round_masks(gen)
        keep_n += int(edge_keep.sum())
        act_n += int(active.sum())
    for hits, trials, p in ((keep_n, rounds * plan.n_edges, link_p), (act_n, rounds * g.n, node_p)):
        assert abs(hits / trials - p) < 5 * np.sqrt(p * (1 - p) / trials)
    for seed in range(10):
        m = plan.round_operator(torch.Generator().manual_seed(seed)).numpy()
        np.testing.assert_allclose(m.sum(1), 1.0, atol=1e-6)
        off = m - np.diag(np.diag(m))
        np.testing.assert_array_equal(off > 0, (off > 0).T)  # one draw per undirected edge
        assert np.all((off > 0) <= (g.adjacency > 0))
    sparse = plan.with_options(backend="sparse")
    assert sparse.device == plan.device and sparse.failures == plan.failures
    bsr = sparse.round_operator(torch.Generator().manual_seed(3))
    row_sums = bsr.tiles.sum(dim=(1, 3)).reshape(-1)[: g.n]
    torch.testing.assert_close(row_sums, torch.ones(g.n), atol=1e-6, rtol=0)


def test_auto_backend_tile_size_and_unported_backends():
    assert PC.compile_plan(PT.ring(64), device="cpu").backend == "dense"
    assert PC.compile_plan(PT.ring(65), device="cpu").backend == "sparse"
    assert [PC.block_size(n) for n in (2, 16, 40, 100, 255, 256, 1024, 5000)] == [4, 4, 8, 16, 32, 32, 32, 32]
    assert PC.compile_plan(PT.ring(1024), device="cpu").bsr.block_n == 32
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PC.compile_plan(PT.ring(8), "ppermute", device="cpu")
    with pytest.raises(ValueError):
        PC.compile_plan(PT.ring(8), "hyb", device="cpu")


def test_decavg_plain_renderings_match_jax():
    from repro.core import decavg as JD
    from repro.core.mixing import receive_matrix as jax_receive_matrix
    from repro_torch.core import decavg as PD

    g = JT.barabasi_albert(20, 3, seed=0)
    m = jax_receive_matrix(g).astype(np.float32)
    p = _params_np(g.n, 5)
    _assert_tree_close(PD.mix_pytree(torch.as_tensor(m), _to_torch(p)), JD.mix_pytree(jnp.asarray(m), _to_jax(p)))
    indptr, src, _ = g.csr()
    dst = np.repeat(np.arange(g.n), np.diff(indptr))
    edge_w, self_w = m[dst, src], np.diag(m).copy()
    want = JD.mix_pytree_sparse(
        _to_jax(p), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(edge_w), jnp.asarray(self_w), n_nodes=g.n
    )
    got = PD.mix_pytree_sparse(
        _to_torch(p), torch.as_tensor(src).long(), torch.as_tensor(dst).long(),
        torch.as_tensor(edge_w), torch.as_tensor(self_w), n_nodes=g.n,
    )
    _assert_tree_close(got, want)
    keep = (np.random.default_rng(0).random((g.n, g.n)) < 0.5).astype(np.float32)
    a = g.adjacency * keep * keep.T
    sizes = np.linspace(1, 2, g.n).astype(np.float32)
    np.testing.assert_allclose(
        PD.failure_receive_matrix(torch.as_tensor(a), torch.as_tensor(sizes)).numpy(),
        np.asarray(JD.failure_receive_matrix(jnp.asarray(a), jnp.asarray(sizes))),
        atol=1e-6,
    )
