"""The port's numpy substrate against the JAX package: graphs, mixing
operators, gains, datasets and batch schedules must be bit-identical for
the same seeds (gains to 1e-12)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import initialisation as JI  # noqa: E402
from repro.core import mixing as JM  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.data import partition as JPa  # noqa: E402
from repro.data import synthetic as JS  # noqa: E402
from repro_torch.core import initialisation as PI  # noqa: E402
from repro_torch.core import mixing as PM  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.data import pipeline as PP  # noqa: E402
from repro_torch.data import partition as PPa  # noqa: E402
from repro_torch.data import synthetic as PS  # noqa: E402

FAMILIES = {
    "complete": lambda T, n, s: T.complete(n),
    "ring": lambda T, n, s: T.ring(n),
    "circulant": lambda T, n, s: T.circulant(n, (1, 2)),
    "kreg": lambda T, n, s: T.random_k_regular(n, 4, seed=s),
    "er_gnp": lambda T, n, s: T.erdos_renyi_gnp(n, 4.5 / n + 0.05, seed=s),
    "er_gnm": lambda T, n, s: T.erdos_renyi_gnm(n, 3 * n, seed=s),
    "ba": lambda T, n, s: T.barabasi_albert(n, 3, seed=s),
    "heavy_tail": lambda T, n, s: T.configuration_heavy_tail(n, 2.2, seed=s),
    "torus": lambda T, n, s: T.torus_lattice((4, n // 4)),
    "star": lambda T, n, s: T.star(n),
}


def _pair(family, n=24, seed=0):
    return FAMILIES[family](JT, n, seed), FAMILIES[family](PT, n, seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_graphs_bit_identical(family, seed):
    gj, gp = _pair(family, 24, seed)
    assert gp.name == gj.name and gp.n_edges == gj.n_edges
    np.testing.assert_array_equal(gp.adjacency, gj.adjacency)
    assert gp.adjacency.dtype == gj.adjacency.dtype
    np.testing.assert_array_equal(gp.edge_list(), gj.edge_list())
    for a, b in zip(gp.csr(), gj.csr()):
        np.testing.assert_array_equal(a, b)
    assert gp.is_connected() == gj.is_connected()
    np.testing.assert_array_equal(gp.degrees, gj.degrees)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_mixing_operators_equal(family):
    gj, gp = _pair(family, 20, 3)
    sizes = np.linspace(1.0, 3.0, gj.n)
    for ds in (None, sizes):
        np.testing.assert_array_equal(PM.receive_matrix(gp, ds), JM.receive_matrix(gj, ds))
    np.testing.assert_array_equal(PM.mixing_matrix(gp), JM.mixing_matrix(gj))
    np.testing.assert_array_equal(PM.v_steady(gp), JM.v_steady(gj))
    assert PM.v_steady_norm(gp) == JM.v_steady_norm(gj)


def test_receive_matrix_directed_cycle():
    """A[i, j] != 0 means "i receives from j", in the port as in the JAX package."""
    n = 7
    a = np.zeros((n, n), np.float32)
    a[np.arange(n), (np.arange(n) + 1) % n] = 1.0
    gj, gp = JT.from_adjacency(a, directed=True), PT.from_adjacency(a, directed=True)
    m = PM.receive_matrix(gp)
    np.testing.assert_array_equal(m, JM.receive_matrix(gj))
    assert m[0, 1] == 0.5 and m[1, 0] == 0.0
    indptr, src, _ = gp.csr()
    assert list(src[indptr[0] : indptr[1]]) == [1]
    for x, y in zip(gp.csr(), gj.csr()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(PM.v_steady(gp), JM.v_steady(gj), rtol=1e-12)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gain_from_graph_exact(family):
    gj, gp = _pair(family, 32, 1)
    np.testing.assert_allclose(PI.gain_from_graph(gp), JI.gain_from_graph(gj), rtol=1e-12)


def test_gain_from_estimates_exact():
    rng = np.random.default_rng(0)
    n_hat = rng.uniform(10, 100, size=12)
    sample = rng.integers(1, 9, size=(12, 30))
    cases = [
        dict(n_estimate=37.0),
        dict(n_estimate=n_hat),
        dict(n_estimate=n_hat, family_exponent=0.4),
        dict(n_estimate=50.0, degree_sample=sample[0]),
        dict(n_estimate=n_hat, degree_sample=sample),
    ]
    for kw in cases:
        np.testing.assert_allclose(PI.gain_from_estimates(**kw), JI.gain_from_estimates(**kw), rtol=1e-12)
    with pytest.raises(ValueError):
        PI.gain_from_estimates(10.0, degree_sample=sample[0], family_exponent=0.5)


@pytest.mark.parametrize("seed", [0, 7])
def test_datasets_bitwise(seed):
    for maker in ("mnist_like", "so2sat_like", "cifar10_like"):
        dj, dp = getattr(JS, maker)(96, seed=seed), getattr(PS, maker)(96, seed=seed)
        np.testing.assert_array_equal(dp.x, dj.x)
        np.testing.assert_array_equal(dp.y, dj.y)
        assert (dp.n_classes, dp.name) == (dj.n_classes, dj.name)


def test_partition_and_node_datasets_bitwise():
    ds = JS.mnist_like(400, seed=2)
    for n_nodes, seed in ((5, 0), (8, 3)):
        pj, pp = JPa.partition_iid(400, n_nodes, seed=seed), PPa.partition_iid(400, n_nodes, seed=seed)
        for a, b in zip(pj, pp):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(JPa.node_datasets(ds, pj), PPa.node_datasets(ds, pp)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "per_node,n_nodes,bs,n_batches,seed",
    [(48, 6, 8, 20, 0), (128, 16, 16, 160, 0), (33, 3, 5, 17, 9), (16, 4, 16, 5, 1)],
)
def test_batch_schedule_and_iterator_bitwise(per_node, n_nodes, bs, n_batches, seed):
    sj = JP.batch_index_schedule(per_node, n_nodes, bs, n_batches, seed=seed)
    sp = PP.batch_index_schedule(per_node, n_nodes, bs, n_batches, seed=seed)
    np.testing.assert_array_equal(sp, sj)
    assert sp.dtype == sj.dtype
    xs = np.arange(n_nodes * per_node * 2, dtype=np.float32).reshape(n_nodes, per_node, 2)
    ys = np.arange(n_nodes * per_node, dtype=np.int32).reshape(n_nodes, per_node)
    it_j, it_p = JP.node_batch_iterator(xs, ys, bs, seed=seed), PP.node_batch_iterator(xs, ys, bs, seed=seed)
    for k in range(min(n_batches, 12)):
        bj, bp = next(it_j), next(it_p)
        np.testing.assert_array_equal(bp.x, bj.x)
        np.testing.assert_array_equal(bp.y, bj.y)
        np.testing.assert_array_equal(bp.y, ys[np.arange(n_nodes)[:, None], sp[k]])
