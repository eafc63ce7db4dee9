"""The §4.2 diffusion model and the numpy copies of this slice against the
JAX package: ``partition_zipf``, ``spectral_gap``, ``mixing_time_estimate``
and ``rewire_to_assortativity`` bitwise (the same arithmetic and the same
``default_rng`` draws); ``run_diffusion``'s trajectory on injected w0 and
noise against the JAX step (``decavg.mix_array`` plus ``diffusion._sigmas``)
to rtol 1e-5; with the port's own draws, the bands of
``tests/test_diffusion.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import decavg as JD  # noqa: E402
from repro.core import diffusion as JDiff  # noqa: E402
from repro.core import mixing as JM  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.data import partition as JP  # noqa: E402
from repro.data import so2sat_like  # noqa: E402
from repro_torch.core import diffusion as D  # noqa: E402
from repro_torch.core import mixing as M  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.data import partition as P  # noqa: E402

GRAPHS = {
    "kreg4-32": lambda t: t.random_k_regular(32, 4, seed=2),
    "ba-40": lambda t: t.barabasi_albert(40, 3, seed=1),
    "ring-12": lambda t: t.ring(12),
    "heavytail-60": lambda t: t.configuration_heavy_tail(60, 2.2, seed=0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU products run fastest on one thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("alpha, n_nodes, per", [(1.8, 16, None), (1.2, 7, 50), (3.0, 64, None)])
def test_partition_zipf_bitwise(alpha, n_nodes, per):
    labels = so2sat_like(2048, seed=3).y
    got = P.partition_zipf(labels, n_nodes, alpha=alpha, items_per_node=per, seed=4)
    want = JP.partition_zipf(labels, n_nodes, alpha=alpha, items_per_node=per, seed=4)
    assert len(got) == len(want) == n_nodes
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_partition_zipf_runs_out_of_a_class():
    """More items a node than a class holds: the least-depleted class fills in."""
    labels = np.repeat(np.arange(4), [3, 50, 50, 50])
    got = P.partition_zipf(labels, 3, alpha=2.0, items_per_node=60, seed=0)
    want = JP.partition_zipf(labels, 3, alpha=2.0, items_per_node=60, seed=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(len(g) for g in got) == 153  # every item handed out, the last node short


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_spectral_gap_and_mixing_time_bitwise(graph):
    gp, gj = GRAPHS[graph](T), GRAPHS[graph](JT)
    assert M.spectral_gap(gp) == JM.spectral_gap(gj)
    assert M.mixing_time_estimate(gp) == JM.mixing_time_estimate(gj)
    assert M.mixing_time_estimate(gp, eps=0.05) == JM.mixing_time_estimate(gj, eps=0.05)
    w = np.linspace(0.5, 2.0, gp.n)
    assert M.spectral_gap(gp, w) == JM.spectral_gap(gj, w)


@pytest.mark.parametrize("target", [-0.3, 0.0, 0.3])
def test_rewire_to_assortativity_bitwise(target):
    gp, gj = T.erdos_renyi_gnp(128, 8 / 128, seed=5), JT.erdos_renyi_gnp(128, 8 / 128, seed=5)
    got = M.rewire_to_assortativity(gp, target, seed=1, steps=4000)
    want = JM.rewire_to_assortativity(gj, target, seed=1, steps=4000)
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    assert got.name == want.name and isinstance(got, T.Graph)
    np.testing.assert_array_equal(got.degrees, gp.degrees)  # degree-preserving
    assert M.v_steady_norm(got) == M.v_steady_norm(gp)
    # a regular graph has no degree variance: returned as it is
    ring = T.ring(10)
    assert M.rewire_to_assortativity(ring, 0.3) is ring


@pytest.mark.parametrize("graph", ["kreg4-32", "ba-40"])
def test_diffusion_on_injected_draws_matches_jax_step(graph):
    gp, gj = GRAPHS[graph](T), GRAPHS[graph](JT)
    rng = np.random.default_rng(0)
    n, d, rounds, sigma_noise = gp.n, 96, 12, 1e-2
    w0 = rng.standard_normal((n, d)).astype(np.float32)
    noises = rng.standard_normal((rounds, n, d)).astype(np.float32)
    m = M.receive_matrix(gp).astype(np.float32)
    an, ap = D.simulate(torch.as_tensor(m), torch.as_tensor(w0), torch.as_tensor(noises), sigma_noise)
    w = jnp.asarray(w0)
    want = [JDiff._sigmas(w)]
    for r in range(rounds):
        w = JD.mix_array(jnp.asarray(JM.receive_matrix(gj), jnp.float32), w) + sigma_noise * jnp.asarray(noises[r])
        want.append(JDiff._sigmas(w))
    want_an, want_ap = (np.asarray([float(s[i]) for s in want]) for i in (0, 1))
    assert an.shape == ap.shape == (rounds + 1,)
    np.testing.assert_allclose(an, want_an, rtol=1e-5)
    np.testing.assert_allclose(ap, want_ap, rtol=1e-5)
    # one step, the noise an argument
    got = D.diffusion_step(torch.as_tensor(m), torch.as_tensor(w0), torch.as_tensor(noises[0]), sigma_noise)
    want_w = JD.mix_array(jnp.asarray(m), jnp.asarray(w0)) + sigma_noise * jnp.asarray(noises[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-6)


def test_run_diffusion_result_and_prediction():
    g = T.random_k_regular(32, 4, seed=2)
    res = D.run_diffusion(g, d=64, rounds=5, seed=3, device="cpu")
    again = D.run_diffusion(g, d=64, rounds=5, seed=3, device="cpu")
    np.testing.assert_array_equal(res.sigma_ap, again.sigma_ap)
    assert res.sigma_an.shape == res.sigma_ap.shape == (6,)
    assert res.v_steady_norm == M.v_steady_norm(g) == JM.v_steady_norm(JT.random_k_regular(32, 4, seed=2))
    assert res.sigma_ap_prediction == D.sigma_ap_prediction(g, 1.0) == pytest.approx(1 / np.sqrt(32))
    assert D.sigma_ap_prediction(g, 2.5) == JDiff.sigma_ap_prediction(JT.random_k_regular(32, 4, seed=2), 2.5)


# ------------------------------------------------ the port's own draws: the JAX tests' bands
def test_sigma_ap_approaches_prediction_regular():
    g = T.random_k_regular(256, 32, seed=0)
    res = D.run_diffusion(g, d=512, sigma_init=1.0, sigma_noise=1e-5, rounds=120, seed=0, device="cpu")
    assert np.isclose(res.sigma_ap[-1], res.sigma_ap_prediction, rtol=0.05)
    assert np.isclose(res.sigma_ap_prediction, 1.0 / np.sqrt(256), rtol=1e-6)


def test_sigma_an_decays_to_noise_floor():
    g = T.random_k_regular(128, 16, seed=1)
    noise = 1e-3
    res = D.run_diffusion(g, d=256, sigma_noise=noise, rounds=150, seed=1, device="cpu")
    assert res.sigma_an[0] > 0.9
    assert res.sigma_an[-1] < 10 * noise


def test_heterogeneous_graph_compresses_less():
    r_ba = D.run_diffusion(T.barabasi_albert(256, 4, seed=0), d=256, sigma_noise=1e-5, rounds=150, device="cpu")
    r_kreg = D.run_diffusion(T.random_k_regular(256, 8, seed=0), d=256, sigma_noise=1e-5, rounds=150, device="cpu")
    assert r_ba.sigma_ap[-1] > r_kreg.sigma_ap[-1]


def test_stabilisation_faster_on_expander_than_ring():
    def rounds_to_stabilise(g):
        res = D.run_diffusion(g, d=128, sigma_noise=1e-4, rounds=400, seed=0, device="cpu")
        return int(np.argmax(res.sigma_an < res.sigma_an[-1] * 2))

    assert rounds_to_stabilise(T.random_k_regular(64, 8, seed=0)) < rounds_to_stabilise(T.ring(64))


def test_noise_free_diffusion_reaches_the_limit():
    g = T.random_k_regular(32, 4, seed=2)
    res = D.run_diffusion(g, d=1024, sigma_noise=0.0, rounds=50, seed=2, device="cpu")
    assert np.isclose(res.sigma_ap[-1], res.sigma_ap_prediction, rtol=0.08)
