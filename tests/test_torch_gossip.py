"""The port's gossip estimation (``repro_torch.gossip``, ``CommPlan.spread`` /
``spread_min``, the numpy ``core/gossip.py``) against the JAX package's.

Randomness is held two ways.  Exactly, on injected draws: the JAX engine's
per-round failure masks (``round_masks(fold_in(key, r))``), its Exp(1)
sketches and its walker's uniforms, failure masks and resample indices are
fed to the port through the hooks the port draws from
(``engine._round_masks``, ``engine._draw_sketches``, ``walker._uniforms`` /
``_step_masks`` / ``_resample``).  Statistically, on the port's own CPU
generators: the power iteration within 5% of ‖v_steady‖ at 80 + 160 rounds,
push-sum converging under failures, the sketch estimator unbiased, the
walker's bias correction.  Tolerances: spread and every estimate rtol 1e-5
/ atol 1e-6 (the JAX package's einsum and segment sums against the mixing
kernels' plain versions, fp32); ``spread_min`` bitwise (a min is exact); the
numpy copy bitwise.  Sizes stay small (n ≤ 32, ≤ 64 rounds a phase, but the
5% convergence check at 80 + 160 rounds of n = 16)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.gossip as JG  # noqa: E402
from repro.core import commplan as JC  # noqa: E402
from repro.core import gossip as JGref  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro_torch import gossip as PG  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import gossip as PGref  # noqa: E402
from repro_torch.core import mixing as PM  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.gossip import engine as PE  # noqa: E402
from repro_torch.gossip import walker as PW  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
FAMILIES = {
    "complete": lambda T: T.complete(16),
    "ring": lambda T: T.ring(16),
    "kreg": lambda T: T.random_k_regular(16, 4, seed=2),
    "ba": lambda T: T.barabasi_albert(16, 3, seed=1),
    "heavy_tail": lambda T: T.configuration_heavy_tail(16, 2.2, seed=0),
}
BACKENDS = ("dense", "sparse")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU products run fastest on one thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _plans(family, backend, link_p=1.0, node_p=1.0):
    fm_j, fm_p = JC.FailureModel(link_p, node_p), PC.FailureModel(link_p, node_p)
    gj, gp = FAMILIES[family](JT), FAMILIES[family](PT)
    return JC.compile_plan(gj, backend, failures=fm_j), PC.compile_plan(gp, backend, failures=fm_p, device="cpu")


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jax_masks(pj, key, rounds, offset=0):
    """The JAX engine's draws of rounds offset..offset+rounds-1: {r: (node_active, edge_keep)}."""
    out = {}
    for r in range(offset, offset + rounds):
        ek, na = pj.round_masks(jax.random.fold_in(key, r))
        out[r] = (np.asarray(na), np.asarray(ek))
    return out


def _inject_rounds(monkeypatch, masks):
    """The port's rounds take ``masks[r]`` (a JAX draw) as their failure draws."""
    def fake(plan, seed, r):
        na, ek = masks[r]
        return torch.from_numpy(na.copy()), torch.from_numpy(ek.copy())

    monkeypatch.setattr(PE, "_round_masks", fake)


def _send_mats(g, masks, rounds, offset=0):
    """The numpy reference's effective operators of the same draws."""
    return [PGref.effective_send_matrix(g, masks[r][1][: g.n_edges], masks[r][0]) for r in range(offset, offset + rounds)]


# ------------------------------------------------------------ CommPlan layer
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spread_and_spread_min_match_jax(family, backend):
    pj, pp = _plans(family, backend)
    rng = np.random.default_rng(hash((family, backend)) % 1000)
    x = rng.random((pp.n, 3)).astype(np.float32)
    active = rng.random(pp.n) < 0.7
    edge_live = rng.random(pp.n_edges) < 0.6
    masks_j = dict(active=jnp.asarray(active), edge_live=jnp.asarray(edge_live))
    masks_p = dict(active=torch.as_tensor(active), edge_live=torch.as_tensor(edge_live))
    for kw_j, kw_p in (({}, {}), (masks_j, masks_p)):
        got = pp.spread(torch.as_tensor(x), **kw_p)
        np.testing.assert_allclose(_np(got), np.asarray(pj.spread(jnp.asarray(x), **kw_j)), **TOL)
        np.testing.assert_allclose(_np(got).sum(0), x.sum(0), rtol=1e-5)  # Mᵀ conserves mass
        one = pp.spread(torch.as_tensor(x[:, 0]), **kw_p)
        assert one.shape == (pp.n,)
        np.testing.assert_allclose(_np(one), np.asarray(pj.spread(jnp.asarray(x[:, 0]), **kw_j)), **TOL)
        np.testing.assert_array_equal(_np(pp.spread_min(torch.as_tensor(x), **kw_p)),
                                      np.asarray(pj.spread_min(jnp.asarray(x), **kw_j)))
    # the numpy reference of the min-exchange, on the same masks
    ek = np.ones(max(pp.n_edges, 1), bool)
    ek[: pp.n_edges] = edge_live
    np.testing.assert_array_equal(
        _np(pp.spread_min(torch.as_tensor(x), **masks_p)),
        PGref.min_spread_reference(pp.graph, x, ek[: pp.n_edges], active).astype(np.float32),
    )


@pytest.mark.parametrize("backend", BACKENDS)
def test_send_operator_is_the_transpose(backend):
    """Mᵀ, static and masked, is exactly M's transpose: the sparse masked
    round copies M's renormalised weights slot for slot."""
    pp = _plans("heavy_tail", backend, link_p=0.6, node_p=0.8)[1]
    from repro_torch.kernels.mix.sparse import BSR

    def dense(op):
        if not isinstance(op, BSR):
            return _np(op)
        bc, tiles, counts = (_np(t) for t in op)
        nb, bn = bc.shape[0], tiles.shape[-1]
        out = np.zeros((nb * bn, nb * bn), np.float32)
        for i in range(nb):
            for t in range(counts[i]):
                out[i * bn:(i + 1) * bn, bc[i, t] * bn:(bc[i, t] + 1) * bn] = tiles[i, t]
        return out[: pp.n, : pp.n]

    for seed in range(3):
        m = dense(pp.round_operator(torch.Generator().manual_seed(seed)))
        mt = dense(pp.send_operator(torch.Generator().manual_seed(seed)))
        np.testing.assert_array_equal(mt, m.T)
        np.testing.assert_allclose(mt.sum(0), 1.0, rtol=1e-6)
    clean = PC.compile_plan(pp.graph, backend, device="cpu")
    np.testing.assert_array_equal(dense(clean.send_operator()), dense(clean.round_operator()).T)


@pytest.mark.parametrize("backend", BACKENDS)
def test_send_operator_built_at_first_spread_directed(backend):
    """A plan builds Mᵀ at its first send-form round, not at compile time;
    on a directed graph (a cycle plus random arcs, so Mᵀ's block structure
    is not M's) spread still matches the JAX package's, masked and not."""
    rng = np.random.default_rng(3)
    n = 40
    a = (rng.random((n, n)) < 0.08).astype(np.float32)
    a[np.arange(n), (np.arange(n) + 1) % n] = 1.0
    np.fill_diagonal(a, 0.0)
    gj, gp = JT.from_adjacency(a, directed=True), PT.from_adjacency(a, directed=True)
    pj, pp = JC.compile_plan(gj, backend), PC.compile_plan(gp, backend, device="cpu")
    assert "_send" not in vars(pp)
    x = rng.random((n, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(pp.spread(torch.as_tensor(x))), np.asarray(pj.spread(jnp.asarray(x))), **TOL)
    for _ in range(3):
        ek, na = rng.random(pp.n_edges) < 0.7, rng.random(n) < 0.9
        got = pp.spread(torch.as_tensor(x), edge_live=torch.as_tensor(ek), active=torch.as_tensor(na))
        want = pj.spread(jnp.asarray(x), edge_live=jnp.asarray(ek), active=jnp.asarray(na))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        np.testing.assert_allclose(_np(got).sum(0), x.sum(0), rtol=1e-5)
    assert "_send" in vars(pp)


@pytest.mark.parametrize("backend", BACKENDS)
def test_spread_takes_the_rounds_failure_draw(backend):
    pp = _plans("kreg", backend, link_p=0.6, node_p=0.8)[1]
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(16, 2)).astype(np.float32))
    with pytest.raises(ValueError, match="Generator"):
        pp.spread(x)
    with pytest.raises(ValueError, match="Generator"):
        pp.spread_min(x)
    ek, na = pp.round_masks(torch.Generator().manual_seed(5))
    clean = PC.compile_plan(pp.graph, backend, device="cpu")
    got = pp.spread(x, torch.Generator().manual_seed(5))
    torch.testing.assert_close(got, clean.spread(x, active=na, edge_live=ek), rtol=0, atol=0)
    torch.testing.assert_close(got.sum(0), x.sum(0), rtol=1e-5, atol=1e-5)
    assert torch.equal(pp.spread_min(x, torch.Generator().manual_seed(5)),
                       clean.spread_min(x, active=na, edge_live=ek))
    # the JAX package's spread of the same masks
    pj = JC.compile_plan(FAMILIES["kreg"](JT), backend)
    want = pj.spread(jnp.asarray(x.numpy()), active=jnp.asarray(na.numpy()), edge_live=jnp.asarray(ek.numpy()))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# ----------------------------------------------- engine: exact on JAX draws
@pytest.mark.parametrize("link_p", [1.0, 0.6])
@pytest.mark.parametrize("backend", BACKENDS)
def test_push_sum_matches_jax(monkeypatch, backend, link_p):
    pj, pp = _plans("heavy_tail", backend, link_p=link_p)
    vals = np.linspace(-3.0, 5.0, 16).astype(np.float32)
    key = jax.random.PRNGKey(3)
    rounds = 24
    masks = _jax_masks(pj, key, rounds)
    _inject_rounds(monkeypatch, masks)
    want, want_tr = JG.push_sum(pj, vals, rounds, key if link_p < 1 else None, trace=True)
    got, got_tr = PG.push_sum(pp, vals, rounds, 0, trace=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(got_tr), np.asarray(want_tr), **TOL)
    mats = _send_mats(pp.graph, masks, rounds) if link_p < 1 else [PM.mixing_matrix(pp.graph)] * rounds
    np.testing.assert_allclose(_np(got), PGref.push_sum_failures(pp.graph, vals, mats), rtol=1e-4, atol=1e-5)
    spread = PG.spread_rounds(pp, vals, rounds, 0)
    np.testing.assert_allclose(_np(spread), np.asarray(JG.spread_rounds(pj, vals, rounds, key if link_p < 1 else None)),
                               **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_size_and_mean_degree_match_jax(monkeypatch, backend):
    pj, pp = _plans("ba", backend, link_p=0.7)
    key = jax.random.PRNGKey(8)
    _inject_rounds(monkeypatch, _jax_masks(pj, key, 20, offset=5))
    np.testing.assert_allclose(_np(PG.estimate_size(pp, 20, 0, leader=3, round_offset=5)),
                               np.asarray(JG.estimate_size(pj, 20, key, leader=3, round_offset=5)), **TOL)
    np.testing.assert_allclose(_np(PG.estimate_mean_degree(pp, 20, 0, round_offset=5)),
                               np.asarray(JG.estimate_mean_degree(pj, 20, key, round_offset=5)), **TOL)


@pytest.mark.parametrize("link_p", [1.0, 0.7])
@pytest.mark.parametrize("backend", BACKENDS)
def test_power_iteration_matches_jax(monkeypatch, backend, link_p):
    pj, pp = _plans("heavy_tail", backend, link_p=link_p)
    pi_r, ps_r = 25, 35
    key = jax.random.PRNGKey(11)
    masks = _jax_masks(pj, key, pi_r + ps_r)
    _inject_rounds(monkeypatch, masks)
    want = JG.power_iteration_norm(pj, pi_r, ps_r, key if link_p < 1 else None, leader=2)
    got = PG.power_iteration_norm(pp, pi_r, ps_r, 0, leader=2)
    for k in ("vnorm", "n_hat", "x"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), **TOL, err_msg=k)
    np.testing.assert_array_equal(_np(got["reached"]), np.asarray(want["reached"]))
    mats = _send_mats(pp.graph, masks, pi_r + ps_r) if link_p < 1 else None
    ref = PGref.power_iteration_norm_reference(pp.graph, pi_r, ps_r, leader=2, send_matrices=mats)
    np.testing.assert_allclose(_np(got["vnorm"]), ref["vnorm"], rtol=1e-4)
    np.testing.assert_allclose(_np(got["n_hat"]), ref["n_hat"], rtol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_estimate_all_matches_jax(monkeypatch, backend):
    pj, pp = _plans("kreg", backend, link_p=0.8, node_p=0.9)
    key = jax.random.PRNGKey(4)
    _inject_rounds(monkeypatch, _jax_masks(pj, key, 40))
    want = JG.estimate_all(pj, pi_rounds=15, ps_rounds=25, key=key)
    got = PG.estimate_all(pp, pi_rounds=15, ps_rounds=25, seed=0)
    for k in ("n_hat", "vnorm", "mean_degree"):
        np.testing.assert_allclose(_np(getattr(got, k)), np.asarray(getattr(want, k)), **TOL, err_msg=k)
    np.testing.assert_array_equal(_np(got.reached), np.asarray(want.reached))


def _inject_sketches(monkeypatch, sketches):
    monkeypatch.setattr(PE, "_draw_sketches", lambda seed, n, m, device: torch.as_tensor(np.array(sketches)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_leaderless_size_matches_jax(monkeypatch, backend):
    """The sketches injected too: JAX splits its key into (draw, round) keys."""
    pj, pp = _plans("heavy_tail", backend, link_p=0.7)
    key = jax.random.PRNGKey(6)
    k_draw, k_round = jax.random.split(key)
    sketches = jax.random.exponential(k_draw, (16, 32))
    masks = _jax_masks(pj, k_round, 12)
    _inject_rounds(monkeypatch, masks)
    _inject_sketches(monkeypatch, sketches)
    want, want_mins = JG.estimate_size_leaderless(pj, 12, key, return_sketches=True)
    got, got_mins = PG.estimate_size_leaderless(pp, 12, 0, return_sketches=True)
    np.testing.assert_array_equal(_np(got_mins), np.asarray(want_mins))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    ref = PGref.estimate_size_sketch_reference(
        pp.graph, np.asarray(sketches), 12, [(masks[r][1][: pp.n_edges], masks[r][0]) for r in range(12)])
    np.testing.assert_allclose(_np(got), ref, rtol=1e-5)


def _jax_walk_draws(pj, key, s, n_walks, walk_length):
    """The JAX walker's uniforms, per-step failure masks and resample row keys."""
    k_walk, k_resample = jax.random.split(key)
    uniforms, masks = [], []
    for k in jax.random.split(k_walk, walk_length):
        if pj is not None and pj.failures.active:
            k, k_fail = jax.random.split(k)
            ek, na = pj.round_masks(k_fail)
            masks.append((np.array(ek), np.array(na)))
        uniforms.append(np.array(jax.random.uniform(k, (s, n_walks))))
    return uniforms, masks, jax.random.split(k_resample, s)


def _inject_walk(monkeypatch, draws, n_walks):
    uniforms, masks, rows = draws
    uniforms, masks = list(uniforms), list(masks)
    monkeypatch.setattr(PW, "_uniforms", lambda gen, shape: torch.as_tensor(uniforms.pop(0)))
    monkeypatch.setattr(PW, "_step_masks", lambda plan, gen: tuple(torch.as_tensor(a) for a in masks.pop(0)))

    def resample(gen, ks):
        ksj = jnp.asarray(_np(ks))
        logits = jnp.where(ksj > 0, -jnp.log(jnp.maximum(ksj, 1e-30)), -1e30)
        idx = jax.vmap(lambda k, lg: jax.random.categorical(k, lg, shape=(n_walks,)))(rows, logits)
        return torch.as_tensor(np.array(idx)).long()

    monkeypatch.setattr(PW, "_resample", resample)


@pytest.mark.parametrize("with_failures", [False, True])
def test_walker_matches_jax_on_injected_draws(monkeypatch, with_failures):
    pj, pp = _plans("heavy_tail", "sparse", link_p=0.6 if with_failures else 1.0, node_p=0.9 if with_failures else 1.0)
    key = jax.random.PRNGKey(2)
    starts = np.arange(16)
    draws = _jax_walk_draws(pj, key, 16, 24, 10)
    _inject_walk(monkeypatch, draws, 24)
    want = JG.poll_degrees_device(pj.graph, starts, walk_length=10, n_walks=24, key=key, plan=pj)
    got = PG.poll_degrees_device(pp.graph, starts, walk_length=10, n_walks=24, seed=0, plan=pp)
    assert got.shape == (16, 24)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("leaderless", [False, True])
@pytest.mark.parametrize("mode", ["vnorm", "alpha", "degree"])
def test_gain_estimator_matches_jax(monkeypatch, mode, leaderless):
    """The three knowledge regimes, leader and leaderless, on the JAX key
    splits: (sketch key,) gossip key, walk key; every round's draw, the
    sketches and the walks injected."""
    pj, pp = _plans("heavy_tail", "sparse", link_p=0.7)
    pi_r = ps_r = 20
    key = jax.random.PRNGKey(9)
    k = key
    if leaderless:
        k_sketch, k = jax.random.split(key)
        _inject_sketches(monkeypatch, jax.random.exponential(k_sketch, (16, 32)))
    k_gossip, k_walk = jax.random.split(k)
    _inject_rounds(monkeypatch, _jax_masks(pj, k_gossip, pi_r + ps_r))
    if mode == "degree":
        _inject_walk(monkeypatch, _jax_walk_draws(pj, k_walk, 16, 64, 16), 64)
    kw = dict(pi_rounds=pi_r, ps_rounds=ps_r, mode=mode, leaderless=leaderless)
    want = JG.make_gain_estimator(pj, **kw)(key)
    est = PG.make_gain_estimator(pp, **kw)
    got = est(0)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert (est.reached is None) == leaderless


@pytest.mark.parametrize("mode", ["vnorm", "alpha"])
def test_under_budget_nodes_fall_back_to_unit_gain(mode):
    """ring-64, 8 rounds: the leader's mass reaches ≤ 8 hops a side; the
    others take gain 1.0, not the inverse of the underflow clamp."""
    pj = JC.compile_plan(JT.ring(64), "dense")
    pp = PC.compile_plan(PT.ring(64), "dense", device="cpu")
    want = np.asarray(JG.make_gain_estimator(pj, pi_rounds=8, ps_rounds=8, mode=mode)(jax.random.PRNGKey(0)))
    est = PG.make_gain_estimator(pp, pi_rounds=8, ps_rounds=8, mode=mode)
    got = _np(est(0))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[24:40], 1.0)
    assert got.max() < 100.0
    reached = _np(est.reached)
    assert reached[:8].all() and not reached[24:40].any()
    np.testing.assert_array_equal(reached, PGref.power_iteration_norm_reference(pp.graph, 8, 8)["reached"])


def test_gains_match_jax_and_refuse_two_sources():
    rng = np.random.default_rng(0)
    n_hat = rng.uniform(10, 30, 12).astype(np.float32)
    vnorm = rng.uniform(0.1, 0.5, 12).astype(np.float32)
    sample = rng.integers(1, 9, (12, 20)).astype(np.float32)
    for kw in (dict(vnorm=vnorm), dict(family_exponent=0.3), {}):
        np.testing.assert_allclose(
            _np(PG.gains_from_estimates(torch.as_tensor(n_hat), **{k: torch.as_tensor(v) if k == "vnorm" else v
                                                                   for k, v in kw.items()})),
            np.asarray(JG.gains_from_estimates(jnp.asarray(n_hat), **kw)), **TOL)
    np.testing.assert_allclose(_np(PG.gain_from_degree_sample(torch.as_tensor(n_hat), torch.as_tensor(sample))),
                               np.asarray(JG.gain_from_degree_sample(jnp.asarray(n_hat), jnp.asarray(sample))), **TOL)
    with pytest.raises(ValueError):
        PG.gains_from_estimates(torch.ones(4), vnorm=torch.ones(4), family_exponent=0.5)
    with pytest.raises(ValueError):
        PG.make_gain_estimator(PT.ring(8), pi_rounds=2, ps_rounds=2, mode="vnorm", family_exponent=0.5)
    with pytest.raises(ValueError):
        PG.make_gain_estimator(PC.compile_plan(PT.ring(8), device="cpu"), pi_rounds=2, ps_rounds=2, mode="other")


# --------------------------------------------- statistical, own generators
@pytest.mark.parametrize("family", ["kreg", "ba", "heavy_tail", "ring", "star"])
def test_power_iteration_converges_to_exact_vnorm(family):
    """80 + 160 rounds: every node's ‖v̂‖ within 5% of the spectral truth,
    n̂ within 1% (the JAX package's own test, on its graphs: n 16, seed 2)."""
    g = {
        "kreg": lambda: PT.random_k_regular(16, 4, seed=2),
        "ba": lambda: PT.barabasi_albert(16, 3, seed=2),
        "heavy_tail": lambda: PT.configuration_heavy_tail(16, 2.2, seed=2),
        "ring": lambda: PT.ring(16),
        "star": lambda: PT.star(16),
    }[family]()
    est = PG.power_iteration_norm(PC.compile_plan(g, "sparse", device="cpu"), 80, 160)
    exact = PM.v_steady_norm(g)
    assert np.abs(_np(est["vnorm"]) - exact).max() / exact < 5e-2, family
    assert np.abs(_np(est["n_hat"]) - g.n).max() / g.n < 1e-2


@pytest.mark.parametrize("backend", BACKENDS)
def test_push_sum_on_own_draws_replays_the_numpy_reference(backend):
    """The port's own failure draws, round r from ``round_generator(seed,
    r)``: replayed into the numpy reference, the same numbers; and the
    ratio converges to the true average under failures."""
    pp = _plans("kreg", backend, link_p=0.6, node_p=0.9)[1]
    vals = np.arange(16, dtype=np.float32)
    got = PG.push_sum(pp, vals, 64, 7)
    mats = []
    for r in range(64):
        ek, na = pp.round_masks(PG.round_generator(7, r))
        mats.append(PGref.effective_send_matrix(pp.graph, _np(ek)[: pp.n_edges], _np(na)))
    np.testing.assert_allclose(_np(got), PGref.push_sum_failures(pp.graph, vals, mats), rtol=1e-4, atol=1e-5)
    assert np.abs(_np(got) - vals.mean()).max() < 1e-2 * vals.mean()
    # a round's draws depend on (seed, round) alone
    a = pp.round_masks(PG.round_generator(7, 3))
    b = pp.round_masks(PG.round_generator(7, 3))
    c = pp.round_masks(PG.round_generator(7, 4))
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and not torch.equal(a[0], c[0])


def test_leaderless_size_is_unbiased_on_own_draws():
    """Once flooded every node holds the n minima: n̂ = (m−1)/Σ min is
    unbiased, relative noise ≈ 1/√(m−2); the mean over 40 seeds within
    4 standard errors."""
    plan = PC.compile_plan(PT.random_k_regular(24, 4, seed=0), "sparse", failures=PC.FailureModel(0.8), device="cpu")
    est = np.array([_np(PG.estimate_size_leaderless(plan, 16, s, n_sketches=16)) for s in range(40)])
    assert np.ptp(est, axis=1).max() < 1e-4  # flooded: every node the same estimate
    se = 24 / np.sqrt(16 - 2) / np.sqrt(40)
    assert abs(est[:, 0].mean() - 24) < 4 * se


def test_walker_on_own_draws():
    """The 1/k resample pulls the hub-biased visit sample back towards the
    true mean degree; over failure draws the sample stays finite and close;
    sinks are guarded."""
    g = PT.configuration_heavy_tail(256, 2.2, seed=3)
    raw = PG.poll_degrees_device(g, 0, walk_length=15, n_walks=600, seed=0, correct_bias=False, device="cpu")
    fixed = PG.poll_degrees_device(g, 0, walk_length=15, n_walks=600, seed=0, device="cpu")
    true_mean = g.degrees.mean()
    assert raw.shape == fixed.shape == (600,)
    assert float(raw.mean()) > true_mean
    assert abs(float(fixed.mean()) - true_mean) < abs(float(raw.mean()) - true_mean)
    plan = PC.compile_plan(g, "sparse", failures=PC.FailureModel(link_p=0.5, node_p=0.9), device="cpu")
    ks = _np(PG.poll_degrees_device(g, 0, walk_length=20, n_walks=400, seed=4, plan=plan))
    assert np.isfinite(ks).all() and (ks > 0).all()
    assert abs(ks.mean() - true_mean) / true_mean < 0.5
    a = PG.poll_degrees_device(g, 0, walk_length=8, n_walks=32, seed=5, device="cpu")
    b = PG.poll_degrees_device(g, 0, walk_length=8, n_walks=32, seed=5, plan=PC.compile_plan(g, "sparse", device="cpu"))
    assert torch.equal(a, b)


def test_walker_degree_zero_guards():
    a = np.zeros((4, 4), np.float32)
    a[0, 1] = a[1, 0] = 1.0
    a[0, 2] = 1.0  # 0 receives from 2: walks from 0 can land on 2 and stick
    a[3, 1] = 1.0
    g = PT.from_adjacency(a, directed=True)
    with pytest.raises(ValueError, match="no neighbours"):
        PG.poll_degrees_device(g, 2, walk_length=3, n_walks=5, seed=0, device="cpu")
    assert PG.poll_degrees_device(g, 0, walk_length=6, n_walks=64, seed=1, correct_bias=False,
                                  device="cpu").shape == (64,)
    sample = _np(PG.poll_degrees_device(g, 0, walk_length=6, n_walks=64, seed=1, device="cpu"))
    assert np.isfinite(sample).all() and (sample > 0).all()


# -------------------------------------------------------------- diagnostics
def test_diagnostics_match_jax():
    gj, gp = JT.random_k_regular(32, 4, seed=0), PT.random_k_regular(32, 4, seed=0)
    want = JG.convergence_report(JC.compile_plan(gj, "dense"), 64)
    got = PG.convergence_report(PC.compile_plan(gp, "dense", device="cpu"), 64)
    np.testing.assert_allclose(got["rel_err"], want["rel_err"], rtol=1e-4, atol=1e-6)
    assert got["rounds_to_1pct"] == want["rounds_to_1pct"] and 0 < got["rounds_to_1pct"] < 64
    assert got["predicted_rate"] == want["predicted_rate"]
    assert abs(got["fitted_rate"] - want["fitted_rate"]) < 1e-3
    lam2 = got["predicted_rate"]
    assert lam2**1.4 < got["fitted_rate"] < lam2**0.6
    # the array helpers, on the same arrays
    err = np.abs(np.random.default_rng(0).normal(size=40)) * 0.8 ** np.arange(40)
    assert PG.fit_contraction_rate(err) == JG.fit_contraction_rate(err)
    assert np.isnan(PG.fit_contraction_rate(np.zeros(8)))
    tr, truth = np.random.default_rng(1).random((5, 7)), np.linspace(1, 2, 7)
    np.testing.assert_array_equal(PG.relative_error_trace(tr, truth), JG.relative_error_trace(tr, truth))
    np.testing.assert_allclose(PG.size_error_trace(PC.compile_plan(gp, "sparse", device="cpu"), 10),
                               got["rel_err"][:10], rtol=1e-4, atol=1e-6)


# --------------------------------------------------- the numpy copy, bitwise
def _ref_cases():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=12)
    sk = rng.exponential(size=(12, 8))
    fired = rng.integers(-1, 20, 30)
    keep = rng.random(30) < 0.7
    ek, na = rng.random(40) < 0.7, rng.random(12) < 0.9
    return {
        "push_sum": lambda G, g: G.push_sum(g, vals, 9),
        "effective_send_matrix": lambda G, g: G.effective_send_matrix(g, ek[: g.n_edges], na),
        "push_sum_failures": lambda G, g: G.push_sum_failures(
            g, np.stack([vals, vals**2], 1), [G.effective_send_matrix(g, ek[: g.n_edges], na)] * 3),
        "power_iteration_norm_reference": lambda G, g: G.power_iteration_norm_reference(g, 6, 7, leader=4)["vnorm"],
        "min_spread_reference": lambda G, g: G.min_spread_reference(g, sk, ek[: g.n_edges], na),
        "estimate_size_sketch_reference": lambda G, g: G.estimate_size_sketch_reference(g, sk, 4),
        "event_mix_reference": lambda G, g: G.event_mix_reference(g, vals, fired % g.n_edges, keep),
        "event_spread_reference": lambda G, g: G.event_spread_reference(g, sk, fired % g.n_edges, keep),
        "event_spread_min_reference": lambda G, g: G.event_spread_min_reference(g, sk, fired, keep),
        "push_sum_events_reference": lambda G, g: G.push_sum_events_reference(g, vals, fired, keep),
        "estimate_size": lambda G, g: G.estimate_size(g, 7, leader=2),
        "estimate_mean_degree": lambda G, g: G.estimate_mean_degree(g, 7),
        "poll_degrees": lambda G, g: G.poll_degrees(g, 3, walk_length=6, n_walks=50, seed=4),
    }


@pytest.mark.parametrize("fn", sorted(_ref_cases()))
def test_numpy_reference_copy_matches_jax(fn):
    call = _ref_cases()[fn]
    got = call(PGref, PT.barabasi_albert(12, 2, seed=0))
    want = call(JGref, JT.barabasi_albert(12, 2, seed=0))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ plans
def test_as_plan_recompiles_without_data_sizes():
    g = PT.random_k_regular(12, 4, seed=0)
    weighted = PC.compile_plan(g, "sparse", data_sizes=np.linspace(1, 3, 12), failures=PC.FailureModel(0.7),
                               device="cpu")
    plan = PG.as_plan(weighted)
    assert plan.data_sizes is None and plan.failures == weighted.failures and plan.backend == "sparse"
    torch.testing.assert_close(plan.bsr.tiles, PC.compile_plan(g, "sparse", device="cpu").bsr.tiles, rtol=0, atol=0)
    assert PG.as_plan(plan) is plan
    assert PG.as_plan(g, device="cpu").backend == "dense"

    # a PlanSchedule (ported): recompiled without data sizes, as the JAX
    # package's as_plan does, its failures and round map kept
    graphs = PT.churn_sequence(g, 3, 0.3, seed=1)
    sched = PC.compile_schedule(graphs, "sparse", data_sizes=np.linspace(1, 3, 12), failures=PC.FailureModel(0.7),
                                round_map=PC.cyclic_map(2), device="cpu")
    est = PG.as_plan(sched)
    want = JG.as_plan(JC.compile_schedule(JT.churn_sequence(JT.random_k_regular(12, 4, seed=0), 3, 0.3, seed=1),
                                          "sparse", data_sizes=np.linspace(1, 3, 12), failures=JC.FailureModel(0.7),
                                          round_map=JC.cyclic_map(2)))
    assert est.data_sizes is None is want.data_sizes and est.failures == sched.failures
    assert est.round_map == sched.round_map and est.k == want.k == 3 and est.n_edges_env == want.n_edges_env
    for p_est, p_plain in zip(est.plans, graphs):
        torch.testing.assert_close(p_est.bsr.tiles, PC.compile_plan(p_plain, "sparse", device="cpu").bsr.tiles,
                                   rtol=0, atol=0)
    assert PG.as_plan(est) is est

    class ShardedCommPlan:  # the sharded plan of item 17
        pass

    with pytest.raises(NotImplementedError, match="item 17"):
        PG.as_plan(ShardedCommPlan())
