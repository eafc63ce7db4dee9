"""Event-driven (asynchronous) gossip of the port against the JAX package's:
Poisson edge clocks, the pairwise event operators, the barrier-free engine
protocols, ``run_event_trajectory``, fig9 and the CLI's ``--async``.

- The numpy copies (``poisson_event_stream``, ``batch_events_by_color``,
  ``PlanSchedule.event_stream``) are bitwise the JAX package's arrays, for
  every rate form, with padding, and raise on the same inputs.
- The event tables are bitwise; the event operators match the JAX ones on
  every backend at rtol 1e-6, on the JAX draws: threefry's per-event
  ``fold_in(key, i)`` cannot be replayed in torch, so the JAX package's
  flags (``plan.event_keep(fold_in(key, i))``) are injected through the
  one hook the port draws from (``commplan.event_flags``).
- ``run_event_trajectory`` against the JAX executor (ring-8 and BA-16, the
  reduced MLP) on the JAX run's flags: the integer channels, the clocks,
  the staleness and its histogram exactly, the losses and the params at
  rtol 1e-4 / atol 1e-5 (ROADMAP.md Queue 3), int8 with quantisation-code
  flips counted (each within one code step).  Chunked and padded runs are
  bitwise the plain run; the port's own draws are held statistically.
- fig9 call for call against the JAX package's fig9, its record keys those of
  ``BENCH_async.json``; the CLI's ``--async`` variants and errors.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.gossip as JG  # noqa: E402
from benchmarks import fig9_async as jfig9  # noqa: E402
from repro import fed as JF  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.core import commplan as JC  # noqa: E402
from repro.core import compress as JCC  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.data import batch_index_schedule, mnist_like, node_datasets  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402
from repro_torch import fed as PF  # noqa: E402
from repro_torch import gossip as PG  # noqa: E402
from repro_torch import optim as PO  # noqa: E402
from repro_torch.benchmarks import common as pcommon  # noqa: E402
from repro_torch.benchmarks import fig9_async as pfig9  # noqa: E402
from repro_torch.convert import state_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import decavg as PD  # noqa: E402
from repro_torch.core import gossip as PRef  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.compress import Compression  # noqa: E402
from repro_torch.fed import executor as PX  # noqa: E402
from repro_torch.gossip import engine as PE  # noqa: E402
from repro_torch.kernels.mix import chunk_bounds, quant_mix_pair  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import paper_models as PPM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
OPS = dict(rtol=1e-6, atol=1e-7)  # an event operator
TRAJ = dict(rtol=1e-4, atol=1e-5)  # a trajectory (ROADMAP.md Queue 3)
N, PER, BS, BL, HIDDEN = 8, 48, 8, 2, (32,)
GRAPHS = {
    "ring12": lambda T: T.ring(12),
    "kreg12": lambda T: T.random_k_regular(12, 4, seed=0),
    "ba16": lambda T: T.barabasi_albert(16, 3, seed=1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU products run fastest on one thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jax_flags(plan_j, key, stream, schedule=False):
    """The JAX package's per-event draws: ``event_keep(fold_in(key, i))``
    (a schedule's: with the window's plan id folded in, as ``_scan_events``)."""
    idx = jnp.arange(stream.envelope)
    if not schedule:
        return np.asarray(jax.vmap(lambda i: plan_j.event_keep(jax.random.fold_in(key, i)))(idx))
    out = []
    for i, t in enumerate(stream.times):
        k = plan_j.event_key(jax.random.fold_in(key, i), t)
        out.append(bool(plan_j.select(plan_j._window(t)).event_keep(k)))
    return np.array(out)


def _inject(monkeypatch, flags):
    monkeypatch.setattr(PC, "event_flags", lambda plan, seed, stream: None if flags is None else flags.copy())


# ------------------------------------------------------------ the samplers
@pytest.mark.parametrize("rate", ["scalar", "vector", "matrix"])
@pytest.mark.parametrize("family", sorted(GRAPHS))
def test_poisson_event_stream_matches_jax(family, rate):
    gj, gp = GRAPHS[family](JT), GRAPHS[family](PT)
    r = {"scalar": 1.5, "vector": np.linspace(0.2, 2.0, gj.n_edges), "matrix": 0.7 * gj.adjacency}[rate]
    for envelope in (None, 400):
        a = JT.poisson_event_stream(gj, 6.0, r, seed=3, envelope=envelope)
        b = PT.poisson_event_stream(gp, 6.0, r, seed=3, envelope=envelope)
        assert (a.n_events, a.envelope, a.horizon) == (b.n_events, b.envelope, b.horizon)
        for f in ("times", "edges", "rates"):
            got, want = getattr(b, f), getattr(a, f)
            assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert b.messages_per_event == 2 and np.all(b.edges[b.n_events:] == -1)


def test_poisson_event_stream_errors_match_jax():
    cases = [
        (lambda T: T.ring(8), dict(horizon=50.0, rate=4.0, envelope=3), "envelope"),
        (lambda T: T.ring(8), dict(horizon=0.0), "horizon"),
        (lambda T: T.ring(8), dict(horizon=1.0, rate=np.full(8, -1.0)), "non-negative"),
        (lambda T: T.ring(8), dict(horizon=1.0, rate=np.ones(5)), "per-edge"),
        (lambda T: T.ring(4), dict(horizon=1.0, rate=np.triu(np.ones((4, 4)), 1)), "symmetric"),
        (lambda T: T.ring(4), dict(horizon=1.0, rate=np.ones((2, 2, 2))), "rate must be"),
        (lambda T: T.Graph(np.triu(np.ones((4, 4), np.float32), 1), name="dag", directed=True),
         dict(horizon=1.0), "undirected"),
    ]
    for build, kw, match in cases:
        for T in (JT, PT):
            with pytest.raises(ValueError, match=match):
                T.poisson_event_stream(build(T), **kw)
    with pytest.raises(ValueError, match="n_events"):
        PT.EventStream(np.zeros(2, np.float32), np.zeros(2, np.int32), 3, 1.0, np.ones(1))


@pytest.mark.parametrize("max_width", [None, 3])
@pytest.mark.parametrize("family", sorted(GRAPHS))
def test_batch_events_by_color_matches_jax(family, max_width):
    gj, gp = GRAPHS[family](JT), GRAPHS[family](PT)
    sj = JT.poisson_event_stream(gj, 4.0, 1.0, seed=5, envelope=200)
    sp = PT.poisson_event_stream(gp, 4.0, 1.0, seed=5, envelope=200)
    a, b = JT.batch_events_by_color(sj, gj, max_width), PT.batch_events_by_color(sp, gp, max_width)
    assert a.n_events == b.n_events == sp.n_events and (a.n_batches, a.width) == (b.n_batches, b.width)
    assert np.array_equal(a.edges, b.edges) and np.array_equal(a.event_index, b.event_index)
    empty = PT.EventStream(np.full(3, 4.0, np.float32), np.full(3, -1, np.int32), 0, 4.0, np.ones(gp.n_edges))
    e = PT.batch_events_by_color(empty, gp)
    assert e.n_batches == 1 and e.width == 1 and e.n_events == 0 and e.edges[0, 0] == -1


# ---------------------------------------------------------- the operators
@pytest.mark.parametrize("backend", PC.BACKENDS)
def test_event_tables_match_jax(backend):
    g = GRAPHS["ba16"]
    sizes = np.linspace(1.0, 3.0, 16)
    for s in (None, sizes):
        pj = JC.compile_plan(g(JT), backend, data_sizes=s)
        pp = PC.compile_plan(g(PT), backend, data_sizes=s, device="cpu")
        assert np.array_equal(_np(pp.event_uv), np.asarray(pj.event_uv))
        assert np.array_equal(_np(pp.event_w), np.asarray(pj.event_w))
        w = _np(pp.event_w)
        m2 = _np(pp.event_m2)
        assert np.array_equal(m2[:, 0, 1], w[:, 0]) and np.array_equal(m2[:, 1, 0], w[:, 1])
        assert np.array_equal(m2[:, 0, 0], np.float32(1) - w[:, 0])
    edgeless = PC.compile_plan(PT.from_adjacency(np.zeros((3, 3), np.float32)), backend, device="cpu")
    assert edgeless.event_uv.shape == (1, 2) and float(edgeless.event_w.abs().sum()) == 0.0
    if backend != "ppermute":
        directed = PC.compile_plan(PT.from_adjacency(np.triu(np.ones((4, 4), np.float32), 1), directed=True),
                                   backend, device="cpu")
        assert directed.event_uv is None
        with pytest.raises(ValueError, match="undirected"):
            directed.event_mix(torch.zeros(4, 2), 0)


def _tree(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n, 3, 2)).astype(np.float32), "b": rng.standard_normal((n, 5)).astype(np.float32)}


@pytest.mark.parametrize("backend", PC.BACKENDS)
def test_event_ops_match_jax_on_injected_flags(backend):
    """A sequence of events at link_p 0.6 / node_p 0.9 on the JAX draws:
    event_mix on a dict tree and a flat buffer, event_spread and
    event_spread_min, each event against the JAX operator."""
    g = GRAPHS["kreg12"]
    fm = dict(link_p=0.6, node_p=0.9)
    pj = JC.compile_plan(g(JT), backend, failures=JC.FailureModel(**fm))
    pp = PC.compile_plan(g(PT), backend, failures=PC.FailureModel(**fm), device="cpu")
    stream = JT.poisson_event_stream(g(JT), 3.0, 1.0, seed=2, envelope=80)
    key = jax.random.PRNGKey(4)
    flags = _jax_flags(pj, key, stream)
    assert 0 < flags[: stream.n_events].sum() < stream.n_events
    tree = _tree(12)
    xj, xt = jax.tree_util.tree_map(jnp.asarray, tree), {k: torch.tensor(v) for k, v in tree.items()}
    vals = np.random.default_rng(1).exponential(size=(12, 4)).astype(np.float32)
    sj, st, mj, mt = jnp.asarray(vals), torch.tensor(vals), jnp.asarray(vals), torch.tensor(vals)
    flat_t = torch.tensor(vals)
    flat_j = jnp.asarray(vals)
    for i, e in enumerate(stream.edges):
        k = jax.random.fold_in(key, i)
        xj, xt = pj.event_mix(xj, int(e), k), pp.event_mix(xt, int(e), bool(flags[i]))
        flat_j, flat_t = pj.event_mix(flat_j, int(e), k), pp.event_mix(flat_t, int(e), bool(flags[i]))
        sj, st = pj.event_spread(sj, int(e), k), pp.event_spread(st, int(e), bool(flags[i]))
        mj, mt = pj.event_spread_min(mj, int(e), k), pp.event_spread_min(mt, int(e), bool(flags[i]))
    for name in tree:
        np.testing.assert_allclose(_np(xt[name]), np.asarray(xj[name]), **OPS, err_msg=name)
    np.testing.assert_allclose(_np(flat_t), np.asarray(flat_j), **OPS)
    np.testing.assert_allclose(_np(st), np.asarray(sj), **OPS)
    assert np.array_equal(_np(mt), np.asarray(mj))  # a min is exact
    np.testing.assert_allclose(_np(st).sum(0), vals.sum(0), rtol=1e-5)  # failures never destroy mass
    ref = PRef.event_spread_reference(g(PT), vals, stream.edges, flags)
    np.testing.assert_allclose(_np(st), ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="keep flag"):
        pp.event_mix(flat_t, 0)


def test_event_padding_identity_rate1_parity_and_backends():
    """Edge −1 and a failed draw are the exact identity; one event an edge,
    linearised, sums to the synchronous operator (Σ_e B_e = M − I, the
    rate-1 parity); the three backends agree bitwise."""
    g = PT.barabasi_albert(14, 3, seed=2)
    plans = [PC.compile_plan(g, b, device="cpu") for b in PC.BACKENDS]
    x = torch.tensor(np.random.default_rng(2).normal(size=(14, 3)).astype(np.float32))
    failing = PC.compile_plan(g, "dense", failures=PC.FailureModel(0.5), device="cpu")
    for op in ("event_mix", "event_spread", "event_spread_min"):
        assert torch.equal(getattr(plans[0], op)(x, -1), x)
        assert torch.equal(getattr(failing, op)(x, 3, False), x)
        for e in (0, g.n_edges - 1):
            outs = [getattr(p, op)(x, e) for p in plans]
            assert all(torch.equal(outs[0], o) for o in outs[1:]), op
    for p in plans:
        m = p.n_edges
        lhs = sum(p.event_mix(x, e) for e in range(m)) - (m - 1) * x
        torch.testing.assert_close(lhs, p.mix(x) if p.backend != "ppermute" else plans[0].mix(x), atol=1e-4, rtol=0)
        lhs = sum(p.event_spread(x, e) for e in range(m)) - (m - 1) * x
        torch.testing.assert_close(lhs, plans[0].spread(x), atol=1e-4, rtol=0)
    with pytest.raises(IndexError):
        plans[0].event_mix(x, g.n_edges)


@pytest.mark.parametrize("link_p,node_p", [(1.0, 1.0), (0.8, 0.9)])
def test_event_mix_batch_is_bitwise_sequential_and_matches_jax(link_p, node_p):
    """Colour-batched events replay the sequential ones bit for bit, with
    and without failure draws (tests/test_sharded_plan.py's property), and
    match the JAX ``event_mix_batch`` on its draws."""
    gj, gp = JT.random_k_regular(12, 4, seed=1), PT.random_k_regular(12, 4, seed=1)
    stream = PT.poisson_event_stream(gp, 3.0, 1.0, seed=5)
    batches = PT.batch_events_by_color(stream, gp)
    el = gp.edge_list()
    for row in batches.edges:
        touched = [v for e in row if e >= 0 for v in (el[e, 0], el[e, 1])]
        assert len(touched) == len(set(touched)), row
    pj = JC.compile_plan(gj, "sparse", failures=JC.FailureModel(link_p, node_p))
    pp = PC.compile_plan(gp, "sparse", failures=PC.FailureModel(link_p, node_p), device="cpu")
    key = jax.random.PRNGKey(3)
    flags = _jax_flags(pj, key, stream) if pp.failures.active else None
    params = _tree(12)
    seq = {k: torch.tensor(v) for k, v in params.items()}
    for i in range(stream.n_events):
        seq = pp.event_mix(seq, int(stream.edges[i]), None if flags is None else bool(flags[i]))
    bat, bat_j = {k: torch.tensor(v) for k, v in params.items()}, jax.tree_util.tree_map(jnp.asarray, params)
    for b in range(batches.n_batches):
        idx = batches.event_index[b]
        keeps = None if flags is None else flags[np.maximum(idx, 0)] & (idx >= 0)
        bat = pp.event_mix_batch(bat, batches.edges[b], keeps)
        keys = None
        if pj.failures.active:
            keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.asarray(np.maximum(idx, 0)))
        bat_j = pj.event_mix_batch(bat_j, jnp.asarray(batches.edges[b]), keys)
    for name in params:
        assert torch.equal(seq[name], bat[name]), name
        np.testing.assert_allclose(_np(bat[name]), np.asarray(bat_j[name]), **OPS, err_msg=name)
    with pytest.raises(ValueError, match="matching"):
        PD.mix_pytree_pairwise_batch(torch.zeros(4, 2), [0, 1], [1, 2], torch.ones(2), torch.ones(2))


def test_draw_event_flags_depend_on_seed_and_index_alone():
    fm = PC.FailureModel(0.7, 0.8)
    long, short = PC.draw_event_flags(fm, 11, 5000), PC.draw_event_flags(fm, 11, 1200)
    assert np.array_equal(long[:1200], short)
    assert not np.array_equal(long, PC.draw_event_flags(fm, 12, 5000))
    p = 0.7 * 0.8 * 0.8
    assert abs(long.mean() - p) < 5 * np.sqrt(p * (1 - p) / 5000)
    assert PC.draw_event_flags(PC.FailureModel(), 11, 10) is None
    link_only = PC.draw_event_flags(PC.FailureModel(0.3), 2, 4000)
    assert abs(link_only.mean() - 0.3) < 5 * np.sqrt(0.21 / 4000)


# -------------------------------------------------------------- schedules
def _schedules(backend, link_p=1.0, node_p=1.0, k=3):
    gj = JT.churn_sequence(JT.random_k_regular(12, 4, seed=0), k, 0.3, seed=2)
    gp = PT.churn_sequence(PT.random_k_regular(12, 4, seed=0), k, 0.3, seed=2)
    sj = JC.compile_schedule(gj, backend, failures=JC.FailureModel(link_p, node_p), round_map=JC.cyclic_map(1))
    sp = PC.compile_schedule(gp, backend, failures=PC.FailureModel(link_p, node_p), round_map=PC.cyclic_map(1),
                             device="cpu")
    return sj, sp


@pytest.mark.parametrize("k", [1, 3])
def test_schedule_event_stream_matches_jax(k):
    sj, sp = _schedules("dense", k=k)
    a, b = sj.event_stream(5.5, rate=1.3, seed=4), sp.event_stream(5.5, rate=1.3, seed=4)
    assert a.n_events == b.n_events and a.horizon == b.horizon
    for f in ("times", "edges", "rates"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("backend", PC.BACKENDS)
def test_size1_schedule_events_bitwise_static_plan(backend):
    g = PT.random_k_regular(12, 4, seed=0)
    fm = PC.FailureModel(0.7)
    plan = PC.compile_plan(g, backend, failures=fm, device="cpu")
    sched = PC.compile_schedule([g], backend, failures=fm, device="cpu")
    stream = sched.event_stream(3.0, seed=1)
    assert sched.event_key(9, 2.5) == 9
    assert np.array_equal(PC.event_flags(plan, 9, stream), PC.event_flags(sched, 9, stream))
    x = torch.tensor(np.random.default_rng(0).normal(size=(12, 4)).astype(np.float32))
    for op in ("spread", "spread_min"):
        a = PE._scan_events(plan, op, x, stream, 9)
        b = PE._scan_events(sched, op, x, stream, 9)
        assert torch.equal(a, b), op
    for i in range(min(stream.n_events, 20)):
        e, t = int(stream.edges[i]), stream.times[i]
        assert torch.equal(plan.event_mix(x, e, True), sched.event_mix(x, e, t, True))


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_schedule_events_match_jax_on_injected_flags(monkeypatch, backend):
    """K = 3 churned schedule at link_p 0.7: each event under its window's
    plan, the JAX flags (plan id folded in) injected: push-sum and the min
    exchange against the JAX engine, the views' event ops against the
    static plans'."""
    sj, sp = _schedules(backend, link_p=0.7)
    stream = sj.event_stream(4.0, seed=3)
    key = jax.random.PRNGKey(6)
    flags = _jax_flags(sj, key, stream, schedule=True)
    _inject(monkeypatch, flags)
    vals = np.random.default_rng(3).normal(size=(12, 2)).astype(np.float32)
    got = PG.push_sum_events(sp, vals, stream, seed=0)
    want = JG.push_sum_events(sj, jnp.asarray(vals), stream, key)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    got = PG.spread_events(sp, vals, stream, seed=0)
    want = JG.spread_events(sj, jnp.asarray(vals), stream, key)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    x = torch.tensor(vals)
    cj, cp = _schedules(backend)
    for w in (0, 1, 2):
        for e in (0, sp.plans[sp.plan_index(w)].n_edges - 1, -1):
            assert torch.equal(sp.event_mix(x, e, w + 0.5, True), sp.select(w).event_mix(x, e, True))
            np.testing.assert_allclose(_np(cp.event_spread(x, e, w + 0.5)),
                                       np.asarray(cj.event_spread(jnp.asarray(vals), e, w + 0.5)), **OPS)
    # the port's own draws: independent seeds per window's plan, the static plan's at K = 1
    own = PC.event_flags(sp, 5, stream)
    assert own.shape == (stream.envelope,) and 0.5 < own.mean() < 0.9
    assert len({sp.event_key(5, t) for t in stream.times[: stream.n_events]}) == 3


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("backend", ["dense", "sparse", "ppermute"])
def test_engine_event_protocols_match_jax_and_reference(monkeypatch, backend):
    """spread_events and push_sum_events at link_p 0.6 / node_p 0.9 on the
    JAX flags; estimate_size_leaderless_events on the JAX sketches and
    flags; each against the JAX engine and the numpy references."""
    gj, gp = GRAPHS["ba16"](JT), GRAPHS["ba16"](PT)
    fm = dict(link_p=0.6, node_p=0.9)
    pj = JC.compile_plan(gj, backend, failures=JC.FailureModel(**fm))
    pp = PC.compile_plan(gp, backend, failures=PC.FailureModel(**fm), device="cpu")
    stream = JT.poisson_event_stream(gj, 8.0, 1.0, seed=6, envelope=400)
    key = jax.random.PRNGKey(8)
    flags = _jax_flags(pj, key, stream)
    _inject(monkeypatch, flags)
    vals = np.random.default_rng(5).normal(size=16).astype(np.float32)
    got = PG.spread_events(pp, vals, stream, seed=0)
    np.testing.assert_allclose(_np(got), np.asarray(JG.spread_events(pj, jnp.asarray(vals), stream, key)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(got), PRef.event_spread_reference(gp, vals, stream.edges, flags),
                               rtol=1e-5, atol=1e-6)
    got = PG.push_sum_events(pp, vals, stream, seed=0)
    np.testing.assert_allclose(_np(got), np.asarray(JG.push_sum_events(pj, jnp.asarray(vals), stream, key)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(got), PRef.push_sum_events_reference(gp, vals, stream.edges, flags),
                               rtol=1e-4, atol=1e-5)
    # leaderless: JAX draws its sketches from split(key)[0] and keys its
    # events on split(key)[1]
    k_draw, k_event = jax.random.split(key)
    sketches = np.asarray(jax.random.exponential(k_draw, (16, 24)))
    monkeypatch.setattr(PE, "_draw_sketches", lambda seed, n, m, device: torch.tensor(sketches, device=device))
    _inject(monkeypatch, _jax_flags(pj, k_event, stream))
    n_hat, mins = PG.estimate_size_leaderless_events(pp, stream, 0, n_sketches=24, return_sketches=True)
    n_j, mins_j = JG.estimate_size_leaderless_events(pj, stream, key, n_sketches=24, return_sketches=True)
    assert np.array_equal(_np(mins), np.asarray(mins_j))
    np.testing.assert_allclose(_np(n_hat), np.asarray(n_j), rtol=1e-6)
    ref = PRef.event_spread_min_reference(gp, sketches, stream.edges, _jax_flags(pj, k_event, stream))
    np.testing.assert_allclose(_np(mins), ref, rtol=1e-6)


def test_engine_event_protocols_on_own_draws():
    """Clean: push-sum converges to the average and the leaderless n̂
    lands near n; a failing plan needs a seed; mass is kept under the
    port's own draws."""
    g = PT.random_k_regular(24, 4, seed=3)
    stream = PT.poisson_event_stream(g, 14.0, 1.0, seed=5)
    vals = np.random.default_rng(4).normal(size=24)
    est = _np(PG.push_sum_events(PC.compile_plan(g, device="cpu"), vals, stream))
    assert np.abs(est - vals.mean()).max() < 0.05
    np.testing.assert_allclose(est, PRef.push_sum_events_reference(g, vals, stream.edges), rtol=1e-4, atol=1e-5)
    n_hat = _np(PG.estimate_size_leaderless_events(PC.compile_plan(g, device="cpu"), stream, 7, n_sketches=64))
    assert abs(np.median(n_hat) - 24) / 24 < 0.3
    failing = PC.compile_plan(g, "sparse", failures=PC.FailureModel(0.6, 0.9), device="cpu")
    with pytest.raises(ValueError, match="seed"):
        PG.spread_events(failing, vals, stream)
    out = _np(PG.spread_events(failing, vals, stream, seed=3))
    assert abs(out.sum() - vals.sum()) < 1e-4
    again = _np(PG.spread_events(failing, vals, stream, seed=3))
    assert np.array_equal(out, again)
    with pytest.raises(ValueError, match="seed"):
        PG.estimate_size_leaderless_events(failing, stream, None)


def test_quant_pair_plain_is_the_jax_compressed_event():
    """The pair exchange's plain version (``quant_mix_pair`` on CPU tensors)
    against the JAX package's compressed event (``compressed_mix_with``
    around ``event_mix`` over the whole ensemble, jitted, the other rows
    frozen): scales and H' bitwise, X' to fp32 rounding; a failed draw is
    the identity in both."""
    g = PT.barabasi_albert(10, 2, seed=0)
    pj = JC.compile_plan(JT.barabasi_albert(10, 2, seed=0), "dense")
    pp = PC.compile_plan(g, "dense", device="cpu")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((10, 700)) * 0.4).astype(np.float32)
    h = (rng.standard_normal((10, 700)) * 0.3).astype(np.float32)
    sizes = (500, 1, 199)
    edges = tuple(chunk_bounds(sizes, 128).tolist())
    for codec, gamma in (("int8", 1.0), ("fp8", 0.5)):
        comp_j = JCC.Compression(codec, chunk=128, gamma=gamma)
        tree_x = {"a": x[:, :500], "b": x[:, 500:501], "c": x[:, 501:]}
        tree_h = {"a": h[:, :500], "b": h[:, 500:501], "c": h[:, 501:]}
        for e in (0, 7):
            u, v = (int(a) for a in g.edge_list()[e])
            upd = jnp.zeros(10, bool).at[jnp.array([u, v])].set(True)

            @jax.jit
            def jax_event(tx, th, e=e, upd=upd, comp_j=comp_j):
                return JCC.compressed_mix_with(lambda q: pj.event_mix(q, e), tx, th, comp_j, update_mask=upd)

            xj, hj = jax_event(jax.tree_util.tree_map(jnp.asarray, tree_x), jax.tree_util.tree_map(jnp.asarray, tree_h))
            xj = np.concatenate([np.asarray(xj[k]) for k in "abc"], 1)
            hj = np.concatenate([np.asarray(hj[k]) for k in "abc"], 1)
            (xo, ho), scales = quant_mix_pair(pp.event_m2[e], torch.tensor(x[[u, v]]), torch.tensor(h[[u, v]]), edges,
                                              codec=codec, gamma=gamma)
            assert scales.shape == (2, len(edges) - 1)
            assert np.array_equal(_np(ho), hj[[u, v]]), (codec, e)
            np.testing.assert_allclose(_np(xo), xj[[u, v]], rtol=1e-6, atol=1e-6)
            others = np.setdiff1d(np.arange(10), [u, v])
            assert np.array_equal(xj[others], x[others]) and np.array_equal(hj[others], h[others])
    with pytest.raises(ValueError, match=r"\(2, d\)"):
        quant_mix_pair(pp.event_m2[0], torch.zeros(3, 8), None, (0, 8), codec="int8", gamma=1.0)


@pytest.mark.parametrize("codec,gamma", [("int8", 1.0), ("fp8", 0.5)])
@pytest.mark.parametrize("ef", [True, False])
def test_quant_pair_kernel_order_is_the_jax_compressed_event(codec, gamma, ef):
    """The pair kernel's arithmetic (``ref.pair_round_ref``: the dense
    round's FMA chain at n = 2) against the JAX package's compressed event
    (``compressed_mix_with`` around ``event_mix``, jitted, error feedback on
    and off): H' bitwise, X' to fp32 rounding (rtol and atol 1e-6, as the
    plain version's test above)."""
    from repro_torch.kernels.mix.ref import pair_round_ref, quant_scales_ref

    g = PT.barabasi_albert(10, 2, seed=0)
    pj = JC.compile_plan(JT.barabasi_albert(10, 2, seed=0), "dense")
    pp = PC.compile_plan(g, "dense", device="cpu")
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((10, 4103)) * 0.4).astype(np.float32)
    h = (rng.standard_normal((10, 4103)) * 0.3).astype(np.float32)
    sizes = (4099, 1, 3)
    bounds = chunk_bounds(sizes, 2048)
    comp_j = JCC.Compression(codec, chunk=2048, gamma=gamma, error_feedback=ef)
    tree_x = {"a": x[:, :4099], "b": x[:, 4099:4100], "c": x[:, 4100:]}
    tree_h = {"a": h[:, :4099], "b": h[:, 4099:4100], "c": h[:, 4100:]}
    for e in (0, 7):
        u, v = (int(a) for a in g.edge_list()[e])
        upd = jnp.zeros(10, bool).at[jnp.array([u, v])].set(True)

        @jax.jit
        def jax_event(tx, th, e=e, upd=upd):
            return JCC.compressed_mix_with(lambda q: pj.event_mix(q, e), tx, th, comp_j, update_mask=upd)

        xj, hj = jax_event(jax.tree_util.tree_map(jnp.asarray, tree_x), jax.tree_util.tree_map(jnp.asarray, tree_h))
        xj = np.concatenate([np.asarray(xj[k]) for k in "abc"], 1)[[u, v]]
        hj = np.concatenate([np.asarray(hj[k]) for k in "abc"], 1)[[u, v]]
        xp, hp = torch.tensor(x[[u, v]]), torch.tensor(h[[u, v]]) if ef else None
        scales = quant_scales_ref(xp, hp, bounds, codec=codec, error_feedback=ef)
        xo, ho = pair_round_ref(pp.event_m2[e], xp, hp, bounds, scales, codec=codec, gamma=gamma, error_feedback=ef)
        assert np.array_equal(_np(ho), hj), (codec, ef, e)
        np.testing.assert_allclose(_np(xo), xj, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- executor
@pytest.fixture(scope="module")
def setup():
    ds = mnist_like(16 * PER + 64, seed=0)
    data = {}
    for n in (8, 16):
        xs, ys = node_datasets(ds, [np.arange(i * PER, (i + 1) * PER) for i in range(n)])
        rng = np.random.default_rng(n)
        dims = (784, *HIDDEN, 10)
        params = {f"fc{i}": {"w": (rng.standard_normal((n, a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
                             "b": np.zeros((n, b), np.float32)} for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
        data[n] = dict(xs=xs, ys=ys, params=params)
    return dict(data=data, test=(ds.x[-64:], ds.y[-64:]))


def torch_loss(p, b):
    return PPM.classifier_loss(PPM.mlp_forward(p, b[0]), b[1])


def jax_loss(p, b):
    return JPM.classifier_loss(JPM.mlp_forward(p, b[0]), b[1])


CASES = {
    # name: (graph, horizon, link_p, node_p, codec)
    "ring8": (lambda T: T.ring(8), 5.0, 1.0, 1.0, None),
    "ring8_failures": (lambda T: T.ring(8), 5.0, 0.7, 0.9, None),
    "ba16": (lambda T: T.barabasi_albert(16, 2, seed=0), 3.0, 1.0, 1.0, None),
    "ba16_int8_failures": (lambda T: T.barabasi_albert(16, 2, seed=0), 3.0, 0.8, 1.0, "int8"),
}


def _sched(n, horizon):
    return batch_index_schedule(PER, n, BS, max(int(horizon), 1) * BL, seed=0)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Each case's JAX event trajectory (4 bins) and the flags its failure
    draws gave: ``event_keep(fold_in(split(rng)[1], i))``."""
    out = {}
    for name, (graph, horizon, link_p, node_p, codec) in CASES.items():
        g = graph(JT)
        d = setup["data"][g.n]
        stream = JT.poisson_event_stream(g, horizon, 1.0, seed=1)
        opt = JO.sgd(1e-3, 0.5)
        params = jax.tree_util.tree_map(jnp.asarray, d["params"])
        rng = jax.random.PRNGKey(0)
        state = JF.DFLState(params=params, opt_state=jax.vmap(opt.init)(params), round=jnp.zeros((), jnp.int32),
                            rng=rng)
        plan = JC.compile_plan(g, "dense", failures=JC.FailureModel(link_p, node_p))
        comp = None if codec is None else JCC.Compression(codec, chunk=256)
        fin, hist, aux = JF.run_event_trajectory(
            state, jax_loss, opt, plan, stream, d["xs"], d["ys"], _sched(g.n, horizon), b_local=BL, n_bins=4,
            eval_fn=JF.make_eval_fn(jax_loss), eval_batch=setup["test"], compression=comp,
        )
        flags = _jax_flags(plan, jax.random.split(rng)[1], stream) if plan.failures.active else None
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        out[name] = dict(params=to_np(fin.params), residual=None if comp is None else to_np(fin.residual),
                         round=int(fin.round), hist=hist, aux=aux, flags=flags, stream=stream)
    return out


def _port_run(setup, name, stream=None, flags=None, monkeypatch=None, **kw):
    graph, horizon, link_p, node_p, codec = CASES[name]
    g = graph(PT)
    d = setup["data"][g.n]
    stream = stream if stream is not None else PT.poisson_event_stream(g, horizon, 1.0, seed=1)
    if monkeypatch is not None:
        _inject(monkeypatch, flags)
    opt = PO.sgd(1e-3, 0.5)
    state = state_from_numpy(d["params"], optimizer=opt, device="cpu")
    plan = PC.compile_plan(g, "dense", failures=PC.FailureModel(link_p, node_p), device="cpu")
    comp = None if codec is None else Compression(codec, chunk=256)
    return PF.run_event_trajectory(
        state, torch_loss, opt, plan, stream, d["xs"], d["ys"], _sched(g.n, horizon), b_local=BL, n_bins=4,
        eval_fn=PF.make_eval_fn(torch_loss), eval_batch=setup["test"], compression=comp, device="cpu", **kw,
    )


EXACT_KEYS = ("bin", "time", "events", "messages", "wire_bytes", "staleness")


@pytest.mark.parametrize("name", sorted(CASES))
def test_event_trajectory_matches_jax(monkeypatch, setup, jax_runs, name):
    """The port's event executor on the JAX run's flags: history keys, the
    integer channels, the staleness (the JAX executor's fp32 arithmetic on
    the host), the clocks and the histogram exactly; the losses and the
    params at the trajectory tolerance; int8: mirrors too, and elements
    beyond the tolerance only quantisation-code flips, each within one
    code step (a step: the largest scale of its chunk over the run)."""
    ref = jax_runs[name]
    scales = []
    if CASES[name][4] is not None:
        def recording(*a, **kw):
            out, s = quant_mix_pair(*a, **kw)
            scales.append(s)
            return out, s

        monkeypatch.setattr(PX, "quant_mix_pair", recording)
    fin, hist, aux = _port_run(setup, name, flags=ref["flags"], monkeypatch=monkeypatch)
    h_j = ref["hist"]
    assert set(hist) == set(h_j) == {"bin", "time", "train_loss", "test_loss", "staleness", "events", "messages",
                                     "wire_bytes"}
    for k in EXACT_KEYS:
        assert hist[k] == [type(v)(w) for v, w in zip(hist[k], h_j[k])], k
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(hist[k], h_j[k], **TRAJ, err_msg=k)
    assert set(aux) == set(ref["aux"])
    assert np.array_equal(aux["node_events"], np.asarray(ref["aux"]["node_events"]))
    assert np.array_equal(aux["node_clock"], np.asarray(ref["aux"]["node_clock"]))
    assert aux["staleness_hist"] == ref["aux"]["staleness_hist"]
    assert fin.round == ref["round"] == ref["stream"].n_events
    assert sum(hist["events"]) == ref["stream"].n_events
    if ref["flags"] is not None:
        assert sum(hist["messages"]) == 2 * int(ref["flags"][: ref["stream"].n_events].sum()) < 2 * sum(hist["events"])
    params_t, _, resid_t = to_numpy(fin, residual=True)
    if not scales:
        for layer, leaves in params_t.items():
            for leaf, arr in leaves.items():
                np.testing.assert_allclose(arr, ref["params"][layer][leaf], **TRAJ, err_msg=f"{layer}/{leaf}")
        return
    assert len(scales) == int(ref["flags"][: ref["stream"].n_events].sum())
    col = torch.repeat_interleave(torch.arange(scales[0].shape[1]),
                                  (lambda b: b[1:] - b[:-1])(chunk_bounds(fin.layout.sizes, 256)))
    step = fin.layout.views(torch.stack(scales).amax(dim=(0, 1))[col].expand(fin.params.shape[0], -1).contiguous())
    flips, total = {"params": 0, "residual": 0}, 0
    for layer in params_t:
        for leaf in params_t[layer]:
            st = step[layer][leaf].numpy()
            total += st.size
            for what, got, want in (("params", params_t, ref["params"]), ("residual", resid_t, ref["residual"])):
                g_, w_ = got[layer][leaf], want[layer][leaf]
                off = np.abs(g_ - w_) > TRAJ["atol"] + TRAJ["rtol"] * np.abs(w_)
                assert np.all(np.abs(g_ - w_)[off] <= 1.01 * st[off] + 1e-5), (what, layer, leaf)
                flips[what] += int(off.sum())
    # a code near a half-integer flips on an ulp of difference upstream, and
    # a flip moves the pair's x' and mirror by a step that later exchanges
    # and local steps carry on: on BA-16 the count grew with the exchanges
    # (13 elements after 20 events, 452 after 40, 4028 after 97, clean),
    # each within one code step, while the uncompressed run stayed within
    # 6e-8 of the JAX one
    print(f"code-step flips beyond the trajectory tolerance, of {total} elements: {flips}")
    assert max(flips.values()) <= 2e-2 * total, flips


def test_event_trajectory_chunked_and_padded_runs_are_bitwise(setup):
    """On the port's own draws (link_p 0.7, node_p 0.9): chunks of 7 events
    and a longer envelope change nothing, bit for bit; the hook fires once a
    chunk with the accumulators so far."""
    calls = []
    fin, hist, aux = _port_run(setup, "ring8_failures")
    fin_c, hist_c, aux_c = _port_run(setup, "ring8_failures", chunk_events=7,
                                     on_chunk=lambda ci, i0, i1, acc: calls.append((ci, i0, i1, acc)))
    g = PT.ring(8)
    base = PT.poisson_event_stream(g, 5.0, 1.0, seed=1)
    padded = PT.poisson_event_stream(g, 5.0, 1.0, seed=1, envelope=base.n_events + 9)
    fin_p, hist_p, aux_p = _port_run(setup, "ring8_failures", stream=padded)
    for f, h, a in ((fin_c, hist_c, aux_c), (fin_p, hist_p, aux_p)):
        assert torch.equal(f.params, fin.params) and h == hist or _nan_equal(h, hist)
        assert all(torch.equal(x, y) for x, y in zip(f.opt_state, fin.opt_state))
        assert np.array_equal(a["node_clock"], aux["node_clock"]) and a["staleness_hist"] == aux["staleness_hist"]
        assert f.round == fin.round == base.n_events
        assert torch.equal(f.generator.get_state(), fin.generator.get_state())
    assert [c[:3] for c in calls] == [(ci, i0, min(i0 + 7, base.n_events)) for ci, i0 in
                                      enumerate(range(0, base.n_events, 7))]
    assert calls[-1][3]["cnt"].sum() == base.n_events
    np.testing.assert_array_equal(calls[-1][3]["msg_cnt"], hist["messages"])
    assert set(calls[0][3]) == {"loss_sum", "cnt", "stale_sum", "msg_cnt", "test_bin", "stale_hist"}


def _nan_equal(a, b):
    return json.dumps(a) == json.dumps(b)


def test_event_trajectory_own_draws_statistics(setup):
    """The port's own draws: a kill-all link drops every exchange (no
    messages) while every clock fires; at link_p 0.7 / node_p 0.9 the
    delivered share is within a binomial bound of 0.7·0.81; the draws come
    from the state's generator, which advances."""
    g = PT.random_k_regular(8, 3, seed=0)
    stream = PT.poisson_event_stream(g, 60.0, 1.0, seed=2)
    d = setup["data"][8]
    opt = PO.sgd(1e-3, 0.5)

    def tiny_loss(p, b):
        return (p["w"] ** 2).sum(dim=1) * 0.0 + b[1].float().mean(dim=(1,)) * 0.0

    shares = []
    for link_p, node_p in ((0.0, 1.0), (0.7, 0.9)):
        state = state_from_numpy({"w": np.zeros((8, 2), np.float32)}, optimizer=opt, device="cpu")
        before = state.generator.get_state().clone()
        plan = PC.compile_plan(g, "dense", failures=PC.FailureModel(link_p, node_p), device="cpu")
        fin, hist, aux = PF.run_event_trajectory(state, tiny_loss, opt, plan, stream, d["xs"], d["ys"],
                                                 _sched(8, 60.0), b_local=1, n_bins=3, device="cpu")
        assert torch.equal(state.generator.get_state(), before)  # the caller's state is left alone
        assert not torch.equal(fin.generator.get_state(), before)
        assert sum(hist["events"]) == stream.n_events and aux["node_events"].sum() == 2 * stream.n_events
        shares.append(sum(hist["messages"]) / (2 * stream.n_events))
    p = 0.7 * 0.81
    assert shares[0] == 0.0 and abs(shares[1] - p) < 5 * np.sqrt(p * (1 - p) / stream.n_events)


def test_event_trajectory_hand_built_stream_and_errors(setup, tmp_path):
    """The JAX test's ring-4 stream: clocks, counts, staleness by hand; a
    checkpoint directory without LATEST starts fresh, a resume under other
    knobs and a schedule raise."""
    n = 4
    g = PT.ring(n)
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(n, 8, 3)).astype(np.float32)
    ys = rng.integers(0, 2, size=(n, 8)).astype(np.int32)

    def loss_fn(p, b):
        return ((torch.einsum("nbd,nd->nb", b[0], p["w"]) - b[1].float()) ** 2).mean(dim=1)

    opt = PO.sgd(1e-2, 0.0)
    state = state_from_numpy({"w": (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)}, optimizer=opt, device="cpu")
    stream = PT.EventStream(times=np.array([0.5, 1.0, 2.5, 3.0, 4.0], np.float32),
                            edges=np.array([0, 2, 0, 1, -1], np.int32), n_events=4, horizon=4.0,
                            rates=np.ones(g.n_edges))
    sched = batch_index_schedule(8, n, 4, 6, seed=0)
    plan = PC.compile_plan(g, "dense", device="cpu")
    final, hist, aux = PF.run_event_trajectory(state, loss_fn, opt, plan, stream, xs, ys, sched, b_local=2, n_bins=2,
                                               device="cpu")
    np.testing.assert_array_equal(aux["node_events"], [3, 3, 1, 1])
    np.testing.assert_allclose(aux["node_clock"], [3.0, 2.5, 1.0, 3.0], atol=1e-6)
    assert final.round == 4 and hist["events"] == [2, 2] and hist["messages"] == [4, 4]
    assert hist["time"] == [2.0, 4.0] and np.allclose(hist["staleness"], [0.625, 1.75])
    assert all(np.isfinite(hist["train_loss"])) and all(np.isnan(hist["test_loss"]))
    assert aux["staleness_hist"]["edges"] == list(np.linspace(0.0, 4.0, 17))
    fresh, hist_f, _ = PF.run_event_trajectory(state, loss_fn, opt, plan, stream, xs, ys, sched, b_local=2, n_bins=2,
                                               resume_from=str(tmp_path / "none"), device="cpu")
    assert torch.equal(fresh.params, final.params) and _nan_equal(hist_f, hist)
    ck = PF.CheckpointPolicy(str(tmp_path / "ck"))
    PF.run_event_trajectory(state, loss_fn, opt, plan, stream, xs, ys, sched, b_local=2, n_bins=2, checkpoint=ck,
                            device="cpu")
    with pytest.raises(ValueError, match="n_bins=2, but this run has n_bins=3"):
        PF.run_event_trajectory(state, loss_fn, opt, plan, stream, xs, ys, sched, b_local=2, n_bins=3,
                                resume_from=ck.dir, device="cpu")
    sched_plan = PC.compile_schedule([g, g], "dense", device="cpu")
    with pytest.raises(ValueError, match="statically compiled"):
        PF.run_event_trajectory(state, loss_fn, opt, sched_plan, stream, xs, ys, sched, b_local=2, device="cpu")
    with pytest.raises(ValueError, match="nodes"):
        PF.run_event_trajectory(state, loss_fn, opt, PC.compile_plan(PT.ring(5), device="cpu"), stream, xs, ys,
                                sched, b_local=2, device="cpu")


def test_event_step_factory_is_reusable(setup):
    """``_make_event_step`` drives a live event on its own: the two
    endpoints' rows move, the others do not; a killed exchange leaves the
    rows as the local phase left them."""
    d = setup["data"][8]
    opt = PO.sgd(1e-3, 0.5)
    state = state_from_numpy(d["params"], optimizer=opt, device="cpu")
    plan = PC.compile_plan(PT.ring(8), "dense", device="cpu")
    sched = torch.as_tensor(PX._as_round_schedule(_sched(8, 2.0), 2, BL), dtype=torch.int64)
    step = PX._make_event_step(torch_loss, opt, plan, sched, 2, torch.as_tensor(d["xs"]), torch.as_tensor(d["ys"]),
                               layout=state.layout, reinit_opt=True, comp=None)
    outs = {}
    for delivered in (True, False):
        p, o = state.params.clone(), type(state.opt_state)(*(f.clone() for f in state.opt_state))
        counts, clocks = np.zeros(8, np.int32), np.zeros(8, np.float32)
        loss, stale = step(p, o, None, counts, clocks, 0, np.float32(0.5), delivered)
        u, v = plan.event_uv[0].tolist()
        others = [i for i in range(8) if i not in (u, v)]
        assert torch.equal(p[others], state.params[others]) and not torch.equal(p[u], state.params[u])
        assert counts.tolist() == [1 if i in (u, v) else 0 for i in range(8)] and stale == np.float32(0.5)
        assert float(o[0][[u, v]].abs().max()) == 0.0 and torch.isfinite(loss)
        outs[delivered] = p
    assert not torch.equal(outs[True], outs[False])


# ------------------------------------------------------------ fig9 and CLI
def _norm(kwargs):
    out = {}
    for k, v in kwargs.items():
        if k == "device":
            continue
        if isinstance(v, (JT.Graph, PT.Graph)):
            v = (v.name, v.adjacency.tobytes())
        out[k] = v
    return out


def test_fig9_call_for_call_and_record_keys(monkeypatch, tmp_path):
    """Both fig9 modules' runners replaced by one recorder: the same calls, the
    same rows and records, and the records carry ``BENCH_async.json``'s
    keys."""
    calls = {"jax": [], "torch": []}

    def make(side, name):
        def rec(**kw):
            calls[side].append((name, _norm(kw)))
            lvl = 1.0 + len(repr(sorted(_norm(kw).items()))) % 97 / 100
            if name == "run_dfl_mlp":
                hist = {"round": [0], "test_loss": [lvl], "wire_bytes": [int(lvl * 1000)]}
                return hist, {"sec_per_round": lvl, "compile_seconds": lvl / 2, "us_per_round_steady": lvl * 100}
            hist = {"test_loss": [lvl], "staleness": [lvl / 3, lvl / 5], "wire_bytes": [7, 9]}
            stream = PT.poisson_event_stream(PT.ring(4), 2.0, 1.0, seed=int(lvl * 100))
            return hist, {"sec_per_event": lvl / 1e4, "compile_seconds": lvl, "us_per_event_steady": lvl * 50}, stream

        return rec

    for side, mod in (("jax", jfig9), ("torch", pfig9)):
        for name in ("run_dfl_mlp", "run_dfl_mlp_async"):
            monkeypatch.setattr(mod, name, make(side, name))
    monkeypatch.setattr(jfig9, "OUT", tmp_path / "jax.json")
    pcommon.ROWS.clear()
    jfig9.emit.__globals__["ROWS"].clear()
    jfig9.run(quick=True)
    got = pfig9.run(quick=True, device="cpu", out_path=tmp_path / "torch.json")
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) == 12
    assert pcommon.ROWS == jfig9.emit.__globals__["ROWS"] and len(pcommon.ROWS) == 6
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got["records"] == want["records"] == json.loads((tmp_path / "torch.json").read_text())["records"]
    bench = json.loads((ROOT / "BENCH_async.json").read_text())
    assert set(got) == set(bench)
    assert all(set(r) == set(bench["records"][0]) for r in got["records"])


def test_run_dfl_mlp_async_on_cpu():
    """The port's async runner: the timing split over 8 chunks, finite
    losses, the messages of a clean plan twice the events."""
    hist, t, stream = pcommon.run_dfl_mlp_async(n_nodes=4, graph=PT.ring(4), horizon=4.0, per_node=16,
                                                hidden=(8,), n_bins=4, test_size=32, timing=True, device="cpu")
    assert set(t) == {"sec_per_event", "compile_seconds", "us_per_event_steady"}
    assert t["us_per_event_steady"] > 0 and np.isfinite(hist["test_loss"]).all()
    assert sum(hist["messages"]) == 2 * stream.n_events == 2 * sum(hist["events"])


ASYNC_BASE = ["--model", "mlp", "--device", "cpu", "--nodes", "8", "--topology", "kregular", "--rounds", "3",
              "--items-per-node", "32", "--local-batches", "2", "--async"]


@pytest.mark.parametrize("extra", [[], ["--compress", "int8", "--link-p", "0.8"],
                                   ["--uncoordinated-init", "--estimate-rounds", "6", "--link-p", "0.8"],
                                   ["--event-rate", "2.0", "--event-horizon", "1.5", "--compress", "qtopk"]],
                         ids=["plain", "int8-link", "uncoordinated", "rate-horizon-qtopk"])
def test_cli_async_on_cpu(capsys, extra):
    hist = cli.main([*ASYNC_BASE, *extra])
    out = capsys.readouterr().out
    assert "event stream:" in out and hist["bin"] == list(range(20))
    lines = [ln for ln in out.splitlines() if ln.startswith("t=")]
    assert len(lines) == 20 and all("stale" in ln and "msgs" in ln for ln in lines)
    assert [int(ln.split("msgs")[1]) for ln in lines] == hist["messages"]
    n_events = int(out.split("event stream: ")[1].split()[0])
    assert sum(hist["events"]) == n_events
    finite = [v for v in hist["train_loss"] if v != 0.0]
    assert finite and np.isfinite(finite).all()
    if "--uncoordinated-init" in extra:
        assert "barrier-free leaderless gains" in out
    if "--link-p" not in extra:
        assert sum(hist["messages"]) == 2 * n_events


def test_cli_async_errors(capsys):
    for extra, match in ((["--topology-schedule", "churn"], "static topology"),
                         (["--uncoordinated-init", "--estimate-mode", "degree"], "degree polling"),
                         (["--elastic"], "excludes --async"), (["--legacy-loop"], "excludes --arch and --legacy-loop")):
        with pytest.raises(SystemExit):
            cli.main([*ASYNC_BASE, *extra])
        assert match in capsys.readouterr().err
