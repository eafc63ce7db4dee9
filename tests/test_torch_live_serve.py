"""Live serving under gossip and the decoder training it needs, in the port
against the JAX package.

- The flat layout walks lists: a decoder's row is ``ravel_pytree`` of the
  JAX node's tree, its ``DFLState`` converts both ways, and the MLP layout
  is what it was.
- ``token_batch_iterator`` bitwise; ``lm_loss`` and its gradient against
  ``jax.value_and_grad`` of the JAX ``lm_loss`` (rtol 1e-5 on the loss,
  1e-5 of the largest gradient element), on the reduced qwen2.5-3b, on a
  sliding-window config and on the JAX package's banded / chunked
  attention; the per-node loss and two DecAvg rounds against the JAX
  trainer's.
- ``attention_forward`` launches flash when autograd does not record and
  the plain masked softmax when it does; a recorded kernel call raises.
- The query stream and ``hop_matrix`` bitwise; ``Router.route`` node for
  node against the JAX router (budgets, ties); ``uniform`` on the JAX
  draws injected through ``router.uniform_draws``, and uniform on its own.
- ``run_serve_trajectory`` against the JAX serving executor (ring-6 and
  complete-3 at the JAX tests' ``_mlp_dfl`` sizes, a numpy He init, the JAX
  failure flags injected through ``commplan.event_flags``): node, latency,
  staleness and hops bitwise, answers equal, the history at the event
  executor's tolerances; qps 0 bitwise the port's event executor, and
  training bitwise the same at qps 0 and 5.
- The serve CLI on the CPU and its ``--telemetry`` refusal, fig13 call for
  call, the consensus example's pieces.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

torch = pytest.importorskip("torch")

from benchmarks import fig13_serve as jfig13  # noqa: E402
from repro import fed as JF  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.configs import get_reduced_config as jreduced  # noqa: E402
from repro.core import commplan as JC  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.data import batch_index_schedule, mnist_like, node_datasets  # noqa: E402
from repro.data import pipeline as JPL  # noqa: E402
from repro.fed import router as JR  # noqa: E402
from repro.fed import serve as JS  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch import fed as PF  # noqa: E402
from repro_torch import optim as PO  # noqa: E402
from repro_torch.benchmarks import common as pcommon  # noqa: E402
from repro_torch.benchmarks import fig13_serve as pfig13  # noqa: E402
from repro_torch.configs import get_reduced_config as preduced  # noqa: E402
from repro_torch.convert import params_from_numpy, state_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.data import pipeline as PPL  # noqa: E402
from repro_torch.examples import serve_consensus as pex  # noqa: E402
from repro_torch.fed import router as PR  # noqa: E402
from repro_torch.flat import FlatLayout, tree_leaves, tree_map, tree_structure, tree_unflatten  # noqa: E402
from repro_torch.kernels import _launch as K  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import paper_models as PPM  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRAJ = dict(rtol=1e-4, atol=1e-5)  # a trajectory (ROADMAP.md Queue 3)
LOSS_RTOL = 1e-5  # lm_loss against the JAX one: fp32, summation order
GRAD_TOL = 1e-5  # |Δ grad| / max |grad|, per leaf


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU products run fastest on one thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------ the flat layout
def _tail_cfg(get):
    """A config with a non-empty tail: gemma3's (swa, attn) unit over 3 layers."""
    return dataclasses.replace(get("gemma3-4b"), n_layers=3)


@pytest.fixture(scope="module")
def decoders():
    """Node-stacked numpy params (n = 3) of the reduced qwen2.5-3b and of a
    config with a tail: one node's draw and numpy noise."""
    out = {}
    for name, (jcfg, pcfg) in {"qwen": (jreduced("qwen2.5-3b"), preduced("qwen2.5-3b")),
                               "tail": (_tail_cfg(jreduced), _tail_cfg(preduced))}.items():
        one = _jax_init(0, jcfg)
        rng = np.random.default_rng(1)
        stacked = jax.tree_util.tree_map(
            lambda a: np.stack([a + (0.01 * i) * rng.standard_normal(a.shape).astype(np.float32)
                                for i in range(3)]).astype(np.float32), one)
        out[name] = (jcfg, pcfg, one, stacked)
    return out


def _jax_init(seed, jcfg):
    """One node's parameters in the JAX init's layout (``jax.eval_shape``,
    nothing compiled), drawn by numpy: norm scales 1 + N(0, 0.05²), the
    rest N(0, 1/fan_in) with fan_in the leaf's second-last axis."""
    from repro.core.initialisation import InitConfig

    shapes = jax.eval_shape(lambda k: JTF.init_params(k, jcfg, InitConfig("trunc_normal", 1.0)),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    paths, leaves = zip(*jax.tree_util.tree_flatten_with_path(shapes)[0])

    def draw(path, leaf):
        if "scale" in jax.tree_util.keystr(path):
            return (1.0 + 0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = leaf.shape[-2] if len(leaf.shape) > 1 else leaf.shape[-1]
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes),
                                        [draw(p, leaf) for p, leaf in zip(paths, leaves)])


@pytest.mark.parametrize("name", ["qwen", "tail"])
def test_decoder_row_is_ravel_pytree_and_state_converts_both_ways(decoders, name):
    jcfg, _, _, stacked = decoders[name]
    jp = jax.tree_util.tree_map(jnp.asarray, stacked)
    opt = JO.adamw(3e-3)
    jopt = jax.jit(jax.vmap(opt.init))(jp)
    state = state_from_numpy(stacked, jax.tree_util.tree_map(np.array, jopt), device="cpu")
    for i in range(3):
        row, _ = ravel_pytree(jax.tree_util.tree_map(lambda a, i=i: a[i], jp))
        assert np.array_equal(_np(state.params[i]), np.asarray(row))
    views = state.tree
    assert isinstance(views["stack"], list) and isinstance(views["tail"], list)
    assert len(views["tail"]) == len(stacked["tail"]) == (1 if name == "tail" else 0)
    params, opt_back = to_numpy(state)
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(stacked)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(stacked)):
        assert np.array_equal(a, b)
    for field in ("mu", "nu"):
        assert jax.tree_util.tree_structure(getattr(opt_back, field)) == jax.tree_util.tree_structure(stacked)
    assert np.array_equal(opt_back.step, np.asarray(jopt.step))


def test_mlp_layout_is_unchanged():
    """The MLP's paths, shapes and row order: sorted keys, ``fc{i}/b``
    before ``fc{i}/w``, a row ``ravel_pytree`` of the JAX tree."""
    rng = np.random.default_rng(0)
    dims = (784, 16, 10)
    tree = {f"fc{i}": {"w": rng.standard_normal((2, a, b)).astype(np.float32),
                       "b": rng.standard_normal((2, b)).astype(np.float32)} for i, (a, b) in
            enumerate(zip(dims[:-1], dims[1:]))}
    layout = FlatLayout.of(tree_map(torch.as_tensor, tree))
    assert layout.paths == (("fc0", "b"), ("fc0", "w"), ("fc1", "b"), ("fc1", "w"))
    assert layout.shapes == ((16,), (784, 16), (10,), (16, 10)) and layout.size == 12730
    flat = layout.flatten(tree_map(torch.as_tensor, tree))
    assert np.array_equal(_np(flat[1]), np.asarray(ravel_pytree(jax.tree_util.tree_map(lambda a: a[1], tree))[0]))
    assert layout.unflatten([v for _, v in tree_leaves(layout.views(flat))]).keys() == tree.keys()


def test_tree_helpers_rebuild_lists_tuples_and_empty_lists():
    tree = {"b": [{"x": 1, "y": 2}, {"x": 3, "y": 4}], "a": (5, [6]), "c": [], "d": 7}
    leaves = [v for _, v in tree_leaves(tree)]
    want = jax.tree_util.tree_leaves(tree)
    assert leaves == want == [5, 6, 1, 2, 3, 4, 7]
    assert tree_unflatten(tree_structure(tree), leaves) == tree
    assert [p for p, _ in tree_leaves(tree)][2] == ("b", 0, "x")
    assert tree_structure(tree) != tree_structure({**tree, "c": [1]})


# ------------------------------------------------------ LM training pieces
def test_token_batch_iterator_is_bitwise():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 97, size=(3, 500)).astype(np.int32)
    a = JPL.token_batch_iterator(toks, batch_size=4, seq_len=24, seed=5)
    b = PPL.token_batch_iterator(toks, batch_size=4, seq_len=24, seed=5)
    for _ in range(4):
        x, y = next(a), next(b)
        assert x.x.dtype == y.x.dtype == np.int32 and x.x.shape == (3, 4, 24)
        assert np.array_equal(x.x, y.x) and np.array_equal(x.y, y.y)


def _lm_value_and_grad_jax(jcfg, params, x, y, chunk):
    def loss(p):
        hidden, aux = JTF.forward(p, jcfg, jnp.asarray(x))
        return JTF.lm_loss(p, jcfg, hidden, jnp.asarray(y), chunk=chunk)

    lj, gj = jax.jit(jax.value_and_grad(loss))(params)
    return float(lj), jax.tree_util.tree_leaves(gj)


def _lm_value_and_grad_port(pcfg, params, x, y, chunk):
    pt = tree_map(lambda t: t.requires_grad_(True), params_from_numpy(params, device="cpu"))
    hidden, _ = PTF.forward(pt, pcfg, torch.as_tensor(x))
    loss = PTF.lm_loss(pt, pcfg, hidden, torch.as_tensor(y), chunk=chunk)
    loss.backward()
    return float(loss.detach()), [t.grad.numpy() for _, t in tree_leaves(pt)]


def _hold(lp, gp, lj, gj):
    assert abs(lp - lj) <= LOSS_RTOL * abs(lj), (lp, lj)
    assert len(gp) == len(gj)
    for a, b in zip(gp, gj):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= GRAD_TOL * max(np.abs(b).max(), 1e-30)


LM_CASES = {
    # name: (config, (B, S), chunk): S = 40 with chunk 16 leaves a remainder
    "qwen": (lambda get: get("qwen2.5-3b"), (2, 40), 16),
    "gemma3_window": (lambda get: get("gemma3-4b"), (2, 40), 512),
    # the JAX package's banded attention (S a multiple of the window, S > w)
    # and its chunked one (S ≥ 512): the port's plain masked softmax is the
    # same function
    "gemma3_banded": (lambda get: dataclasses.replace(get("gemma3-4b"), swa_impl="blocked"), (1, 48), 512),
    "qwen_chunked": (lambda get: dataclasses.replace(get("qwen2.5-3b"), attn_impl="chunked", n_layers=1),
                     (1, 512), 512),
}


@pytest.mark.parametrize("name", sorted(LM_CASES))
def test_lm_loss_and_grad_match_jax(name):
    cfg_of, (b, s), chunk = LM_CASES[name]
    jcfg, pcfg = cfg_of(jreduced), cfg_of(preduced)
    params = _jax_init(3, jcfg)
    rng = np.random.default_rng(2)
    x = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    y = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    lj, gj = _lm_value_and_grad_jax(jcfg, params, x, y, chunk)
    lp, gp = _lm_value_and_grad_port(pcfg, params, x, y, chunk)
    _hold(lp, gp, lj, gj)


def test_node_lm_loss_and_two_decavg_rounds_match_jax():
    """The per-node decoder loss (one forward a node) against ``jax.vmap``
    of the JAX example's loss, then two AdamW DecAvg rounds on a ring of
    3 against the JAX trainer's (the reduced qwen2.5-3b cut to one layer) (the AdamW drift of ROADMAP.md Queue 3
    stays within the trajectory tolerance over two rounds)."""
    jcfg, pcfg = (dataclasses.replace(get("qwen2.5-3b"), n_layers=1) for get in (jreduced, preduced))
    one = _jax_init(5, jcfg)
    rng = np.random.default_rng(4)
    stacked = jax.tree_util.tree_map(
        lambda a: (a + 0.01 * rng.standard_normal((3, *a.shape))).astype(np.float32), one)
    toks = rng.integers(0, jcfg.vocab_size, size=(3, 400)).astype(np.int32)
    it = JPL.token_batch_iterator(toks, batch_size=2, seq_len=16, seed=0)
    batches = [next(it) for _ in range(2)]

    def jloss(p, batch):
        hidden, aux = JTF.forward(p, jcfg, batch[0])
        return JTF.lm_loss(p, jcfg, hidden, batch[1]) + 0.01 * aux

    ploss = pex.node_loss(pcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, stacked)
    want = np.asarray(jax.jit(jax.vmap(jloss))(jp, (jnp.asarray(batches[0].x), jnp.asarray(batches[0].y))))
    state = state_from_numpy(stacked, optimizer=PO.adamw(3e-3), device="cpu")
    got = ploss(state.tree, (torch.as_tensor(batches[0].x), torch.as_tensor(batches[0].y)))
    assert got.shape == (3,)
    np.testing.assert_allclose(_np(got), want, rtol=LOSS_RTOL)

    jopt = JO.adamw(3e-3)
    jstate = JF.DFLState(params=jp, opt_state=jax.vmap(jopt.init)(jp), round=jnp.zeros((), jnp.int32),
                         rng=jax.random.PRNGKey(0))
    jround = jax.jit(JF.make_round_fn(jloss, jopt, JT.ring(3)))
    pround = PF.make_round_fn(ploss, PO.adamw(3e-3), PT.ring(3), device="cpu")
    for b in batches:
        jstate, jm = jround(jstate, (jnp.asarray(b.x[:, None]), jnp.asarray(b.y[:, None])))
        state, pm = pround(state, (torch.as_tensor(b.x[:, None]), torch.as_tensor(b.y[:, None])))
        np.testing.assert_allclose(float(pm["train_loss"]), float(jm["train_loss"]), rtol=LOSS_RTOL)
    # AdamW's m/√v turns an ulp of difference in a near-zero gradient into
    # a ±lr step (ROADMAP.md Queue 3): elements beyond the trajectory
    # tolerance are counted, each held to one step a round, their share to 1e-3
    params, _ = to_numpy(state)
    off, total = 0, 0
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(jstate.params)):
        b = np.asarray(b)
        beyond = np.abs(a - b) > TRAJ["atol"] + TRAJ["rtol"] * np.abs(b)
        assert np.all(np.abs(a - b)[beyond] <= len(batches) * 3e-3 * 1.01)
        off, total = off + int(beyond.sum()), total + b.size
    assert off <= 1e-3 * total, (off, total)


# ------------------------------------------------------ attention rendering
def test_attention_launches_flash_unless_autograd_records(monkeypatch, decoders):
    _, pcfg, one, _ = decoders["qwen"]
    calls = []
    real = PA.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(PA, "flash_attention", counting)
    params = params_from_numpy(one, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).integers(0, pcfg.vocab_size, (2, 12)).astype(np.int32))
    with torch.no_grad():
        h_ng, _ = PTF.forward(params, pcfg, x)
    assert len(calls) == pcfg.n_layers
    h_plain, _ = PTF.forward(params, pcfg, x)  # grad mode on, but nothing requires grad: not recorded
    assert len(calls) == 2 * pcfg.n_layers
    pg = tree_map(lambda t: t.requires_grad_(True), params_from_numpy(one, device="cpu"))
    h_g, _ = PTF.forward(pg, pcfg, x)
    assert len(calls) == 2 * pcfg.n_layers and h_g.requires_grad
    np.testing.assert_allclose(_np(h_g), _np(h_ng), rtol=1e-5, atol=1e-5)
    prefill_calls = len(calls)
    with torch.no_grad():
        PTF.prefill_cache(params, pcfg, x, 16)
    assert len(calls) == prefill_calls + pcfg.n_layers


def test_a_recorded_kernel_call_raises():
    q = torch.zeros(1, 2, 4, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        K.no_backward("flash_mha", q, q.detach(), None)
    with torch.no_grad():
        K.no_backward("flash_mha", q, q, q)
    K.no_backward("rwkv6_chunked", q.detach(), None)


# ---------------------------------------------------------------- the router
@pytest.mark.parametrize("kw", [dict(qps=3.0), dict(qps=3.0, skew=2.0), dict(qps=0.0), dict(qps=5.0, pool=7),
                                dict(qps=2.0, envelope=90)])
def test_query_stream_is_bitwise(kw):
    a = JR.poisson_query_stream(8, 20.0, seed=5, **kw)
    b = PR.poisson_query_stream(8, 20.0, seed=5, **kw)
    assert (a.n_queries, a.envelope, a.horizon, a.qps) == (b.n_queries, b.envelope, b.horizon, b.qps)
    for f in ("times", "homes", "qidx"):
        assert getattr(a, f).dtype == getattr(b, f).dtype and np.array_equal(getattr(a, f), getattr(b, f))
    for bad, match in ((dict(envelope=1), "envelope"), (dict(horizon=0.0), "horizon"), (dict(qps=-1.0), "qps")):
        args = {"n_nodes": 8, "horizon": 20.0, "qps": 3.0, "seed": 5, **bad}
        for mod in (JR, PR):
            with pytest.raises(ValueError, match=match):
                mod.poisson_query_stream(**args)


@pytest.mark.parametrize("family", ["ring", "kreg", "ba", "pairs", "directed"])
def test_hop_matrix_is_bitwise(family):
    def build(T):
        if family == "pairs":
            adj = np.zeros((4, 4), np.float32)
            adj[0, 1] = adj[1, 0] = adj[2, 3] = adj[3, 2] = 1.0
            return T.Graph(adj, name="pairs")
        if family == "directed":
            return T.Graph(np.roll(np.eye(6, dtype=np.float32), 1, axis=1), name="cycle", directed=True)
        return {"ring": lambda: T.ring(9), "kreg": lambda: T.random_k_regular(12, 3, seed=1),
                "ba": lambda: T.barabasi_albert(20, 2, seed=0)}[family]()

    a, b = JR.hop_matrix(build(JT)), PR.hop_matrix(build(PT))
    assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


@pytest.mark.parametrize("budget", [float("inf"), 1.0, 0.0])
@pytest.mark.parametrize("family", ["ring", "kreg"])
def test_router_routes_as_jax(family, budget):
    """Random staleness and waits, and coarse integer-valued ones (ties),
    every home: the consensus and local policies node for node."""
    gj = JT.ring(9) if family == "ring" else JT.random_k_regular(12, 3, seed=1)
    gp = PT.ring(9) if family == "ring" else PT.random_k_regular(12, 3, seed=1)
    rng = np.random.default_rng(0)
    for policy in ("consensus", "local"):
        kw = dict(staleness_budget=budget, locality_weight=0.3, queue_weight=0.7)
        rj, rp = JR.make_router(gj, policy, **kw), PR.make_router(gp, policy, **kw)
        assert np.array_equal(np.asarray(rj.hops), rp.hops) and rp.hops.dtype == np.float32
        route_j = jax.jit(lambda h, st, w, rj=rj: rj.route(h, st, w, jax.random.PRNGKey(0)))
        for trial in range(12):
            if trial % 2:
                stale = rng.integers(0, 3, gp.n).astype(np.float32)
                wait = rng.integers(0, 2, gp.n).astype(np.float32)
            else:
                stale = rng.exponential(1.0, gp.n).astype(np.float32)
                wait = np.maximum(rng.normal(0.0, 0.5, gp.n), 0.0).astype(np.float32)
            for home in range(gp.n):
                want = int(route_j(jnp.int32(home), jnp.asarray(stale), jnp.asarray(wait)))
                assert rp.route(home, stale, wait) == want, (policy, trial, home)


def test_uniform_router_on_jax_draws_and_on_its_own():
    gj, gp = JT.ring(7), PT.ring(7)
    rj, rp = JR.make_router(gj, "uniform"), PR.make_router(gp, "uniform")
    key = jax.random.PRNGKey(9)
    z = np.zeros(7, np.float32)
    draws = [int(rj.route(jnp.int32(0), jnp.asarray(z), jnp.asarray(z), jax.random.fold_in(key, q)))
             for q in range(30)]
    assert [rp.route(0, z, z, d) for d in draws] == draws
    with pytest.raises(ValueError, match="draw"):
        rp.route(0, z, z)
    own = PR.uniform_draws(7, 123, 7000)
    assert own.dtype == np.int32 and np.array_equal(PR.uniform_draws(7, 123, 100), own[:100])
    counts = np.bincount(own, minlength=7)
    chi2 = float(((counts - 1000.0) ** 2 / 1000.0).sum())
    assert counts.size == 7 and chi2 < 22.5  # χ²(6) at p = 0.001
    with pytest.raises(ValueError, match="policy"):
        PR.make_router(gp, "nearest")


# -------------------------------------------------------- the serving executor
N_S, PER_S, TEST_S = 6, 32, 64
CASES = {
    # name: (graph, horizon, qps, policy, link_p, budget)
    "ring6_budget_failures": (lambda T: T.ring(6), 8.0, 5.0, "consensus", 0.7, 0.5),
    "ring6_uniform": (lambda T: T.ring(6), 8.0, 5.0, "uniform", 0.8, float("inf")),
    "complete3_local": (lambda T: T.complete(3), 3.0, 4.0, "local", 1.0, float("inf")),
}


def _data(n):
    ds = mnist_like(n * PER_S + TEST_S, seed=0)
    xs, ys = node_datasets(ds, [np.arange(i * PER_S, (i + 1) * PER_S) for i in range(n)])
    rng = np.random.default_rng(n)
    dims = (784, 16, 10)
    params = {f"fc{i}": {"w": (rng.standard_normal((n, a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
                         "b": np.zeros((n, b), np.float32)} for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    return dict(xs=xs, ys=ys, params=params, test=(ds.x[-TEST_S:], ds.y[-TEST_S:]))


def _jax_loss(p, b):
    return JPM.classifier_loss(JPM.mlp_forward(p, b[0]), b[1])


def _torch_loss(p, b):
    return PPM.classifier_loss(PPM.mlp_forward(p, b[0]), b[1])


def _sched(n, horizon):
    return batch_index_schedule(PER_S, n, 8, int(horizon) * 2, seed=0)


@pytest.fixture(scope="module")
def jax_serve_runs():
    """Each case's JAX serving run (4 bins, eval, answers) and the draws it
    made: the failure flags ``event_keep(fold_in(base_key, g))`` and the
    uniform router's ``randint(fold_in(k_route, qn))``."""
    out = {}
    for name, (graph, horizon, qps, policy, link_p, budget) in CASES.items():
        g = graph(JT)
        d = _data(g.n)
        opt = JO.sgd(1e-3, 0.5)
        params = jax.tree_util.tree_map(jnp.asarray, d["params"])
        rng = jax.random.PRNGKey(0)
        state = JF.DFLState(params=params, opt_state=jax.vmap(opt.init)(params), round=jnp.zeros((), jnp.int32),
                            rng=rng)
        plan = JC.compile_plan(g, "dense", failures=JC.FailureModel(link_p))
        stream = JT.poisson_event_stream(g, horizon, 1.0, seed=1)
        queries = JR.poisson_query_stream(g.n, horizon, qps, seed=3, pool=TEST_S)
        router = JR.make_router(g, policy, staleness_budget=budget)
        fin, hist, serve, aux = JS.run_serve_trajectory(
            state, _jax_loss, opt, plan, stream, queries, router, d["xs"], d["ys"], _sched(g.n, horizon),
            b_local=2, n_bins=4, eval_fn=JF.make_eval_fn(_jax_loss), eval_batch=d["test"],
            serve_fn=lambda p, x: jnp.argmax(JPM.mlp_forward(p, x[None]), axis=-1)[0], query_xs=d["test"][0],
        )
        base_key = jax.random.split(rng)[1]
        flags = None
        if plan.failures.active:
            flags = np.asarray(jax.vmap(lambda i: plan.event_keep(jax.random.fold_in(base_key, i)))(
                jnp.arange(stream.envelope)))
        k_route = jax.random.split(base_key)[1]
        draws = np.asarray(jax.vmap(lambda q: jax.random.randint(jax.random.fold_in(k_route, q), (), 0, g.n,
                                                                 dtype=jnp.int32))(jnp.arange(queries.envelope)))
        out[name] = dict(params=jax.tree_util.tree_map(np.asarray, fin.params), round=int(fin.round), hist=hist,
                         serve=serve, aux=aux, flags=flags, draws=draws)
    return out


def _inject(monkeypatch, flags=None, draws=None):
    monkeypatch.setattr(PC, "event_flags", lambda plan, seed, stream: None if flags is None else flags.copy())
    if draws is not None:
        monkeypatch.setattr(PR, "uniform_draws", lambda n, seed, count: draws[:count].copy())


def _port_serve(name, qps=None, stream=None, **kw):
    graph, horizon, qps0, policy, link_p, budget = CASES[name]
    g = graph(PT)
    d = _data(g.n)
    opt = PO.sgd(1e-3, 0.5)
    state = state_from_numpy(d["params"], optimizer=opt, device="cpu")
    plan = PC.compile_plan(g, "dense", failures=PC.FailureModel(link_p), device="cpu")
    stream = stream if stream is not None else PT.poisson_event_stream(g, horizon, 1.0, seed=1)
    queries = PR.poisson_query_stream(g.n, horizon, qps0 if qps is None else qps, seed=3, pool=TEST_S)
    router = PR.make_router(g, policy, staleness_budget=budget)
    return PF.run_serve_trajectory(
        state, _torch_loss, opt, plan, stream, queries, router, d["xs"], d["ys"], _sched(g.n, horizon), b_local=2,
        n_bins=4, eval_fn=PF.make_eval_fn(_torch_loss), eval_batch=d["test"],
        serve_fn=lambda p, x: torch.argmax(PPM.mlp_forward(p, x[None]), dim=-1)[0], query_xs=d["test"][0],
        device="cpu", **kw,
    )


EXACT_KEYS = ("bin", "time", "events", "messages", "wire_bytes", "staleness", "queries", "serve_latency",
              "serve_staleness")


@pytest.mark.parametrize("name", sorted(CASES))
def test_serve_trajectory_matches_jax(monkeypatch, jax_serve_runs, name):
    ref = jax_serve_runs[name]
    _inject(monkeypatch, ref["flags"], ref["draws"])
    fin, hist, serve, aux = _port_serve(name)
    assert set(serve) == set(ref["serve"]) and serve["node"].size == ref["serve"]["node"].size > 0
    for k in ("time", "home", "node", "latency", "staleness", "hops", "answer"):
        got, want = serve[k], np.asarray(ref["serve"][k])
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    assert set(hist) == set(ref["hist"])
    for k in EXACT_KEYS:
        assert hist[k] == [type(v)(w) for v, w in zip(hist[k], ref["hist"][k])], k
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(hist[k], ref["hist"][k], **TRAJ, err_msg=k)
    assert set(aux) == set(ref["aux"])
    for k in ("node_clock", "node_events", "node_busy"):
        assert np.array_equal(aux[k], np.asarray(ref["aux"][k])), k
    assert aux["staleness_hist"] == ref["aux"]["staleness_hist"] and fin.round == ref["round"]
    params, _ = to_numpy(fin)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(ref["params"])):
        np.testing.assert_allclose(a, b, **TRAJ)
    if ref["flags"] is not None:
        assert 0 < sum(hist["messages"]) < 2 * sum(hist["events"])


def _same_training(a, b):
    (fa, ha, _, xa), (fb, hb, _, xb) = a, b
    assert torch.equal(fa.params, fb.params) and all(torch.equal(x, y) for x, y in zip(fa.opt_state, fb.opt_state))
    assert torch.equal(fa.generator.get_state(), fb.generator.get_state()) and fa.round == fb.round
    assert np.array_equal(xa["node_clock"], xb["node_clock"]) and np.array_equal(xa["node_events"], xb["node_events"])
    for k in ("train_loss", "test_loss", "staleness", "events", "messages", "wire_bytes"):
        assert json.dumps(ha[k]) == json.dumps(hb[k]), k


@pytest.mark.parametrize("name", ["ring6_budget_failures", "ring6_uniform"])
def test_qps0_is_bitwise_the_event_executor_and_load_changes_no_training(name):
    """On the port's own draws: at qps 0 the serving run is
    ``run_event_trajectory`` bit for bit (params, optimizer state, the
    generator after its one draw, every history key); at qps 5 training is
    the same again, while queries were served."""
    graph, horizon, _, _, link_p, _ = CASES[name]
    g = graph(PT)
    d = _data(g.n)
    opt = PO.sgd(1e-3, 0.5)
    state = state_from_numpy(d["params"], optimizer=opt, device="cpu")
    plan = PC.compile_plan(g, "dense", failures=PC.FailureModel(link_p), device="cpu")
    stream = PT.poisson_event_stream(g, horizon, 1.0, seed=1)
    ev = PF.run_event_trajectory(state, _torch_loss, opt, plan, stream, d["xs"], d["ys"], _sched(g.n, horizon),
                                 b_local=2, n_bins=4, eval_fn=PF.make_eval_fn(_torch_loss), eval_batch=d["test"],
                                 device="cpu")
    q0 = _port_serve(name, qps=0.0)
    q5 = _port_serve(name, qps=5.0)
    assert PF.serve_summary(q0[2])["served"] == 0 and q0[1]["queries"] == [0, 0, 0, 0]
    assert PF.serve_summary(q5[2])["served"] > 0
    _same_training((ev[0], ev[1], None, ev[2]), q0)
    _same_training(q0, q5)
    assert set(q0[1]) - set(ev[1]) == {"queries", "serve_latency", "serve_staleness"}
    assert np.array_equal(q0[3]["node_busy"], np.zeros(g.n, np.float32))


def test_serve_chunked_and_padded_runs_are_bitwise():
    """Chunks of 9 merged events and padded envelopes change nothing; the
    hook fires once a chunk with the serving accumulators too."""
    name = "ring6_budget_failures"
    base = _port_serve(name)
    calls = []
    chunked = _port_serve(name, chunk_events=9, on_chunk=lambda ci, i0, i1, acc: calls.append((ci, i0, i1, acc)))
    g = PT.ring(6)
    s0 = PT.poisson_event_stream(g, 8.0, 1.0, seed=1)
    padded = _port_serve(name, stream=PT.poisson_event_stream(g, 8.0, 1.0, seed=1, envelope=s0.n_events + 5))
    for other in (chunked, padded):
        _same_training(base, other)
        for k in base[2]:
            assert np.array_equal(base[2][k], other[2][k], equal_nan=True), k
        assert json.dumps(base[1]) == json.dumps(other[1])
    env = s0.envelope + base[2]["node"].size
    assert [c[:3] for c in calls] == [(ci, i0, min(i0 + 9, env)) for ci, i0 in enumerate(range(0, env, 9))]
    assert calls[-1][3]["serve_cnt"].sum() == base[2]["node"].size
    assert {"serve_lat_sum", "serve_stale_sum", "serve_cnt", "loss_sum", "stale_hist"} <= set(calls[0][3])


def test_hand_built_staleness_latency_and_queueing():
    """The JAX tests' K3 streams: local routing, each query 0.5 after its
    home node's last mix, unqueued; two queries within one service window
    queue behind each other."""
    d = _data(3)
    opt = PO.sgd(1e-3, 0.5)
    g = PT.complete(3)
    plan = PC.compile_plan(g, "dense", device="cpu")
    sched = _sched(3, 3.0)

    def run(times, edges, q_times, q_homes, service, hop):
        state = state_from_numpy(d["params"], optimizer=opt, device="cpu")
        stream = PT.EventStream(times=np.array(times, np.float32), edges=np.array(edges, np.int32),
                                n_events=len(edges), horizon=3.0, rates=np.ones(3))
        queries = PR.QueryStream(times=np.array(q_times, np.float32), homes=np.array(q_homes, np.int32),
                                 qidx=np.zeros(len(q_homes), np.int32), n_queries=len(q_homes), horizon=3.0,
                                 qps=1.0)
        return PF.run_serve_trajectory(state, _torch_loss, opt, plan, stream, queries, PR.make_router(g, "local"),
                                       d["xs"], d["ys"], sched, b_local=2, n_bins=3, service_time=service,
                                       hop_latency=hop, device="cpu")

    _, _, serve, _ = run([1.0, 2.0], [0, 2], [0.5, 1.5, 2.5], [1, 0, 2], 0.05, 0.02)
    np.testing.assert_array_equal(serve["node"], [1, 0, 2])
    np.testing.assert_allclose(serve["staleness"], [0.5, 0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(serve["latency"], [0.05, 0.05, 0.05], atol=1e-6)
    assert np.all(serve["hops"] == 0.0) and np.all(np.isnan(serve["answer"]))
    summ = PF.serve_summary(serve)
    assert summ["served"] == 3 and abs(summ["p50_latency"] - 0.05) < 1e-6
    _, _, serve, aux = run([2.9], [0], [1.0, 1.1], [0, 0], 0.5, 0.0)
    np.testing.assert_allclose(serve["latency"], [0.5, 0.9], atol=1e-6)
    assert aux["node_busy"][0] == np.float32(2.0)


def test_serve_summary_and_errors(jax_serve_runs):
    empty = {k: np.zeros(0) for k in ("latency", "staleness", "hops")}
    assert PF.serve_summary(empty) == JS.serve_summary(empty)
    ref = jax_serve_runs["ring6_budget_failures"]["serve"]
    got, want = PF.serve_summary(ref), JS.serve_summary(ref)
    assert got == want and got["served"] > 0
    d = _data(6)
    opt = PO.sgd(1e-3, 0.5)
    g = PT.ring(6)
    state = state_from_numpy(d["params"], optimizer=opt, device="cpu")
    plan = PC.compile_plan(g, "dense", device="cpu")
    stream = PT.poisson_event_stream(g, 4.0, 1.0, seed=1)
    args = (d["xs"], d["ys"], _sched(6, 4.0))
    with pytest.raises(ValueError, match="horizon"):
        PF.run_serve_trajectory(state, _torch_loss, opt, plan, stream, PR.poisson_query_stream(6, 5.0, 1.0),
                                PR.make_router(g), *args, b_local=2, device="cpu")
    no_gen = dataclasses.replace(state, generator=None)
    with pytest.raises(ValueError, match="generator"):
        PF.run_serve_trajectory(no_gen, _torch_loss, opt, plan, stream, PR.poisson_query_stream(6, 4.0, 1.0),
                                PR.make_router(g, "uniform"), *args, b_local=2, device="cpu")
    with pytest.raises(ValueError, match="statically compiled"):
        PF.run_serve_trajectory(state, _torch_loss, opt, PC.compile_schedule([g, g], "dense", device="cpu"), stream,
                                PR.poisson_query_stream(6, 4.0, 1.0), PR.make_router(g), *args, b_local=2,
                                device="cpu")


# ---------------------------------------------------- CLI, fig13, example
SERVE_BASE = ["--device", "cpu", "--nodes", "4", "--horizon", "3", "--per-node", "16", "--test-size", "32",
              "--bins", "3"]


@pytest.mark.parametrize("extra", [[], ["--router", "uniform", "--link-p", "0.8"], ["--router", "local"],
                                   ["--topology", "kreg", "--qps", "0", "--log-queries", "0"]],
                         ids=["consensus", "uniform-link", "local", "kreg-qps0"])
def test_serve_cli_on_cpu(capsys, extra):
    hist, summ = serve_cli.main([*SERVE_BASE, *extra])
    out = capsys.readouterr().out
    n_q = int(out.split("serving ")[1].split()[0])
    n_ev = int(out.split("queries (qps=")[1].split("over ")[1].split()[0])
    assert summ["served"] == n_q == sum(hist["queries"]) and sum(hist["events"]) == n_ev
    assert hist["bin"] == [0, 1, 2] and "p50_latency" in out and np.isfinite(summ["test_loss_final"])
    if "--qps" in extra:
        assert n_q == 0 and summ["p50_latency"] == 0.0


def test_serve_cli_telemetry_is_refused(capsys):
    with pytest.raises(SystemExit):
        serve_cli.main([*SERVE_BASE, "--telemetry", "run.jsonl"])
    assert "item 14" in capsys.readouterr().err


def _norm(kwargs):
    out = {}
    for k, v in kwargs.items():
        if k in ("device", "on_chunk", "eval_fn", "optimizer"):
            continue
        if isinstance(v, (JT.Graph, PT.Graph)):
            v = (v.name, v.adjacency.tobytes())
        elif isinstance(v, (JR.QueryStream, PR.QueryStream, JT.EventStream, PT.EventStream)):
            v = (v.n_queries if hasattr(v, "n_queries") else v.n_events, np.asarray(v.times).tobytes())
        elif isinstance(v, (JR.Router, PR.Router)):
            v = (v.policy, np.asarray(v.hops).tobytes(), v.staleness_budget)
        elif isinstance(v, np.ndarray):
            v = v.tobytes()
        elif isinstance(v, tuple):
            v = tuple(np.asarray(a).tobytes() for a in v)
        elif callable(v) or isinstance(v, (PF.DFLState, JF.DFLState, PC.CommPlan, JC.CommPlan)):
            continue
        out[k] = v
    return out


def test_fig13_call_for_call_and_record_keys(monkeypatch, tmp_path):
    """Both fig13 modules' serving runs replaced by one recorder: the same
    calls, the same rows and records, ``BENCH_serve.json``'s keys, and the
    acceptance assertion on the same records."""
    names = ("state", "loss_fn", "optimizer", "plan", "stream", "queries", "router", "xs", "ys", "schedule")
    calls = {"jax": [], "torch": []}

    def make(side):
        def rec(*args, **kw):
            kw = {**dict(zip(names, args)), **kw}
            calls[side].append(_norm(kw))
            r = kw["router"]
            stale = {"uniform": 1.0, "local": 0.9, "consensus": 0.5}[r.policy]
            n_q = kw["queries"].n_queries
            serve = {"latency": np.linspace(0.2, 0.4, n_q), "staleness": np.full(n_q, stale),
                     "hops": np.full(n_q, 1.0 if r.policy == "uniform" else 0.0)}
            hist = {"train_loss": [2.0, 1.5], "test_loss": [2.1, 1.6 + stale / 10]}
            if kw.get("on_chunk") is not None:
                kw["on_chunk"](0, 0, 4, {})
                kw["on_chunk"](1, 4, 8, {})
            return None, hist, serve, {}

        return rec

    monkeypatch.setattr(jfig13, "run_serve_trajectory", make("jax"))
    monkeypatch.setattr(pfig13, "run_serve_trajectory", make("torch"))
    monkeypatch.setattr(jfig13, "OUT", tmp_path / "jax.json")
    # the recorder ignores the state: skip both inits (JAX's eager one takes seconds)
    monkeypatch.setattr(jfig13, "init_fl_state", lambda *a, **kw: None)
    monkeypatch.setattr(pfig13, "init_fl_state", lambda *a, **kw: None)
    pcommon.ROWS.clear()
    jfig13.emit.__globals__["ROWS"].clear()
    jfig13.run(quick=True)
    got = pfig13.run(quick=True, device="cpu", out_path=tmp_path / "torch.json")
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) == 12
    strip = lambda recs: [{k: v for k, v in r.items() if k not in ("queries_per_wall_second", "us_per_event_steady",  # noqa: E731
                                                                    "compile_seconds")} for r in recs]
    want = json.loads((tmp_path / "jax.json").read_text())
    assert strip(got["records"]) == strip(want["records"]) and got["consensus_wins"] == want["consensus_wins"]
    assert [r.split(",")[0] for r in pcommon.ROWS] == [r.split(",")[0] for r in jfig13.emit.__globals__["ROWS"]]
    bench = json.loads((ROOT / "BENCH_serve.json").read_text())
    assert set(got) == set(bench) and all(set(r) == set(bench["records"][0]) for r in got["records"])


def test_example_pieces_for_two_rounds():
    """The consensus example at its sizes on the CPU for two rounds: finite
    falling losses, one mixing call a round, consensus and routed serving
    (each query to its home node, which equal clocks give), greedy tokens
    of the consensus equal to ``generate``'s."""
    q = pex.setup("cpu")
    assert q.state.params.shape == (8, q.state.layout.size) and q.state.layout.size == 361_600
    state, hist = pex.train(q, 2)
    assert hist["round"] == [0, 1] and all(np.isfinite(hist["train_loss"]))
    got = pex.serve(q, state)
    assert got["consensus"].shape == got["nodes"].shape == (4, pex.N_NEW)
    assert got["assignments"].tolist() == [0, 1, 2, 3]
    again = PF.generate(PF.consensus_params(state.tree), q.cfg, got["prompts"], pex.N_NEW, 128, device="cpu")
    assert np.array_equal(_np(again), got["consensus"])
