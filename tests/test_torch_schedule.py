"""Time-varying topologies of the port (``PlanSchedule``, ``churn_sequence``,
the edge colouring, the circulant and failure-mask functions, the
executor's chunk hook, fig8 and the rounds bench) against the JAX package's.

- The numpy copies (``Graph.edge_coloring``, ``churn_sequence``) are
  bitwise the JAX package's arrays.
- A K = 1 schedule is bitwise the static plan, on every backend, clean and
  at link_p 0.6: trajectories (params, history, wire counts), mix, spread,
  spread_min and int8 rounds.
- K > 1 rounds, gossip and walks are held exactly on injected draws: the
  JAX schedule's ``round_masks(round_key(k, r))`` (threefry's ``fold_in``
  cannot be replayed in torch) are fed to the port as ``active`` /
  ``edge_live`` masks, or through the hooks the port draws from
  (``engine._round_masks``, ``engine._draw_sketches``, the walker's
  ``_uniforms`` / ``_step_masks`` / ``_resample``, and the generator-keyed
  ``commplan._draw_failure_masks``).  Tolerances: a round rtol 1e-5 /
  atol 1e-6 on fp32 (bf16 leaves 1e-2), ``spread_min`` and the walker
  bitwise, trajectories rtol 1e-4 / atol 1e-5 (ROADMAP.md Queue 3).
- The port's own draws are held statistically: every plan draws at the
  schedule's envelope, keep rates within a binomial bound.
- ``mix_pytree_circulant`` against the JAX function under ``shard_map`` on
  8 forced host devices, in a subprocess (as ``tests/test_distributed.py``).
- A chunked run is bitwise the unchunked one; fig8 and the rounds bench
  are held call for call (both sides' runners replaced by one recorder).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.gossip as JG  # noqa: E402
from benchmarks import fig8_churn as jfig8  # noqa: E402
from benchmarks import rounds_bench as jrounds  # noqa: E402
from repro import fed as JF  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.core import commplan as JC  # noqa: E402
from repro.core import compress as JCC  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.initialisation import InitConfig as JInitConfig  # noqa: E402
from repro.data import batch_index_schedule, mnist_like, node_datasets  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402
from repro_torch import core as PCore  # noqa: E402
from repro_torch import fed as PF  # noqa: E402
from repro_torch import gossip as PG  # noqa: E402
from repro_torch import optim as PO  # noqa: E402
from repro_torch.benchmarks import common as pcommon  # noqa: E402
from repro_torch.benchmarks import fig8_churn as pfig8  # noqa: E402
from repro_torch.benchmarks import rounds_bench as prounds  # noqa: E402
from repro_torch.convert import state_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import decavg as PD  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.compress import Compression, compressed_mix  # noqa: E402
from repro_torch.core.initialisation import InitConfig  # noqa: E402
from repro_torch.fed import executor as PX  # noqa: E402
from repro_torch.gossip import engine as PE  # noqa: E402
from repro_torch.gossip import walker as PW  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import paper_models as PPM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=1e-5)
KEYS = ("train_loss", "test_loss", "sigma_ap", "sigma_an")
N, PER, BS, BL, ROUNDS, HIDDEN = 6, 48, 8, 2, 8, (32,)
# the ten families of tests/test_commplan.py
FAMILIES = {
    "complete": lambda T: T.complete(16),
    "ring": lambda T: T.ring(16),
    "circulant": lambda T: T.circulant(16, (1, 2)),
    "kreg": lambda T: T.random_k_regular(16, 4, seed=0),
    "er_gnp": lambda T: T.erdos_renyi_gnp(16, 4.5 / 16 + 0.05, seed=0),
    "er_gnm": lambda T: T.erdos_renyi_gnm(16, 48, seed=0),
    "ba": lambda T: T.barabasi_albert(16, 3, seed=0),
    "heavy_tail": lambda T: T.configuration_heavy_tail(16, 2.2, seed=0),
    "torus": lambda T: T.torus_lattice((4, 4)),
    "star": lambda T: T.star(16),
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


def _churn(T, base_fn=lambda T: T.random_k_regular(16, 4, seed=0), k=3, rate=0.25, seed=2):
    return T.churn_sequence(base_fn(T), k, rate, seed=seed)


def _schedules(backend, link_p=1.0, node_p=1.0, period=2, **kw):
    """The same churned K = 3 schedule in both packages (the port's without
    a failure model when the draws are injected as masks)."""
    gj, gp = _churn(JT, **kw), _churn(PT, **kw)
    sj = JC.compile_schedule(gj, backend, failures=JC.FailureModel(link_p, node_p), round_map=JC.cyclic_map(period))
    sp = PC.compile_schedule(gp, backend, failures=PC.FailureModel(link_p, node_p), round_map=PC.cyclic_map(period),
                             device="cpu")
    return sj, sp


def _jax_round_masks(sj, key, rounds, offset=0):
    """The JAX gossip rounds' draws: {r: (node_active, edge_keep)} at the envelope."""
    out = {}
    for r in range(offset, offset + rounds):
        ek, na = sj.round_masks(sj.round_key(jax.random.fold_in(key, r), r))
        out[r] = (np.asarray(na), np.asarray(ek))
    return out


def _inject_rounds(monkeypatch, masks):
    monkeypatch.setattr(PE, "_round_masks", lambda plan, seed, r: tuple(torch.from_numpy(a.copy()) for a in masks[r]))


def _inject_draws(monkeypatch, masks):
    """The port's failure draws become ``masks[i]``, i the order in which the
    generator states are first seen: a round's draw and its wire count's
    replay (a copy of the generator taken before the round) get the same
    masks, and every draw advances the stream."""
    seen = {}

    def fake(failures, width, n, generator):
        i = seen.setdefault(bytes(generator.get_state().numpy()), len(seen))
        torch.rand(1, generator=generator)
        ek, na = masks[i]
        assert ek.shape[0] == width
        return ek.clone(), na.clone()

    monkeypatch.setattr(PC, "_draw_failure_masks", fake)


# ----------------------------------------------------------------- topology
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_edge_coloring_matches_jax(family):
    got, want = FAMILIES[family](PT).edge_coloring(), FAMILIES[family](JT).edge_coloring()
    np.testing.assert_array_equal(got.partners, want.partners)
    np.testing.assert_array_equal(got.edge_index, want.edge_index)
    assert got.partners.dtype == want.partners.dtype and got.n_colors == want.n_colors
    # each colour a matching: an involution, every edge once at both ends
    idx = np.arange(16)
    assert np.all(got.partners[np.arange(got.n_colors)[:, None], got.partners] == idx)
    seen = np.sort(got.edge_index[got.edge_index >= 0])
    np.testing.assert_array_equal(seen, np.repeat(np.arange(FAMILIES[family](PT).n_edges), 2))


@pytest.mark.parametrize("case", [(lambda T: T.random_k_regular(24, 4, seed=0), 5, 0.2, 1),
                                  (lambda T: T.barabasi_albert(32, 3, seed=4), 4, 0.05, 7),
                                  (lambda T: T.configuration_heavy_tail(32, 2.2, seed=1), 3, 0.3, 3)],
                         ids=["kreg", "ba", "heavy_tail"])
def test_churn_sequence_matches_jax(case):
    base, k, rate, seed = case
    got, want = PT.churn_sequence(base(PT), k, rate, seed=seed), JT.churn_sequence(base(JT), k, rate, seed=seed)
    assert [g.name for g in got] == [g.name for g in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.adjacency, w.adjacency)
        assert g.adjacency.dtype == w.adjacency.dtype


def test_churn_sequence_properties():
    """The JAX package's properties test (tests/test_plan_schedule.py)."""
    base = PT.random_k_regular(24, 4, seed=0)
    gs = PT.churn_sequence(base, 5, 0.2, seed=1)
    assert len(gs) == 5 and gs[0] is base
    for g in gs:
        assert g.n == base.n and g.is_connected()
        assert np.all(np.diag(g.adjacency) == 0)
        assert g.n_edges == base.n_edges
    assert any(not np.array_equal(g.adjacency, base.adjacency) for g in gs[1:])
    for g in PT.churn_sequence(base, 3, 0.0, seed=1)[1:]:
        np.testing.assert_array_equal(g.adjacency, base.adjacency)
    for bad in (dict(k_plans=2, churn_rate=1.0), dict(k_plans=0, churn_rate=0.1)):
        with pytest.raises(ValueError):
            PT.churn_sequence(base, **bad)
        with pytest.raises(ValueError):
            JT.churn_sequence(JT.random_k_regular(24, 4, seed=0), **bad)


def test_round_map_kinds():
    graphs = _churn(PT)
    cyc = PC.compile_schedule(graphs, "dense", round_map=PC.cyclic_map(2), device="cpu")
    assert [cyc.plan_index(r) for r in range(8)] == [0, 0, 1, 1, 2, 2, 0, 0]
    seq = PC.compile_schedule(graphs, "dense", round_map=PC.sequence_map([2, 0, 1]), device="cpu")
    assert [seq.plan_index(r) for r in range(5)] == [2, 0, 1, 2, 0]
    sj = JC.compile_schedule(_churn(JT), "dense", round_map=JC.sequence_map([2, 0, 1]))
    assert [seq.plan_index(r) for r in range(7)] == [int(sj.plan_index(r)) for r in range(7)]
    assert seq.select(1) is seq.plans[0] and seq.k == 3 and seq.graph is graphs[0]
    with pytest.raises(ValueError):
        PC.compile_schedule(graphs, "dense", round_map=PC.sequence_map([0, 3]), device="cpu")
    with pytest.raises(ValueError):
        PC.compile_schedule([PT.ring(4), PT.ring(6)], "dense", device="cpu")
    with pytest.raises(ValueError):
        PC.RoundMap("cyclic", period=0)
    # the event rendering picks a window's plan on the host as the JAX package's host replica does
    cj = JC.compile_schedule(_churn(JT), "dense", round_map=JC.cyclic_map(2))
    for r in range(9):
        assert cyc.plan_index(r) == cj._host_plan_index(r) and seq.plan_index(r) == sj._host_plan_index(r)
        assert cyc._window(r + 0.5) == r and cyc.select(cyc._window(r + 0.5)) is cyc.plans[cyc.plan_index(r)]


def test_core_exports_the_reference_names():
    names = ("PlanSchedule", "RoundMap", "compile_schedule", "cyclic_map", "sequence_map", "mix_pytree_colored",
             "mix_pytree_circulant", "link_failure_mask", "node_failure_mask", "churn_sequence")
    import repro.core as JCore

    for name in names:
        assert name in PCore.__all__ and hasattr(PCore, name) and hasattr(JCore, name), name


# -------------------------------------------------------- K = 1 is bitwise
@pytest.fixture(scope="module")
def setup():
    ds = mnist_like(N * PER + 64, seed=0)
    xs, ys = node_datasets(ds, [np.arange(i * PER, (i + 1) * PER) for i in range(N)])
    rng = np.random.default_rng(0)
    dims = (784, *HIDDEN, 10)
    params = {f"fc{i}": {"w": (rng.standard_normal((N, a, b)) * np.sqrt(2.0 / a) * 2.0).astype(np.float32),
                         "b": np.zeros((N, b), np.float32)} for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    return dict(xs=xs, ys=ys, test=(ds.x[-64:], ds.y[-64:]), params=params,
                sched=batch_index_schedule(PER, N, BS, ROUNDS * BL, seed=0))


def torch_loss(p, b):
    return PPM.classifier_loss(PPM.mlp_forward(p, b[0]), b[1])


def jax_loss(p, b):
    return JPM.classifier_loss(JPM.mlp_forward(p, b[0]), b[1])


def _port_run(setup, plan, link_p=1.0, compression=None, **kw):
    opt = PO.sgd(1e-3, 0.5)
    rf = PF.make_round_fn(torch_loss, opt, plan, link_p=link_p, compression=compression)
    state = state_from_numpy(setup["params"], optimizer=opt, device="cpu")
    return PF.run_trajectory(state, rf, setup["xs"], setup["ys"], setup["sched"], n_rounds=ROUNDS, eval_every=3,
                             eval_fn=PF.make_eval_fn(torch_loss), eval_batch=setup["test"], track_sigmas=True,
                             b_local=BL, device="cpu", **kw)


def _jax_run(setup, plan, link_p=1.0):
    opt = JO.sgd(1e-3, 0.5)
    rf = JF.make_round_fn(jax_loss, opt, plan, link_p=link_p)
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    state = JF.DFLState(params=params, opt_state=jax.vmap(opt.init)(params), round=jnp.zeros((), jnp.int32),
                        rng=jax.random.PRNGKey(0))
    return JF.run_trajectory(state, rf, setup["xs"], setup["ys"], setup["sched"], n_rounds=ROUNDS, eval_every=3,
                             eval_fn=JF.make_eval_fn(jax_loss), eval_batch=setup["test"], track_sigmas=True,
                             b_local=BL)


@pytest.mark.parametrize("link_p", [1.0, 0.6])
@pytest.mark.parametrize("backend", PC.BACKENDS)
def test_size1_schedule_bit_identical(setup, backend, link_p):
    """A K = 1 schedule ≡ its static plan, bit for bit: a trajectory (params,
    history, wire counts), uncompressed and int8, and mix / spread /
    spread_min from the same generator state."""
    g = PT.random_k_regular(N, 3, seed=0)
    plan = PC.compile_plan(g, backend, device="cpu")
    sched = PC.compile_schedule([g], backend, device="cpu")
    for comp in (None, Compression("int8", chunk=256)):
        s_pl, h_pl = _port_run(setup, plan, link_p, comp)
        s_sc, h_sc = _port_run(setup, sched, link_p, comp)
        assert torch.equal(s_pl.params, s_sc.params) and h_pl == h_sc
        assert comp is None or torch.equal(s_pl.residual, s_sc.residual)
    fm = PC.FailureModel(link_p)
    plan, sched = plan.with_options(failures=fm), sched.with_options(failures=fm)
    x = torch.randn(N, 40, generator=torch.Generator().manual_seed(1))
    for r in (0, 5):
        for op, kw in (("mix", {}), ("spread", {}), ("spread_min", {}),
                       ("mix", dict(compression=Compression("int8", chunk=16), residual=torch.zeros(N, 40)))):
            g1, g2 = torch.Generator().manual_seed(r), torch.Generator().manual_seed(r)
            a = getattr(plan, op)(x, g1 if fm.active else None, **kw)
            b = getattr(sched, op)(x, r, g2 if fm.active else None, **kw)
            for t1, t2 in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                assert torch.equal(t1, t2), (op, r)
        g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
        assert int(plan.wire_messages(g1 if fm.active else None)) == int(sched.wire_messages(r, g2 if fm.active else None))


# ------------------------------------------- K > 1 on injected JAX draws
def _tree_np(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n, 6, 3)).astype(np.float32), "h": rng.standard_normal((n, 17)).astype(np.float32)}


def _close_tree(got, want):
    np.testing.assert_allclose(_np(got["w"]), np.asarray(want["w"]), **TOL)
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got["h"].float()), np.asarray(want["h"], np.float32), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("backend", PC.BACKENDS)
def test_schedule_rounds_match_jax_on_injected_draws(backend):
    """K = 3 churned schedule, cyclic period 2: each round's JAX draw (plan id
    folded into the key, masks at the envelope) fed to the port as masks;
    mix (a dict with a bf16 leaf), spread, spread_min and an int8 round;
    and the clean rounds (the JAX package's gathered envelope against the
    active plan itself)."""
    sj, _ = _schedules(backend, link_p=0.6, node_p=0.9)
    sj_clean, sp = _schedules(backend)
    assert sp.n_edges_env == sj.n_edges_env and all(p.draw_width == sp.n_edges_env for p in sp.plans)
    p_np = _tree_np(16)
    p_j = {"w": jnp.asarray(p_np["w"]), "h": jnp.asarray(p_np["h"]).astype(jnp.bfloat16)}
    p_t = {"w": torch.as_tensor(p_np["w"]), "h": torch.as_tensor(p_np["h"]).to(torch.bfloat16)}
    x = np.random.default_rng(1).random((16, 3)).astype(np.float32)
    flat = np.random.default_rng(2).standard_normal((16, 96)).astype(np.float32)
    comp_j, comp_t = JCC.Compression("int8", chunk=32), Compression("int8", chunk=32)
    key = jax.random.PRNGKey(7)
    for r in range(6):
        k_r = jax.random.fold_in(key, r)
        ek, na = sj.round_masks(sj.round_key(k_r, r))
        m = dict(active=torch.as_tensor(np.array(na)), edge_live=torch.as_tensor(np.array(ek)))
        _close_tree(sp.mix(p_t, r, **m), sj.mix(p_j, r, k_r))
        _close_tree(sp.mix(p_t, r), sj_clean.mix(p_j, r))
        np.testing.assert_allclose(_np(sp.spread(torch.as_tensor(x), r, **m)), np.asarray(sj.spread(x, r, k_r)), **TOL)
        np.testing.assert_array_equal(_np(sp.spread_min(torch.as_tensor(x), r, **m)),
                                      np.asarray(sj.spread_min(x, r, k_r)))
        want = jax.jit(lambda v, h, k, r=r: JCC.compressed_mix(sj, v, h, k, compression=comp_j, round_index=r))(
            jnp.asarray(flat), jnp.zeros_like(flat), k_r)
        got = compressed_mix(sp, torch.as_tensor(flat), torch.zeros(16, 96), compression=comp_t, round_index=r, **m)
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))  # the new mirrors: the codec is elementwise
        np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **TOL)


def test_schedule_draws_at_the_envelope_on_own_draws():
    """The port's own draws: every plan of a schedule draws at the edge
    envelope, so the generator moves the same amount whichever plan is
    active; keep rates within a binomial bound of link_p / node_p; both
    directions of an edge agree; the wire count replays the round's draw."""
    graphs = [PT.complete(8), PT.ring(8)]
    fm = PC.FailureModel(0.6, 0.8)
    sched = PC.compile_schedule(graphs, "dense", failures=fm, round_map=PC.cyclic_map(1), device="cpu")
    assert sched.n_edges_env == 28 and [p.draw_width for p in sched.plans] == [28, 28]
    x = torch.randn(8, 4)
    states = []
    for r in (0, 1):
        g = torch.Generator().manual_seed(3)
        sched.mix(x, r, g)
        states.append(g.get_state())
    assert torch.equal(states[0], states[1])
    g = torch.Generator().manual_seed(0)
    keep_edges, keep_nodes, rounds = 0, 0, 400
    for r in range(rounds):
        before = torch.Generator().set_state(g.get_state())
        op = sched.select(r).round_operator(before)
        before = torch.Generator().set_state(g.get_state())
        ek, na = sched.round_masks(before)
        assert ek.shape == (28,) and na.shape == (8,)
        keep_edges, keep_nodes = keep_edges + int(ek.sum()), keep_nodes + int(na.sum())
        off = (_np(op) > 0) & ~np.eye(8, dtype=bool)
        assert np.array_equal(off, off.T)
        assert int(sched.wire_messages(r, torch.Generator().set_state(g.get_state()))) == int(off.sum())
        sched.mix(x, r, g)
    for got, total, p in ((keep_edges, 28 * rounds, 0.6), (keep_nodes, 8 * rounds, 0.8)):
        assert abs(got / total - p) < 4 * np.sqrt(p * (1 - p) / total)


def test_failure_masks_statistics():
    """link_failure_mask / node_failure_mask on the port's generator: the
    JAX masks' structure (symmetric, within the adjacency, a dropped node's
    row and column empty) and keep rates within a binomial bound (the node
    mask on a complete graph, where a live node always keeps an edge)."""
    g, gc = PT.barabasi_albert(24, 3, seed=0), PT.complete(24)
    assert np.array_equal(g.adjacency, JT.barabasi_albert(24, 3, seed=0).adjacency)
    gen = torch.Generator().manual_seed(0)
    a = g.adjacency
    kept, nodes, draws = 0, 0, 300
    for _ in range(draws):
        lm = _np(PD.link_failure_mask(gen, g, 0.7))
        assert lm.dtype == a.dtype and np.array_equal(lm, lm.T) and np.all(lm <= a) and np.all(np.diag(lm) == 0)
        kept += int(np.triu(lm, 1).sum())
        nm = _np(PD.node_failure_mask(gen, gc, 0.6))
        alive = nm.sum(1) > 0
        assert np.array_equal(nm, nm.T) and np.all(nm[~alive] == 0)
        np.testing.assert_array_equal(nm[np.ix_(alive, alive)], gc.adjacency[np.ix_(alive, alive)])
        nodes += int(alive.sum())
    total = g.n_edges * draws
    assert abs(kept / total - 0.7) < 4 * np.sqrt(0.21 / total)
    assert abs(nodes / (24 * draws) - 0.6) < 4 * np.sqrt(0.24 / (24 * draws))


_SCRIPT_CIRCULANT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    try:
        shard_map = jax.shard_map
    except AttributeError:
        from jax.experimental.shard_map import shard_map
    from repro.core.decavg import mix_pytree_circulant

    inp = np.load(sys.argv[1])
    params = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
    mesh = jax.make_mesh((8,), ("data",))
    specs = {"w": P("data", None, None), "b": P("data", None)}
    out = {}
    for tag, weights in (("uniform", None), ("weighted", jnp.asarray(inp["weights"]))):
        with mesh:
            got = jax.jit(shard_map(
                lambda p: mix_pytree_circulant(p, offsets=(1, 3), axis_name="data", weights=weights),
                mesh=mesh, in_specs=(specs,), out_specs=specs))(params)
        out.update({f"{tag}_{k}": np.asarray(v) for k, v in got.items()})
    np.savez(sys.argv[2], **out)
    """
)


def test_circulant_matches_jax_shard_map(tmp_path):
    """The JAX function under shard_map, one node a device (8 forced host
    devices, a subprocess), against the port's roll rendering."""
    rng = np.random.default_rng(0)
    inp = dict(w=rng.standard_normal((8, 16, 4)).astype(np.float32), b=rng.standard_normal((8, 5)).astype(np.float32),
               weights=np.array([0.4, 0.2, 0.1, 0.2, 0.1], np.float32))
    np.savez(tmp_path / "in.npz", **inp)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", "")}
    subprocess.run([sys.executable, "-c", _SCRIPT_CIRCULANT, str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                   check=True, env=env, timeout=300)
    want = np.load(tmp_path / "out.npz")
    params = {"w": torch.as_tensor(inp["w"]), "b": torch.as_tensor(inp["b"])}
    for tag, weights in (("uniform", None), ("weighted", torch.as_tensor(inp["weights"]))):
        got = PD.mix_pytree_circulant(params, (1, 3), weights)
        for k in params:
            np.testing.assert_allclose(_np(got[k]), want[f"{tag}_{k}"], **TOL, err_msg=f"{tag} {k}")
    # uniform weights on the circulant graph are its DecAvg operator
    m = PCore.receive_matrix(PT.circulant(8, (1, 3))).astype(np.float32)
    flat = torch.as_tensor(inp["b"])
    np.testing.assert_allclose(_np(PD.mix_pytree_circulant(flat, (1, 3))), m @ inp["b"], rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="item 17"):
        PD.mix_pytree_circulant(flat, (1,), process_group=object())
    with pytest.raises(NotImplementedError, match="item 17"):
        PD.mix_pytree_colored(flat, np.zeros((0, 8), np.int32), torch.zeros(0, 8), torch.ones(8),
                              process_group=object())


# ---------------------------------------------------- gossip over schedules
@pytest.mark.parametrize("backend", PC.BACKENDS)
def test_push_sum_over_schedule_matches_jax(monkeypatch, backend):
    """Clean, and at link_p 0.6 / node_p 0.9 on the JAX engine's draws."""
    vals = np.linspace(-2.0, 4.0, 16).astype(np.float32)
    for link_p, node_p in ((1.0, 1.0), (0.6, 0.9)):
        sj, sp = _schedules(backend, link_p, node_p)
        key = jax.random.PRNGKey(9) if link_p < 1 else None
        if key is not None:
            _inject_rounds(monkeypatch, _jax_round_masks(sj, key, 30))
        want, want_tr = JG.push_sum(sj, vals, 30, key, trace=True)
        got, got_tr = PG.push_sum(sp, vals, 30, 0, trace=True)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        np.testing.assert_allclose(_np(got_tr), np.asarray(want_tr), **TOL)


@pytest.mark.parametrize("backend", ["sparse", "ppermute"])
def test_power_iteration_and_leaderless_over_schedule_match_jax(monkeypatch, backend):
    sj, sp = _schedules(backend, link_p=0.7)
    key = jax.random.PRNGKey(11)
    _inject_rounds(monkeypatch, _jax_round_masks(sj, key, 28))
    want = JG.power_iteration_norm(sj, 12, 16, key, leader=2)
    got = PG.power_iteration_norm(sp, 12, 16, 0, leader=2)
    for k in ("vnorm", "n_hat", "x"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), **TOL, err_msg=k)
    np.testing.assert_array_equal(_np(got["reached"]), np.asarray(want["reached"]))
    k_draw, k_round = jax.random.split(jax.random.PRNGKey(6))
    sketches = jax.random.exponential(k_draw, (16, 32))
    _inject_rounds(monkeypatch, _jax_round_masks(sj, k_round, 10))
    monkeypatch.setattr(PE, "_draw_sketches", lambda seed, n, m, device: torch.as_tensor(np.array(sketches)))
    want, want_mins = JG.estimate_size_leaderless(sj, 10, jax.random.PRNGKey(6), return_sketches=True)
    got, got_mins = PG.estimate_size_leaderless(sp, 10, 0, return_sketches=True)
    np.testing.assert_array_equal(_np(got_mins), np.asarray(want_mins))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("graphs", [
    lambda T: _churn(T, base_fn=lambda T: T.configuration_heavy_tail(32, 2.2, seed=0), rate=0.3, seed=1),
    lambda T: [T.ring(16), T.complete(16), T.barabasi_albert(16, 3, seed=0)],
], ids=["churn", "unequal_nnz"])
def test_stacked_csr_matches_jax(graphs):
    """The walker's per-round tables: every plan's CSR padded to the
    envelope, equal to the JAX package's, also where the plans' edge counts
    differ (the padding)."""
    want = JC.compile_schedule(graphs(JT), "sparse").stacked_csr()
    got = PC.compile_schedule(graphs(PT), "sparse", device="cpu").stacked_csr()
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("with_failures", [False, True])
def test_walker_over_schedule_matches_jax(monkeypatch, with_failures):
    """Step r moves over the CSR of the plan active at round r; the polled
    degree is read in the last step's plan.  The JAX walker's uniforms,
    per-step masks (plan id folded in) and resample keys injected."""
    lp = 0.6 if with_failures else 1.0
    base = lambda T: T.configuration_heavy_tail(32, 2.2, seed=0)  # noqa: E731
    sj, sp = _schedules("sparse", lp, base_fn=base, rate=0.3, seed=1)
    key, walk_length, n_walks = jax.random.PRNGKey(2), 9, 24
    starts = np.arange(32)
    k_walk, k_resample = jax.random.split(key)
    uniforms, masks = [], []
    for r, k in enumerate(jax.random.split(k_walk, walk_length)):
        if with_failures:
            k, k_fail = jax.random.split(k)
            ek, na = sj.round_masks(sj.round_key(k_fail, r))
            masks.append((np.array(ek), np.array(na)))
        uniforms.append(np.array(jax.random.uniform(k, (32, n_walks))))
    rows = jax.random.split(k_resample, 32)
    monkeypatch.setattr(PW, "_uniforms", lambda gen, shape: torch.as_tensor(uniforms.pop(0)))
    monkeypatch.setattr(PW, "_step_masks", lambda plan, gen: tuple(torch.as_tensor(a) for a in masks.pop(0)))

    def resample(gen, ks):
        ksj = jnp.asarray(_np(ks))
        logits = jnp.where(ksj > 0, -jnp.log(jnp.maximum(ksj, 1e-30)), -1e30)
        idx = jax.vmap(lambda k, lg: jax.random.categorical(k, lg, shape=(n_walks,)))(rows, logits)
        return torch.as_tensor(np.array(idx)).long()

    monkeypatch.setattr(PW, "_resample", resample)
    want = JG.poll_degrees_device(sj.graph, starts, walk_length=walk_length, n_walks=n_walks, key=key, plan=sj)
    got = PG.poll_degrees_device(sp.graph, starts, walk_length=walk_length, n_walks=n_walks, seed=0, plan=sp)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert not uniforms and not masks


def test_budget_masked_estimator_replays_standalone_budget_over_schedule():
    """A max-budget estimator run at budget b gives a budget-b estimator's
    gains bitwise, on a failing schedule (the port's own draws)."""
    sched = PC.compile_schedule(PT.churn_sequence(PT.random_k_regular(16, 4, seed=0), 3, 0.3, seed=1), "sparse",
                                failures=PC.FailureModel(link_p=0.7), round_map=PC.cyclic_map(2), device="cpu")
    for kw in (dict(), dict(leaderless=True), dict(mode="alpha", leaderless=True), dict(mode="degree")):
        est_max = PG.make_gain_estimator(sched, pi_rounds=24, ps_rounds=24, walk_length=6, n_walks=16, **kw)
        est_b = PG.make_gain_estimator(sched, pi_rounds=8, ps_rounds=8, walk_length=6, n_walks=16, **kw)
        got = est_max(3, 8)
        assert torch.equal(got, est_b(3)), kw
        assert torch.isfinite(got).all()


def test_each_plan_builds_its_send_operator_once():
    """Gossip phases over a failing schedule: each plan's Mᵀ is built at its
    first send-form round and kept across phases and calls."""
    sched = PC.compile_schedule(PT.churn_sequence(PT.random_k_regular(40, 4, seed=0), 4, 0.2, seed=1), "sparse",
                                failures=PC.FailureModel(link_p=0.8), device="cpu")
    builds = []
    real = PC.CommPlan._send.func

    def counting(self):
        builds.append(id(self))
        return real(self)

    cached = PC.functools.cached_property(counting)
    cached.__set_name__(PC.CommPlan, "_send")
    try:
        PC.CommPlan._send = cached
        for seed in (0, 1):
            PG.power_iteration_norm(sched, 8, 8, seed)
    finally:
        PC.CommPlan._send = PC.functools.cached_property(real)
        PC.CommPlan._send.__set_name__(PC.CommPlan, "_send")
    assert len(builds) == len(set(builds)) == 4


# ------------------------------------------------------------ the executor
@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_churned_trajectory_matches_jax(monkeypatch, setup, backend):
    """K = 3 churned schedule at link_p 0.7: the JAX run's draws (its key
    stream, the plan id folded in, at the envelope) injected into the
    port's rounds; history and params at the trajectory tolerance, the wire
    counts equal."""
    gj = JT.churn_sequence(JT.random_k_regular(N, 3, seed=0), 3, 0.4, seed=1)
    gp = PT.churn_sequence(PT.random_k_regular(N, 3, seed=0), 3, 0.4, seed=1)
    sj = JC.compile_schedule(gj, backend, round_map=JC.cyclic_map(2))
    sp = PC.compile_schedule(gp, backend, round_map=PC.cyclic_map(2), device="cpu")
    fj = sj.with_options(failures=JC.FailureModel(0.7))
    rng, masks = jax.random.PRNGKey(0), []
    for r in range(ROUNDS):
        rng, k_mix = jax.random.split(rng)
        ek, na = fj.round_masks(fj.round_key(k_mix, r))
        masks.append((torch.as_tensor(np.array(ek)), torch.as_tensor(np.array(na))))
    fin_j, h_j = _jax_run(setup, sj, link_p=0.7)
    _inject_draws(monkeypatch, masks)
    fin_t, h_t = _port_run(setup, sp, link_p=0.7)
    assert h_t["round"] == h_j["round"] == [0, 3, 6, 7]
    for k in KEYS:
        np.testing.assert_allclose(h_t[k], h_j[k], **TRAJ, err_msg=k)
    assert h_t["wire_messages"] == [int(m) for m in h_j["wire_messages"]]
    assert h_t["wire_bytes"] == [int(b) for b in h_j["wire_bytes"]]
    params_j = jax.tree_util.tree_map(np.asarray, fin_j.params)
    for layer, leaves in to_numpy(fin_t)[0].items():
        for name, leaf in leaves.items():
            np.testing.assert_allclose(leaf, params_j[layer][name], **TRAJ, err_msg=f"{layer}/{name}")


@pytest.mark.parametrize("backend", ["dense", "ppermute"])
def test_resumed_churned_trajectory_matches_jax(monkeypatch, setup, backend):
    """A churned K = 3 trajectory continued from a state at round 4 (cyclic
    period 1, link_p 0.7, node_p 0.8, every round recorded): each round
    mixes with, and counts the wire messages of, the plan active at the
    state's round, not at the loop index (the churned graphs have equal edge
    counts, so the node draws tell them apart); on the JAX run's injected
    draws the wire counts are equal and the history and params within the
    trajectory tolerance."""
    gj = JT.churn_sequence(JT.random_k_regular(N, 3, seed=0), 3, 0.4, seed=1)
    gp = PT.churn_sequence(PT.random_k_regular(N, 3, seed=0), 3, 0.4, seed=1)
    sj = JC.compile_schedule(gj, backend, round_map=JC.cyclic_map(1))
    sp = PC.compile_schedule(gp, backend, round_map=PC.cyclic_map(1), device="cpu")
    fj, start = sj.with_options(failures=JC.FailureModel(0.7, 0.8)), 4
    rng, masks = jax.random.PRNGKey(0), []
    for r in range(ROUNDS):
        rng, k_mix = jax.random.split(rng)
        ek, na = fj.round_masks(fj.round_key(k_mix, start + r))
        masks.append((torch.as_tensor(np.array(ek)), torch.as_tensor(np.array(na))))
    opt_j, opt_t = JO.sgd(1e-3, 0.5), PO.sgd(1e-3, 0.5)
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    state_j = JF.DFLState(params=params, opt_state=jax.vmap(opt_j.init)(params),
                          round=jnp.asarray(start, jnp.int32), rng=jax.random.PRNGKey(0))
    common = dict(n_rounds=ROUNDS, eval_every=1, eval_batch=setup["test"], track_sigmas=True, b_local=BL)
    fin_j, h_j = JF.run_trajectory(state_j, JF.make_round_fn(jax_loss, opt_j, sj, link_p=0.7, node_p=0.8),
                                   setup["xs"], setup["ys"], setup["sched"], eval_fn=JF.make_eval_fn(jax_loss),
                                   **common)
    _inject_draws(monkeypatch, masks)
    state_t = dataclasses.replace(state_from_numpy(setup["params"], optimizer=opt_t, device="cpu"), round=start)
    fin_t, h_t = PF.run_trajectory(state_t, PF.make_round_fn(torch_loss, opt_t, sp, link_p=0.7, node_p=0.8),
                                   setup["xs"], setup["ys"], setup["sched"], eval_fn=PF.make_eval_fn(torch_loss),
                                   device="cpu", **common)
    assert fin_t.round == int(fin_j.round) == start + ROUNDS
    assert h_t["wire_messages"] == [int(m) for m in h_j["wire_messages"]]
    for k in KEYS:
        np.testing.assert_allclose(h_t[k], h_j[k], **TRAJ, err_msg=k)
    params_j = jax.tree_util.tree_map(np.asarray, fin_j.params)
    for layer, leaves in to_numpy(fin_t)[0].items():
        for name, leaf in leaves.items():
            np.testing.assert_allclose(leaf, params_j[layer][name], **TRAJ, err_msg=f"{layer}/{name}")


def test_churned_warmup_trajectory_matches_jax(monkeypatch, setup):
    """JAX's warmup over a churned schedule (its gossip on its draws at
    link_p 0.8, its init at those gains); the port's warmup over the same
    schedule from that init and those gains."""
    gj = JT.churn_sequence(JT.random_k_regular(N, 3, seed=0), 3, 0.4, seed=1)
    gp = PT.churn_sequence(PT.random_k_regular(N, 3, seed=0), 3, 0.4, seed=1)
    sj = JC.compile_schedule(gj, "sparse", round_map=JC.cyclic_map(2))
    sp = PC.compile_schedule(gp, "sparse", round_map=PC.cyclic_map(2), device="cpu")
    opt_j, opt_t = JO.sgd(1e-3, 0.5), PO.sgd(1e-3, 0.5)
    icfg = JInitConfig("he_normal", 1.0)

    def init_one_j(k, gn):
        return JPM.init_mlp(icfg.replace(gain=gn), k, hidden=HIDDEN)

    est_j = JG.make_gain_estimator(sj.with_options(failures=JC.FailureModel(0.8)), pi_rounds=6, ps_rounds=8)
    key = jax.random.PRNGKey(5)
    common = dict(n_rounds=ROUNDS, eval_every=1, eval_batch=setup["test"], track_sigmas=True, b_local=BL)
    fin_j, hist_j, gains_j = JF.run_warmup_trajectory(
        key, JF.make_round_fn(jax_loss, opt_j, sj), setup["xs"], setup["ys"], setup["sched"], n_nodes=N,
        init_one=init_one_j, optimizer=opt_j, estimate_gains=est_j, eval_fn=JF.make_eval_fn(jax_loss), **common)
    _, k_init = jax.random.split(key)
    init_j = jax.jit(lambda k, g: JF.init_fl_state(k, N, init_one_j, opt_j, gains=g))(k_init, gains_j)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    monkeypatch.setattr(PX, "init_fl_state", lambda *a, **k: state_from_numpy(
        to_np(init_j.params), to_np(init_j.opt_state), device="cpu"))
    fin, hist, gains = PF.run_warmup_trajectory(
        0, PF.make_round_fn(torch_loss, opt_t, sp), setup["xs"], setup["ys"], setup["sched"], n_nodes=N,
        init_one=None, optimizer=opt_t, estimate_gains=lambda seed: torch.as_tensor(np.array(gains_j)),
        eval_fn=PF.make_eval_fn(torch_loss), device="cpu", **common)
    assert hist["round"] == hist_j["round"] == list(range(ROUNDS)) and np.array_equal(gains, np.asarray(gains_j))
    for k in KEYS:
        np.testing.assert_allclose(hist[k], hist_j[k], **TRAJ, err_msg=k)


def test_trajectory_config_chunks_match_jax():
    for n_rounds, size in ((8, 3), (8, 0), (2000, 0), (5, 5), (7, 1)):
        assert PX.TrajectoryConfig(n_rounds, chunk_size=size).chunks() == \
            JF.executor.TrajectoryConfig(n_rounds, chunk_size=size).chunks()


def test_chunked_run_is_bitwise_the_unchunked_one(setup):
    """Chunks of 3 over 8 rounds on a failing churned schedule: the hook
    fires ⌈8 / 3⌉ times with each chunk's recorded rounds (absolute round
    numbers, the wire channels included); params and history bitwise."""
    sched = PC.compile_schedule(PT.churn_sequence(PT.random_k_regular(N, 3, seed=0), 3, 0.4, seed=1), "dense",
                                failures=PC.FailureModel(0.7), round_map=PC.cyclic_map(2), device="cpu")
    calls = []
    fin_c, h_c = _port_run(setup, sched, chunk_size=3, on_chunk=lambda r0, r1, h: calls.append((r0, r1, h)))
    fin, h = _port_run(setup, sched)
    assert torch.equal(fin_c.params, fin.params) and h_c == h
    assert [(r0, r1) for r0, r1, _ in calls] == [(0, 3), (3, 6), (6, 8)]
    assert [c[2]["round"] for c in calls] == [[0], [3], [6, 7]]
    for key in h:
        assert sum((c[2][key] for c in calls), []) == h[key], key
    assert "wire_messages" in calls[0][2] and "wire_bytes" in calls[0][2]


def test_make_round_fn_overrides_only_the_given_knobs():
    """On a compiled plan or schedule: link_p / node_p recompile the failure
    model, data sizes alone keep it (as the JAX package's make_round_fn);
    another device raises."""
    opt = PO.sgd(1e-3, 0.5)
    g = PT.random_k_regular(8, 3, seed=0)
    plan = PC.compile_plan(g, "sparse", failures=PC.FailureModel(0.7), device="cpu")
    sizes = np.linspace(1, 2, 8)
    rf = PF.make_round_fn(torch_loss, opt, plan, data_sizes=sizes)
    jrf = JF.make_round_fn(jax_loss, JO.sgd(1e-3, 0.5), JC.compile_plan(JT.random_k_regular(8, 3, seed=0), "sparse",
                                                                        failures=JC.FailureModel(0.7)),
                           data_sizes=sizes)
    assert rf.plan.failures == PC.FailureModel(0.7) and jrf.plan.failures == JC.FailureModel(0.7)
    np.testing.assert_array_equal(rf.plan.data_sizes, sizes)
    assert PF.make_round_fn(torch_loss, opt, plan, node_p=0.5).plan.failures == PC.FailureModel(1.0, 0.5)
    assert PF.make_round_fn(torch_loss, opt, plan).plan is plan
    sched = PC.compile_schedule(PT.churn_sequence(g, 3, 0.3, seed=1), "dense", device="cpu")
    rs = PF.make_round_fn(torch_loss, opt, sched, link_p=0.5)
    assert isinstance(rs.plan, PC.PlanSchedule) and rs.plan.k == 3 and rs.plan.failures == PC.FailureModel(0.5)
    assert rs.plan.n_edges_env == sched.n_edges_env
    with pytest.raises(ValueError, match="lies on"):
        PF.make_round_fn(torch_loss, opt, plan, device="meta")


# ------------------------------------------------------ drivers and the CLI
def _norm(kwargs):
    """A driver call's arguments, comparable across the two packages: a
    graph by its adjacency, a schedule by its backend, round map and graphs."""
    out = {}
    for k, v in kwargs.items():
        if k == "device":
            continue
        if isinstance(v, (JT.Graph, PT.Graph)):
            v = (v.name, v.adjacency.tobytes())
        elif isinstance(v, (JC.PlanSchedule, PC.PlanSchedule)):
            v = (v.backend, v.round_map.kind, v.round_map.period, v.failures.link_p,
                 tuple(p.graph.adjacency.tobytes() for p in v.plans))
        out[k] = v
    return out


def _level(kwargs):
    return 1.0 + zlib.crc32(repr(sorted(_norm(kwargs).items())).encode()) % 1000 / 1000


def test_fig8_call_for_call(monkeypatch, tmp_path):
    calls = {"jax": [], "torch": []}

    def make(side, name):
        def rec(**kw):
            calls[side].append((name, _norm(kw)))
            hist = {"round": [0], "test_loss": [_level(kw)]}
            if name == "run_dfl_mlp":
                lvl = _level(kw)
                return hist, {"sec_per_round": lvl, "compile_seconds": lvl / 2, "us_per_round_steady": lvl * 100}
            return hist, _level(kw) / 10, np.linspace(1.0, _level(kw), kw["n_nodes"])

        return rec

    for side, mod in (("jax", jfig8), ("torch", pfig8)):
        for name in ("run_dfl_mlp", "run_dfl_mlp_uncoordinated"):
            monkeypatch.setattr(mod, name, make(side, name))
    monkeypatch.setattr(jfig8, "OUT", tmp_path / "jax.json")
    pcommon.ROWS.clear()
    jfig8.emit.__globals__["ROWS"].clear()
    jfig8.run(quick=True)
    got = pfig8.run(quick=True, device="cpu", out_path=tmp_path / "torch.json")
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) == 10
    assert pcommon.ROWS == jfig8.emit.__globals__["ROWS"] and len(pcommon.ROWS) == 5
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got["records"] == want["records"] == json.loads((tmp_path / "torch.json").read_text())["records"]


def test_rounds_bench_call_for_call(monkeypatch, tmp_path):
    calls = {"jax": [], "torch": []}

    def make(side, name):
        def rec(**kw):
            calls[side].append((name, _norm(kw)))
            if name == "run_dfl_mlp_sweep":
                return [[{"round": [0], "test_loss": [_level({**kw, "g": g})]}] for g in kw["gains"]], _level(kw)
            return {"round": [0], "test_loss": [_level(kw)]}, _level(kw) / 1000

        return rec

    for side, mod in (("jax", jrounds), ("torch", prounds)):
        for name in ("run_dfl_mlp", "run_dfl_mlp_sweep"):
            monkeypatch.setattr(mod, name, make(side, name))
    monkeypatch.setattr(jrounds, "OUT", tmp_path / "jax.json")
    pcommon.ROWS.clear()
    jrounds.emit.__globals__["ROWS"].clear()
    jrounds.run(quick=True)
    got = prounds.run(quick=True, device="cpu", out_path=tmp_path / "torch.json")
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) == 25
    assert pcommon.ROWS == jrounds.emit.__globals__["ROWS"] and len(pcommon.ROWS) == 4
    assert got["records"] == json.loads((tmp_path / "jax.json").read_text())["records"]


def test_cli_schedule_flags_on_cpu(capsys):
    """--topology-schedule churn with the leaderless warmup at link_p 0.8,
    and a cyclic schedule streamed by --log-every: the streamed lines are
    the history's."""
    base = ["--model", "mlp", "--device", "cpu", "--nodes", "8", "--topology", "kregular", "--rounds", "3",
            "--items-per-node", "32", "--local-batches", "2"]
    hist = cli.main([*base, "--topology-schedule", "churn", "--plans", "3", "--churn-rate", "0.3",
                     "--uncoordinated-init", "--leaderless", "--estimate-rounds", "6", "--link-p", "0.8"])
    out = capsys.readouterr().out
    assert "schedule: churn K=3 period=1 churn_rate=0.3" in out and "gossip gains" in out
    assert hist["round"] == [0, 1, 2] and np.isfinite(hist["test_loss"]).all()
    hist = cli.main([*base, "--topology-schedule", "cyclic", "--plans", "2", "--plan-period", "2", "--log-every", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("round")]
    assert len(lines) == 3 and all("wire" in ln for ln in lines)
    assert [int(ln.split()[1]) for ln in lines] == hist["round"] == [0, 1, 2]
    with pytest.raises(SystemExit):
        cli.main([*base, "--checkpoint-every", "2"])
    assert "not yet ported" in capsys.readouterr().err
