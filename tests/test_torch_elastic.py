"""Elastic membership, fault plans, durable checkpoints and the elastic
executor of the port against the JAX package's.

- ``core.membership`` and ``core.faults`` are numpy copies: every mask of
  every JAX test case, each ``SCENARIOS`` entry and ``compose`` bitwise,
  the same errors.
- ``checkpoint.io``: the JAX package's checkpoint cases on the port's
  ``torch.save`` files (neither package has a sharded checkpoint).
- ``CommPlan.wire_messages(active=, edge_live=)`` against ``make_wire_fn``
  on injected draws, on every backend and a schedule.
- ``run_elastic_trajectory`` (ring-6, the JAX tests' sizes): the zero-event
  run bitwise the port's ``run_trajectory``; a join flow, a churned
  ``PlanSchedule`` at link_p 0.8 and an int8 run with a crash burst
  against the JAX executor on its injected draws (the sketches and the
  joiners' rows through ``executor.elastic_draws``, the failure masks
  through ``commplan._draw_failure_masks``): the integer channels
  exactly, losses and params at the trajectory tolerance (int8: code flips
  counted, each within one code step); a crash burst freezes its victims
  bitwise; one failure draw a round.
- The CLI's ``--elastic`` / checkpoint flags on the CPU, fig11 and the
  example call for call against the JAX drivers.
"""
import dataclasses
import json
import os
import pathlib
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import fig11_elastic as jfig11  # noqa: E402
from repro import fed as JF  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.checkpoint import io as JIO  # noqa: E402
from repro.core import commplan as JC  # noqa: E402
from repro.core import compress as JCC  # noqa: E402
from repro.core import faults as JFa  # noqa: E402
from repro.core import membership as JM  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.initialisation import InitConfig as JInitConfig  # noqa: E402
from repro.data import batch_index_schedule, mnist_like, node_datasets  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402
from repro.obs.wirecost import make_wire_fn  # noqa: E402
from repro_torch import fed as PF  # noqa: E402
from repro_torch import optim as PO  # noqa: E402
from repro_torch.benchmarks import common as pcommon  # noqa: E402
from repro_torch.benchmarks import fig11_elastic as pfig11  # noqa: E402
from repro_torch.checkpoint import io as PIO  # noqa: E402
from repro_torch.checkpoint import load_pytree, restore_train_state, save_pytree, save_train_state  # noqa: E402
from repro_torch.convert import state_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import faults as PFa  # noqa: E402
from repro_torch.core import membership as PM  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.compress import Compression  # noqa: E402
from repro_torch.core.initialisation import InitConfig as PInitConfig  # noqa: E402
from repro_torch.examples import elastic_membership as pexample  # noqa: E402
from repro_torch.fed import executor as PX  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import paper_models as PPM  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRAJ = dict(rtol=1e-4, atol=1e-5)  # a trajectory (ROADMAP.md Queue 3)
NN, PER, BS, BL, R, M = 6, 32, 8, 2, 12, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU products run fastest on one thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------ membership, faults
MEMBERSHIPS = {
    "lowering": lambda M: M.membership_schedule(8, 40, initial=6, arrivals={10: [6, 7]}, join_warmup=5),
    "rearrival": lambda M: M.membership_schedule(6, 30, departures={5: [2]}, arrivals={12: [2]}, join_warmup=4),
    "late": lambda M: M.membership_schedule(4, 10, initial=3, arrivals={8: [3]}, join_warmup=8),
    "pairs_mask": lambda M: M.membership_schedule(5, 9, initial=np.array([1, 0, 1, 1, 0], bool),
                                                  arrivals=[(3, 1), (2, 4)], departures=[(6, 0), (4, 4)]),
    "poisson": lambda M: M.poisson_membership(16, 80, initial=10, arrival_rate=0.3, departure_rate=0.05,
                                              min_active=3, seed=4),
    "static": lambda M: M.membership_schedule(6, 7),
}


@pytest.mark.parametrize("case", sorted(MEMBERSHIPS))
def test_membership_matches_jax(case):
    a, b = MEMBERSHIPS[case](JM), MEMBERSHIPS[case](PM)
    for f in ("active", "gossip", "joins", "inits"):
        got, want = getattr(b, f), getattr(a, f)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert (b.n, b.n_rounds, b.join_warmup, b.trivial) == (a.n, a.n_rounds, a.join_warmup, a.trivial)
    assert np.array_equal(b.n_active(), a.n_active()) and b.n_active().dtype == a.n_active().dtype


def test_membership_errors_match_jax():
    cases = [
        (lambda M: M.membership_schedule(6, 30, arrivals={3: [1]}), "already a member"),
        (lambda M: M.membership_schedule(0, 3), "need n >= 1"),
        (lambda M: M.membership_schedule(4, 3, arrivals={3: [1]}), "outside"),
        (lambda M: M.membership_schedule(4, 3, initial=2, arrivals={1: [7]}), "envelope"),
        (lambda M: M.membership_schedule(4, 3, initial=np.ones(3, bool)), "shape"),
        (lambda M: M.poisson_membership(4, 3, initial=5), "initial membership"),
        (lambda M: M.MembershipSchedule(n=2, n_rounds=2, active=np.ones((2, 2), bool),
                                        gossip=np.zeros((2, 2), bool), joins=np.zeros((2, 2), bool),
                                        inits=np.zeros((2, 2), bool)), "active nodes must gossip"),
        (lambda M: M.MembershipSchedule(n=2, n_rounds=2, active=np.ones((2, 3), bool),
                                        gossip=np.ones((2, 2), bool), joins=np.zeros((2, 2), bool),
                                        inits=np.zeros((2, 2), bool)), "must be bool"),
    ]
    for build, match in cases:
        msgs = []
        for M in (JM, PM):
            with pytest.raises(ValueError, match=match) as exc:
                build(M)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


def _fault_fields(f):
    return f.name, f.n, f.n_rounds, f.node_up.tobytes(), f.edge_up.tobytes(), f.edge_up.shape, f.preempt_chunks, f.trivial


@pytest.mark.parametrize("name", sorted(JFa.SCENARIOS))
@pytest.mark.parametrize("graph", ["ba32", "ring12", "kreg16"])
def test_fault_scenarios_match_jax(name, graph):
    build = {"ba32": lambda T: T.barabasi_albert(32, 3, seed=0), "ring12": lambda T: T.ring(12),
             "kreg16": lambda T: T.random_k_regular(16, 4, seed=3)}[graph]
    for rounds, seed in ((60, 9), (7, 0)):
        a = JFa.scenario(name, build(JT), rounds, seed=seed)
        b = PFa.scenario(name, build(PT), rounds, seed=seed)
        assert _fault_fields(b) == _fault_fields(a)
    assert sorted(PFa.SCENARIOS) == sorted(JFa.SCENARIOS)


def test_fault_builders_compose_and_errors_match_jax():
    gj, gp = JT.barabasi_albert(32, 3, seed=0), PT.barabasi_albert(32, 3, seed=0)
    builds = [
        lambda F, g: F.crash_burst(g, 40, at=5, size=6, duration=4, targeted=True),
        lambda F, g: F.crash_burst(g, 40, at=39, size=3, duration=9, seed=2),
        lambda F, g: F.hub_outage(g, 40, at=10, duration=5, k=2),
        lambda F, g: F.partition(g, 40, at=20, duration=4, seed=1),
        lambda F, g: F.preemption(g, 40, [3, 1]),
        lambda F, g: F.no_faults(g, 40),
        lambda F, g: F.compose(F.hub_outage(g, 40, at=10, duration=5, k=2), F.partition(g, 40, at=12, duration=9),
                               F.preemption(g, 40, (2,)), F.preemption(g, 40, (2, 0))),
    ]
    for build in builds:
        assert _fault_fields(build(PFa, gp)) == _fault_fields(build(JFa, gj))
    errors = [
        (lambda F, g: F.crash_burst(g, 40, at=40, size=2, duration=1), "onset"),
        (lambda F, g: F.crash_burst(g, 40, at=1, size=0, duration=1), "burst size"),
        (lambda F, g: F.partition(g, 40, at=1, duration=0), "duration"),
        (lambda F, g: F.compose(), "at least one"),
        (lambda F, g: F.compose(F.no_faults(g, 40), F.no_faults(g, 41)), "envelope"),
        (lambda F, g: F.scenario("flood", g, 40), "unknown fault scenario"),
        (lambda F, g: F.FaultPlan("x", 32, 4, np.ones((4, 31), bool), np.ones((4, 2), bool)), "node_up"),
    ]
    for build, match in errors:
        msgs = []
        for F, g in ((JFa, gj), (PFa, gp)):
            with pytest.raises(ValueError, match=match) as exc:
                build(F, g)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


# ----------------------------------------------------------- checkpoint io
def test_roundtrip_dtypes_and_structure(tmp_path):
    tree = {
        "bf16": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
        "f32": torch.ones(4) * 1.5,
        "i32": torch.tensor([1, 2, 3], dtype=torch.int32),
        "nested": [{"x": np.float64(2.5)}, (torch.zeros(2),)],
        "u8": np.arange(5, dtype=np.uint8),
        "view": torch.arange(10.0)[2:5],
    }
    p = str(tmp_path / "t.ckpt")
    save_pytree(p, tree, meta={"step": 7})
    back, meta = load_pytree(p)
    assert meta["step"] == 7
    assert back["bf16"].dtype == torch.bfloat16 and torch.equal(back["bf16"], tree["bf16"])
    assert torch.equal(back["f32"], tree["f32"]) and back["i32"].dtype == torch.int32
    assert isinstance(back["nested"][0]["x"], np.ndarray) and back["nested"][0]["x"].shape == ()
    assert back["nested"][0]["x"] == 2.5 and back["nested"][1][0].shape == (2,)
    assert back["u8"].dtype == np.uint8 and np.array_equal(back["u8"], np.arange(5))
    # a view is stored alone, not its whole storage
    assert torch.equal(back["view"], tree["view"]) and back["view"].untyped_storage().nbytes() == 12


def test_template_restores_namedtuples(tmp_path):
    state = PO.adamw().init(torch.ones(3, 3))
    p = str(tmp_path / "opt.ckpt")
    save_pytree(p, state)
    back, _ = load_pytree(p, template=state)
    assert type(back).__name__ == "AdamWState" and int(back.step.sum()) == 0
    plain, _ = load_pytree(p)
    assert sorted(plain) == ["mu", "nu", "step"]
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(p, template={"w": torch.ones(1)})


def test_latest_pointer_and_train_state(tmp_path):
    d = str(tmp_path / "ckpts")
    state = {"params": {"w": torch.ones(3)}, "round": torch.tensor(5)}
    save_train_state(d, 5, state)
    save_train_state(d, 10, {"params": {"w": torch.ones(3) * 2}, "round": torch.tensor(10)})
    got, meta = restore_train_state(d, template=state)
    assert meta["step"] == 10 and torch.equal(got["params"]["w"], torch.full((3,), 2.0))


def test_restore_missing_returns_none(tmp_path):
    assert restore_train_state(str(tmp_path / "nope")) is None


def test_atomic_write_leaves_no_tmp(tmp_path):
    p = str(tmp_path / "a.ckpt")
    save_pytree(p, {"x": torch.zeros(2)})
    assert not os.path.exists(p + ".tmp") and os.listdir(tmp_path) == ["a.ckpt"]


def test_unsorted_dict_keys_roundtrip(tmp_path):
    tree = {"z": torch.ones(2) * 3, "a": torch.ones(3), "m": torch.ones(4) * 2}
    p = str(tmp_path / "d.ckpt")
    save_pytree(p, tree)
    back, _ = load_pytree(p)
    for k, v in tree.items():
        assert torch.equal(back[k], v)
    again, _ = load_pytree(p, template=tree)
    assert list(again) == list(tree)


def test_structure_skeleton_matches_jax():
    """The skeleton records what the JAX package's records, leaves aside."""
    tree = {"z": np.ones(2), "a": [np.zeros(1), (np.ones(3),)], "opt": JO.sgd().init(np.ones(2))}
    want = JIO._structure_of(tree)
    got = PIO._structure_of(tree)

    def strip(s):
        if s["__kind__"] == "leaf":
            return {"__kind__": "leaf"}
        items = s["items"]
        out = {k: v for k, v in s.items() if k != "items"}
        out["items"] = {k: strip(v) for k, v in items.items()} if isinstance(items, dict) else [strip(v) for v in items]
        return out

    assert strip(got) == want


def test_opt_state_roundtrip_with_template(tmp_path):
    opt = PO.adamw(1e-3)
    params = torch.ones(4, 3)
    state = opt.init(params)
    _, state = opt.update(torch.ones_like(params), state, params)
    d = str(tmp_path / "ck")
    save_train_state(d, 1, {"opt": state, "params": params})
    back, meta = restore_train_state(d, template={"opt": state, "params": params})
    assert meta["step"] == 1 and type(back["opt"]) is type(state)
    for a, b in zip((*back["opt"], back["params"]), (*state, params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_keep_last_gc_and_latest_durability(tmp_path):
    d = str(tmp_path / "gc")
    for s in range(6):
        save_train_state(d, s, {"w": torch.full((2,), float(s))}, keep_last=3)
    kept = sorted(f for f in os.listdir(d) if f.endswith(".ckpt"))
    assert kept == ["step_00000003.ckpt", "step_00000004.ckpt", "step_00000005.ckpt"]
    latest = json.loads((pathlib.Path(d) / "LATEST").read_text())
    assert latest["step"] == 5 and os.path.exists(os.path.join(d, os.path.basename(latest["path"])))
    got, meta = restore_train_state(d)
    assert meta["step"] == 5 and torch.equal(got["w"], torch.full((2,), 5.0))
    # a step number below the newest files': LATEST's file is never collected
    save_train_state(d, 1, {"w": torch.zeros(2)}, keep_last=1)
    assert "step_00000001.ckpt" in os.listdir(d) and restore_train_state(d)[1]["step"] == 1


# -------------------------------------------------------- masked wire count
def _inject_draws(monkeypatch, masks):
    """The port's failure draws become ``masks[i]``, i the order in which the
    generator states are first seen; every draw advances the stream."""
    seen = {}

    def fake(failures, width, n, generator):
        i = seen.setdefault(bytes(generator.get_state().numpy()), len(seen))
        torch.rand(1, generator=generator)
        ek, na = masks[i]
        assert ek.shape[0] == width
        return ek.clone(), na.clone()

    monkeypatch.setattr(PC, "_draw_failure_masks", fake)


@pytest.mark.parametrize("backend", PC.BACKENDS)
def test_masked_wire_counts_match_jax(monkeypatch, backend):
    g = lambda T: T.barabasi_albert(12, 3, seed=1)  # noqa: E731
    rng = np.random.default_rng(0)
    act = rng.random(12) < 0.7
    el = rng.random(g(JT).n_edges) < 0.6
    for fm in (None, (0.6, 0.9)):
        pj = JC.compile_plan(g(JT), backend, failures=None if fm is None else JC.FailureModel(*fm))
        pp = PC.compile_plan(g(PT), backend, failures=None if fm is None else PC.FailureModel(*fm), device="cpu")
        wire = make_wire_fn(pj)
        keys = [jax.random.PRNGKey(i) for i in range(4)] if fm else [None] * 4
        masks = [tuple(torch.as_tensor(np.array(m)) for m in pj.round_masks(k)) for k in keys] if fm else []
        _inject_draws(monkeypatch, masks)
        gen = torch.Generator().manual_seed(0)
        for i, (a, e) in enumerate(((None, None), (act, None), (None, el), (act, el))):
            want = int(wire(keys[i], 0, active=None if a is None else jnp.asarray(a),
                            edge_live=None if e is None else jnp.asarray(e)))
            got = pp.wire_messages(PF.trainer._copy_generator(gen) if fm else None, active=a, edge_live=e)
            if fm:
                torch.rand(1, generator=gen)
            assert int(got) == want, (fm, i)
        if fm is None:  # a mask that keeps everything still counts every edge
            assert int(pp.wire_messages(active=np.ones(12, bool))) == 2 * pp.n_edges == pp.wire_messages()


def test_schedule_masked_wire_counts_match_jax():
    graphs = lambda T: T.churn_sequence(T.random_k_regular(12, 4, seed=0), 3, 0.4, seed=1)  # noqa: E731
    sj = JC.compile_schedule(graphs(JT), "dense", round_map=JC.cyclic_map(1))
    sp = PC.compile_schedule(graphs(PT), "dense", round_map=PC.cyclic_map(1), device="cpu")
    wire = make_wire_fn(sj)
    rng = np.random.default_rng(2)
    for r in range(3):
        act = rng.random(12) < 0.8
        el = rng.random(sp.n_edges_env) < 0.7
        assert int(sp.wire_messages(r, active=act, edge_live=el)) == int(wire(None, r, active=jnp.asarray(act),
                                                                              edge_live=jnp.asarray(el)))


# ------------------------------------------------------- elastic executor
@pytest.fixture(scope="module")
def setup():
    ds = mnist_like(NN * PER + 64, seed=0)
    xs, ys = node_datasets(ds, [np.arange(i * PER, (i + 1) * PER) for i in range(NN)])
    rng = np.random.default_rng(NN)
    dims = (784, 16, 10)
    params = {f"fc{i}": {"w": (rng.standard_normal((NN, a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
                         "b": np.zeros((NN, b), np.float32)} for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    return dict(xs=xs, ys=ys, params=params, test=(ds.x[-64:], ds.y[-64:]),
                sched=batch_index_schedule(PER, NN, BS, R * BL, seed=0))


def torch_loss(p, b):
    return PPM.classifier_loss(PPM.mlp_forward(p, b[0]), b[1])


def jax_loss(p, b):
    return JPM.classifier_loss(JPM.mlp_forward(p, b[0]), b[1])


def torch_init(g, gains):
    return PPM.init_mlp(PInitConfig("he_normal", gains), g, hidden=(16,))


def jax_init(k, gn):
    return JPM.init_mlp(JInitConfig("he_normal", gn), k, hidden=(16,))


def _graph(T, name):
    return T.ring(NN) if name != "schedule" else T.churn_sequence(T.random_k_regular(NN, 3, seed=0), 2, 0.4, seed=1)


CASES = {
    # name: (backend, link_p, codec, membership kwargs, crash (at, size, duration) or None)
    "join": ("dense", 1.0, None, dict(initial=NN - 2, arrivals={2: [NN - 2, NN - 1]}, join_warmup=4), None),
    "schedule": ("dense", 0.8, None, dict(initial=NN - 1, arrivals={1: [NN - 1]}, join_warmup=3), (4, 2, 3)),
    "int8": ("sparse", 1.0, "int8", dict(initial=NN - 1, arrivals={3: [NN - 1]}, join_warmup=2), (5, 1, 4)),
}


def _plans(name, backend, link_p):
    if name == "schedule":
        fj = JC.FailureModel(link_p=link_p)
        return (JC.compile_schedule(_graph(JT, name), backend, failures=fj, round_map=JC.cyclic_map(2)),
                PC.compile_schedule(_graph(PT, name), backend, failures=PC.FailureModel(link_p=link_p),
                                    round_map=PC.cyclic_map(2), device="cpu"))
    return (JC.compile_plan(_graph(JT, name), backend, failures=JC.FailureModel(link_p=link_p)),
            PC.compile_plan(_graph(PT, name), backend, failures=PC.FailureModel(link_p=link_p), device="cpu"))


def _faults(F, T, name):
    crash = CASES[name][4]
    if crash is None:
        return None
    at, size, duration = crash
    g = _graph(T, name)
    return F.crash_burst(g if not isinstance(g, list) else g[0], R, at=at, size=size, duration=duration, seed=0)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Each case's JAX elastic run and the draws it took: the failure masks
    of every round, the sketches and the joiners' rows (``fold_in`` of its
    forked keys)."""
    out = {}
    opt = JO.sgd(1e-3, 0.5)
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    for name, (backend, link_p, codec, mem_kw, _) in CASES.items():
        key = jax.random.PRNGKey(3)
        state = JF.DFLState(params=params, opt_state=jax.vmap(opt.init)(params), round=jnp.zeros((), jnp.int32),
                            rng=key)
        plan_j, _ = _plans(name, backend, link_p)
        mem = JM.membership_schedule(NN, R, **mem_kw)
        comp = None if codec is None else JCC.Compression(codec, chunk=256)
        fin, hist, aux = JF.run_elastic_trajectory(
            state, jax_loss, opt, plan_j, mem, setup["xs"], setup["ys"], setup["sched"], n_rounds=R, eval_every=3,
            eval_fn=JF.make_eval_fn(jax_loss), eval_batch=setup["test"], b_local=BL, chunk_size=6, init_one=jax_init,
            n_sketches=M, faults=_faults(JFa, JT, name), compression=comp,
        )
        masks, rng = [], key
        if link_p < 1.0:
            for r in range(R):
                rng, k_mix = jax.random.split(rng)
                k = plan_j.round_key(k_mix, r) if isinstance(plan_j, JC.PlanSchedule) else k_mix
                masks.append(tuple(torch.as_tensor(np.array(m)) for m in plan_j.round_masks(k)))
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        out[name] = dict(params=to_np(fin.params), residual=None if comp is None else to_np(fin.residual),
                         hist=hist, n_hat=aux["n_hat"], masks=masks, key=key)
    return out


def _inject_elastic(monkeypatch, key):
    """``elastic_draws`` returns the JAX executor's: its sketches
    ``exponential(fold_in(k_fresh, r))`` and its joiner tree
    ``vmap(init_one)(fold_in(fold_in(k_init, r), i), gains)`` at the port's gains."""
    k_fresh, k_init = jax.random.split(jax.random.fold_in(key, 0x5EED))
    calls = []

    def fake(kind, seed, r, *, n, device, n_sketches=0, init_one=None, gains=None):
        calls.append((kind, r))
        if kind == "sketches":
            return torch.tensor(np.asarray(jax.random.exponential(jax.random.fold_in(k_fresh, r), (n, n_sketches))))
        kr = jax.random.fold_in(k_init, r)
        keys = jax.vmap(lambda i: jax.random.fold_in(kr, i))(jnp.arange(n))
        tree = jax.vmap(jax_init)(keys, jnp.asarray(gains.cpu().numpy()))
        return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)

    monkeypatch.setattr(PX, "elastic_draws", fake)
    return calls


def _port_run(setup, name, **kw):
    backend, link_p, codec, mem_kw, _ = CASES[name]
    opt = PO.sgd(1e-3, 0.5)
    state = state_from_numpy(setup["params"], optimizer=opt, device="cpu")
    _, plan = _plans(name, backend, link_p)
    comp = None if codec is None else Compression(codec, chunk=256)
    return PF.run_elastic_trajectory(
        state, torch_loss, opt, plan, PM.membership_schedule(NN, R, **mem_kw), setup["xs"], setup["ys"],
        setup["sched"], n_rounds=R, eval_every=3, eval_fn=PF.make_eval_fn(torch_loss), eval_batch=setup["test"],
        b_local=BL, chunk_size=6, init_one=torch_init, n_sketches=M, faults=_faults(PFa, PT, name),
        compression=comp, device="cpu", **kw,
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_elastic_matches_jax(monkeypatch, setup, jax_runs, name):
    ref = jax_runs[name]
    calls = _inject_elastic(monkeypatch, ref["key"])
    if ref["masks"]:
        _inject_draws(monkeypatch, ref["masks"])
    fin, hist, aux = _port_run(setup, name)
    h_j = ref["hist"]
    assert list(hist) == list(h_j)
    for k in ("round", "n_active", "wire_messages", "wire_bytes"):
        assert hist[k] == h_j[k], k
    assert hist["sigma_ap"] == hist["sigma_an"] == []
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(hist[k], h_j[k], **TRAJ, err_msg=k)
    np.testing.assert_allclose(aux["n_hat"], ref["n_hat"], rtol=1e-6)
    assert fin.round == R
    mem = PM.membership_schedule(NN, R, **CASES[name][3])
    assert calls == [("sketches", R)] + [(kind, r) for r in range(R) for kind, flags in
                                         (("init", mem.inits), ("sketches", mem.joins)) if flags[r].any()]
    params_t, _, resid_t = to_numpy(fin, residual=True)
    flips, total = 0, 0
    for layer, leaves in params_t.items():
        for leaf, got in leaves.items():
            want = ref["params"][layer][leaf]
            if ref["residual"] is None:
                np.testing.assert_allclose(got, want, **TRAJ, err_msg=f"{layer}/{leaf}")
                continue
            # int8: a code near a half-integer may flip on an ulp upstream;
            # each element beyond the tolerance within one code step
            for g_, w_, h_ in ((got, want, ref["residual"][layer][leaf]),
                               (resid_t[layer][leaf], ref["residual"][layer][leaf], ref["residual"][layer][leaf])):
                step = 1.01 * np.abs(h_).max() / 127 + 1e-6
                off = np.abs(g_ - w_) > TRAJ["atol"] + TRAJ["rtol"] * np.abs(w_)
                assert np.all(np.abs(g_ - w_)[off] <= step), (layer, leaf)
                flips += int(off.sum())
                total += g_.size
    assert flips <= 2e-2 * max(total, 1), flips


def test_elastic_zero_event_is_the_static_executor(setup):
    """No membership dynamics and no faults (or a trivial fault plan): the
    port's ``make_round_fn`` + ``run_trajectory``, bit for bit, at link_p
    0.7; ``n_active`` the whole envelope, n̂ the true n."""
    opt = PO.sgd(1e-3, 0.5)
    plan = PC.compile_plan(PT.ring(NN), failures=PC.FailureModel(link_p=0.7), device="cpu")
    common = dict(n_rounds=R, eval_every=4, eval_fn=PF.make_eval_fn(torch_loss), eval_batch=setup["test"],
                  chunk_size=5, device="cpu")
    state = state_from_numpy(setup["params"], optimizer=opt, device="cpu")
    ref, h_ref = PF.run_trajectory(state, PF.make_round_fn(torch_loss, opt, plan), setup["xs"], setup["ys"],
                                   setup["sched"], **common)
    for faults in (None, PFa.no_faults(PT.ring(NN), R)):
        fin, hist, aux = PF.run_elastic_trajectory(state, torch_loss, opt, plan, PM.membership_schedule(NN, R),
                                                   setup["xs"], setup["ys"], setup["sched"], faults=faults, **common)
        assert torch.equal(fin.params, ref.params) and torch.equal(fin.generator.get_state(), ref.generator.get_state())
        assert all(torch.equal(a, b) for a, b in zip(fin.opt_state, ref.opt_state))
        assert {k: v for k, v in hist.items() if k != "n_active"} == h_ref and hist["n_active"] == [NN] * 4
        assert np.array_equal(aux["n_hat"], np.full(NN, float(NN)))
    # reinit_opt=False keeps the momentum across the aggregation, as make_round_fn(reinit_opt=False)
    fin, _, _ = PF.run_elastic_trajectory(state, torch_loss, opt, plan, PM.membership_schedule(NN, R), setup["xs"],
                                          setup["ys"], setup["sched"], reinit_opt=False, **common)
    ref2, _ = PF.run_trajectory(state, PF.make_round_fn(torch_loss, opt, plan, reinit_opt=False), setup["xs"],
                                setup["ys"], setup["sched"], **common)
    assert torch.equal(fin.opt_state.momentum, ref2.opt_state.momentum) and fin.opt_state.momentum.abs().sum() > 0


def test_elastic_takes_one_failure_draw_a_round(setup):
    """A join flag with no other dynamics forces the masked path: at link_p
    0.7 the generator ends where ``run_trajectory``'s does (one draw a
    round; the sketches and inits are forked off a copy), and the caller's
    state is left alone."""
    opt = PO.sgd(1e-3, 0.5)
    plan = PC.compile_plan(PT.ring(NN), failures=PC.FailureModel(link_p=0.7), device="cpu")
    state = state_from_numpy(setup["params"], optimizer=opt, device="cpu")
    before = state.generator.get_state().clone()
    ref, _ = PF.run_trajectory(state, PF.make_round_fn(torch_loss, opt, plan), setup["xs"], setup["ys"],
                               setup["sched"], n_rounds=R, device="cpu")
    ones, joins = np.ones((R, NN), bool), np.zeros((R, NN), bool)
    joins[0, 0] = True
    mem = PM.MembershipSchedule(n=NN, n_rounds=R, active=ones, gossip=ones, joins=joins, inits=np.zeros((R, NN), bool))
    fin, hist, aux = PF.run_elastic_trajectory(state, torch_loss, opt, plan, mem, setup["xs"], setup["ys"],
                                               setup["sched"], n_rounds=R, eval_every=1, device="cpu")
    assert torch.equal(fin.generator.get_state(), ref.generator.get_state())
    assert torch.equal(state.generator.get_state(), before)
    # the same operator a round as the static executor's: params within fp32 rounding
    torch.testing.assert_close(fin.params, ref.params, rtol=1e-5, atol=1e-6)
    assert hist["n_active"] == [NN] * R and len(hist["wire_messages"]) == R
    assert max(hist["wire_messages"]) <= 2 * NN and min(hist["wire_messages"]) < 2 * NN
    assert np.isfinite(aux["n_hat"]).all()


def test_elastic_crash_burst_freezes_victims(setup):
    """A crash burst freezes its victims' rows (params and momentum) from
    its first round, bit for bit: their rows equal a one-round run's."""
    opt = PO.sgd(1e-3, 0.5)
    g = PT.ring(NN)
    plan = PC.compile_plan(g, device="cpu")
    faults = PFa.crash_burst(g, R, at=1, size=2, duration=R, seed=0)
    victims = np.nonzero(~faults.node_up[1])[0]
    state = state_from_numpy(setup["params"], optimizer=opt, device="cpu")
    fin, hist, _ = PF.run_elastic_trajectory(state, torch_loss, opt, plan, PM.membership_schedule(NN, R),
                                             setup["xs"], setup["ys"], setup["sched"], n_rounds=R, eval_every=1,
                                             faults=faults, device="cpu")
    assert hist["n_active"][0] == NN and set(hist["n_active"][1:]) == {NN - 2}
    ones, joins = np.ones((1, NN), bool), np.zeros((1, NN), bool)
    joins[0, 0] = True
    mem1 = PM.MembershipSchedule(n=NN, n_rounds=1, active=ones, gossip=ones, joins=joins,
                                 inits=np.zeros((1, NN), bool))
    one, _, _ = PF.run_elastic_trajectory(state, torch_loss, opt, plan, mem1, setup["xs"], setup["ys"],
                                          setup["sched"][:BL], n_rounds=1, eval_every=1, b_local=BL, device="cpu")
    v = torch.as_tensor(victims)
    assert torch.equal(fin.params[v], one.params[v]) and torch.equal(fin.opt_state.momentum[v],
                                                                       one.opt_state.momentum[v])
    live = torch.as_tensor(np.setdiff1d(np.arange(NN), victims))
    assert not torch.equal(fin.params[live], one.params[live])


def test_elastic_errors(setup):
    opt = PO.sgd(1e-3, 0.5)
    state = state_from_numpy(setup["params"], optimizer=opt, device="cpu")
    plan = PC.compile_plan(PT.ring(NN), device="cpu")
    join = PM.membership_schedule(NN, R, initial=NN - 1, arrivals={1: [NN - 1]}, join_warmup=2)
    args = (setup["xs"], setup["ys"], setup["sched"])
    cases = [
        (dict(membership=join), "init_one"),
        (dict(membership=PM.membership_schedule(NN, R + 1)), "membership is"),
        (dict(membership=join, init_one=torch_init, faults=PFa.no_faults(PT.ring(NN), R + 1)), "fault plan is"),
        (dict(membership=join, init_one=torch_init, plan=PC.compile_plan(PT.ring(NN + 1), device="cpu")),
         "plan has"),
        (dict(membership=join, init_one=torch_init, state=dataclasses.replace(state, generator=None)), "generator"),
    ]
    for kw, match in cases:
        kw = {"state": state, "plan": plan, **kw}
        with pytest.raises(ValueError, match=match):
            PF.run_elastic_trajectory(kw.pop("state"), torch_loss, opt, kw.pop("plan"), kw.pop("membership"), *args,
                                      n_rounds=R, device="cpu", **kw)


# ---------------------------------------------------------------- the CLI
BASE = ["--model", "mlp", "--device", "cpu", "--nodes", "8", "--topology", "kregular", "--rounds", "6",
        "--items-per-node", "32", "--local-batches", "2"]


def test_cli_elastic_on_cpu(capsys):
    hist = cli.main([*BASE, "--join-nodes", "2", "--join-round", "1", "--join-warmup", "2", "--log-every", "3"])
    out = capsys.readouterr().out
    assert "membership: 6 initial, 2 arrive at round 1 (warmup 2)" in out and "online n̂ (true n = 8)" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("round")]
    assert [int(ln.split("active")[1].split()[0]) for ln in lines] == hist["n_active"] == [6, 6, 6, 8, 8, 8]
    assert np.isfinite(hist["test_loss"]).all() and "wire" in lines[0]
    hist = cli.main([*BASE, "--fault-scenario", "crash+partition", "--compress", "int8"])
    out = capsys.readouterr().out
    assert "fault plan: crash@1x1+partition@3 (1 node-round outages, " in out
    assert hist["n_active"] == [8, 7, 8, 8, 8, 8] and np.isfinite(hist["train_loss"]).all()


def test_cli_checkpoint_and_resume_on_cpu(capsys, tmp_path):
    """--checkpoint-every 1 then --resume: the same history, for the
    synchronous and the elastic path; --ckpt-dir alone saves the params."""
    for extra in ([], ["--elastic", "--fault-scenario", "hub"]):
        d = str(tmp_path / f"ck{len(extra)}")
        run = [*BASE[:-5], "4", *BASE[-4:], "--chunk-rounds", "2", *extra]
        want = cli.main(run)
        got = cli.main([*run, "--ckpt-dir", d, "--checkpoint-every", "1"])
        assert sorted(os.listdir(d)) == ["LATEST", "step_00000000.ckpt", "step_00000001.ckpt"]
        (pathlib.Path(d) / "LATEST").write_text(json.dumps({"step": 0, "path": f"{d}/step_00000000.ckpt"}))
        again = cli.main([*run, "--resume", d])
        assert got == want == again
    capsys.readouterr()
    d = str(tmp_path / "params")
    cli.main([*BASE, "--ckpt-dir", d])
    assert "checkpoint: " in capsys.readouterr().out
    tree, meta = restore_train_state(d)
    assert meta == {"step": 6, "graph": "kreg-8-4"} and tree["fc0"]["w"].shape == (8, 784, 512)


def test_cli_elastic_errors(capsys):
    cases = [
        (["--elastic", "--async"], "excludes --async"),
        (["--join-nodes", "1", "--uncoordinated-init"], "drop --uncoordinated-init"),
        (["--join-nodes", "8"], "at least one initial member"),
        (["--fault-scenario", "partition", "--topology-schedule", "churn"], "--topology-schedule static"),
        (["--resume", "x", "--uncoordinated-init"], "not supported through the warmup phase"),
        (["--elastic", "--legacy-loop"], "excludes --async, --arch and --legacy-loop"),
    ]
    for extra, match in cases:
        with pytest.raises(SystemExit):
            cli.main([*BASE, *extra])
        assert match in capsys.readouterr().err, extra


# ---------------------------------------------------- fig11 and the example
def _norm(args, kwargs):
    """A run call's arguments as comparable values."""
    out = {}
    for k, v in kwargs.items():
        if k == "device":
            continue
        if callable(v):
            out[k] = "fn"
        elif k in ("checkpoint",):
            out[k] = None if v is None else v.every
        elif k == "resume_from":
            out[k] = None if v is None else os.path.basename(v)
        elif k == "faults":
            out[k] = None if v is None else (v.name, v.node_up.tobytes(), v.edge_up.tobytes())
        elif k == "eval_batch":
            out[k] = tuple((np.asarray(a).shape, np.asarray(a).tobytes()[:4096]) for a in v)
        else:
            out[k] = v
    plan = next(getattr(a, "plan", a) for a in args if hasattr(getattr(a, "plan", a), "failures"))
    mem = next((a for a in args if hasattr(a, "joins")), None)
    arrays = [np.asarray(a) for a in args if isinstance(a, np.ndarray)]
    out["plan"] = (plan.n, plan.graph.adjacency.tobytes())
    out["membership"] = None if mem is None else tuple(getattr(mem, f).tobytes() for f in ("active", "joins", "inits"))
    out["arrays"] = [(a.shape, a.dtype.str, a.tobytes()[:4096]) for a in arrays]
    return out


def _recorders(calls, side, mod, state_of):
    def run_elastic(*args, **kw):
        calls[side].append(("elastic", _norm(args, kw)))
        n = _norm(args, kw)["plan"][0]
        lvl = 1.0 + len(calls[side]) / 100
        hist = {"round": [0, 5], "train_loss": [lvl, lvl / 3], "test_loss": [lvl, lvl / 2], "n_active": [n - 1, n]}
        return args[0], hist, {"n_hat": np.full(n, float(n))}

    def run_traj(*args, **kw):
        calls[side].append(("trajectory", _norm(args, kw)))
        return args[0], {"round": [0], "test_loss": [1.0]}

    def init(seed, n, *a, **kw):
        calls[side].append(("init", (n, kw.get("gains") is not None)))
        return state_of(n)

    return run_elastic, run_traj, init


def test_fig11_call_for_call_and_record_keys(monkeypatch, tmp_path):
    """Both fig11 modules with their runners and inits replaced by
    recorders: the same calls (memberships, fault masks, sizes, checkpoint
    policies, the resume path), the same rows and records but the
    timings, the records carrying ``BENCH_elastic.json``'s keys."""
    calls = {"jax": [], "torch": []}

    def state_j(n):
        p = {"w": jnp.zeros((n, 3))}
        return JF.DFLState(params=p, opt_state=jax.vmap(JO.sgd().init)(p), round=jnp.zeros((), jnp.int32),
                           rng=jax.random.PRNGKey(0))

    def state_t(n):
        return state_from_numpy({"w": np.zeros((n, 3), np.float32)}, optimizer=PO.sgd(), device="cpu")

    for side, mod, st in (("jax", jfig11, state_j), ("torch", pfig11, state_t)):
        el, tr, init = _recorders(calls, side, mod, st)
        monkeypatch.setattr(mod, "run_elastic_trajectory", el)
        monkeypatch.setattr(mod, "run_trajectory", tr)
        monkeypatch.setattr(mod, "init_fl_state", init)
    monkeypatch.setattr(jfig11, "OUT", tmp_path / "jax.json")
    pcommon.ROWS.clear()
    jfig11.emit.__globals__["ROWS"].clear()
    jfig11.run(quick=True)
    got = pfig11.run(quick=True, device="cpu", out_path=tmp_path / "torch.json")
    assert [c[0] for c in calls["torch"]] == [c[0] for c in calls["jax"]] and len(calls["torch"]) == 17
    for (kind_t, ct), (_, cj) in zip(calls["torch"], calls["jax"]):
        if kind_t == "init":
            assert ct[0] == cj[0]
            continue
        for k in set(cj) | set(ct):
            if k == "arrays":
                assert [a[:2] for a in ct[k]] == [a[:2] for a in cj[k]] and ct[k][2] == cj[k][2]
            else:
                assert ct.get(k) == cj.get(k), k
    timing = {"sec_per_round", "save_ms", "restore_ms", "sec_per_chunk", "overhead_ratio", "ckpt_bytes"}
    want = json.loads((tmp_path / "jax.json").read_text())
    strip = lambda recs: [{k: v for k, v in r.items() if k not in timing} for r in recs]  # noqa: E731
    assert strip(got["records"]) == strip(want["records"])
    assert [r.split(",")[0] for r in pcommon.ROWS] == [r.split(",")[0] for r in jfig11.emit.__globals__["ROWS"]]
    bench = json.loads((ROOT / "BENCH_elastic.json").read_text())
    assert set(got) == set(bench) and got == json.loads((tmp_path / "torch.json").read_text())
    for rec in got["records"]:
        (want_keys,) = {frozenset(r) for r in bench["records"] if r["scenario"] == rec["scenario"]}
        assert set(rec) == set(want_keys)


def test_example_call_for_call(monkeypatch):
    """The JAX example (a script, run here with its runner and init
    replaced by recorders) and the port's make the same calls."""
    calls = {"jax": [], "torch": []}

    def state_j(n):
        p = {"w": jnp.zeros((n, 3))}
        return JF.DFLState(params=p, opt_state=jax.vmap(JO.sgd().init)(p), round=jnp.zeros((), jnp.int32),
                           rng=jax.random.PRNGKey(0))

    def state_t(n):
        return state_from_numpy({"w": np.zeros((n, 3), np.float32)}, optimizer=PO.sgd(), device="cpu")

    el_j, _, init_j = _recorders(calls, "jax", None, state_j)
    monkeypatch.setattr(JF, "run_elastic_trajectory", el_j)
    monkeypatch.setattr(JF, "init_fl_state", init_j)
    runpy.run_path(str(ROOT / "examples" / "elastic_membership.py"), run_name="example")
    el_t, _, init_t = _recorders(calls, "torch", None, state_t)
    monkeypatch.setattr(pexample, "run_elastic_trajectory", el_t)
    monkeypatch.setattr(pexample, "init_fl_state", init_t)
    out = pexample.run("cpu")
    assert [c[0] for c in calls["torch"]] == [c[0] for c in calls["jax"]] == ["init", "elastic"] * 3
    for (kind, ct), (_, cj) in zip(calls["torch"], calls["jax"]):
        if kind == "elastic":
            assert {k: v for k, v in ct.items() if k != "arrays"} == {k: v for k, v in cj.items() if k != "arrays"}
            assert [a[0] for a in ct["arrays"]] == [a[0] for a in cj["arrays"]]
    assert set(out) == {"final", "hist", "aux", "resumed", "bit"}


def test_example_runs_small(monkeypatch, capsys):
    for name, value in (("N", 8), ("JOIN", 2), ("PER", 16), ("ROUNDS", 3), ("JOIN_ROUND", 0), ("WARMUP", 1)):
        monkeypatch.setattr(pexample, name, value)
    out = pexample.run("cpu")
    assert out["hist"]["n_active"] == [6, 8] and out["bit"] is True
    assert np.isfinite(out["hist"]["test_loss"]).all() and out["aux"]["n_hat"].shape == (8,)
    assert "bit-identical = True" in capsys.readouterr().out
