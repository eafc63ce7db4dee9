"""Telemetry of the port (``repro_torch.obs``) against the JAX package's
``repro.obs``: every case of ``tests/test_obs.py`` that has a counterpart,
with the same hand counts; the wire accountant, the gossip-health channels
and the run logs against the JAX functions on the same inputs; and the
keyword repairs (``run_trajectory(plan=)``, the sweeps' ``chunk_size`` /
``schedule_per_run``, ``train_loop(progress=)``, ``make_eval_fn(batch_eval=)``,
``init_kv_cache(dtype=)``), each against the JAX call.

Tolerances: histories rtol 1e-4 / atol 1e-5 (the two frameworks sum in
different orders, as ``test_torch_trainer.py``); the consensus distance
rtol 1e-5; a gossip-health report's rates and curves rtol 1e-4 / atol 1e-6
(push-sum in fp32, 16 rounds); every count (messages, bytes, records)
exactly."""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import fed as JF  # noqa: E402
from repro import obs as JO  # noqa: E402
from repro import optim as JOpt  # noqa: E402
from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.core import commplan as JC  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.compress import Compression as JCompression  # noqa: E402
from repro.data import batch_index_schedule, mnist_like, node_datasets  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402
from repro_torch import fed as PF  # noqa: E402
from repro_torch import obs as PO  # noqa: E402
from repro_torch import optim as POpt  # noqa: E402
from repro_torch.configs import get_reduced_config as p_reduced  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.compress import Compression as PCompression  # noqa: E402
from repro_torch.core.initialisation import InitConfig  # noqa: E402
from repro_torch.fed.trainer import _copy_generator  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import paper_models as PPM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, PER_NODE, BS, B_LOCAL, ROUNDS, HIDDEN = 6, 48, 8, 2, 8, (32,)
KEYS = ("train_loss", "test_loss", "sigma_ap", "sigma_an")
# the mass drift of a unit payload over 64 spread rounds of ring-1024 at
# link_p 0.9 (sparse, seed 17) stays below this: fp32 rounding of sums of
# ~1024 ones; chip_smoke.py phase 4j holds the card's run to it
MASS_DRIFT_FP32 = 1e-5


def setup_module(module):
    torch.set_num_threads(1)


def j_loss(p, b):
    return JPM.classifier_loss(JPM.mlp_forward(p, b[0]), b[1])


def t_loss(p, b):
    return PPM.classifier_loss(PPM.mlp_forward(p, b[0]), b[1])


@pytest.fixture(scope="module")
def data():
    ds = mnist_like(N * PER_NODE + 64, seed=0)
    xs, ys = node_datasets(ds, [np.arange(i * PER_NODE, (i + 1) * PER_NODE) for i in range(N)])
    return xs, ys, (ds.x[-64:], ds.y[-64:])


def _sched(rounds=ROUNDS, seed=0):
    return batch_index_schedule(PER_NODE, N, BS, rounds * B_LOCAL, seed=seed)


def _np_params(seed=0, gain=1.0):
    rng = np.random.default_rng(seed)
    dims = (784, *HIDDEN, 10)
    return {f"fc{i}": {"w": (rng.standard_normal((N, a, b)) * np.sqrt(2.0 / a) * gain).astype(np.float32),
                       "b": np.zeros((N, b), np.float32)} for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}


def _j_state(params, opt, seed=0):
    p = jax.tree_util.tree_map(jnp.asarray, params)
    return JF.DFLState(params=p, opt_state=jax.vmap(opt.init)(p), round=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(seed))


def _t_state(params, opt):
    return state_from_numpy(params, optimizer=opt, device="cpu")


# --------------------------------------------------------------- MetricsSpec
def test_legacy_spec_orders_channels_like_the_old_outs():
    spec = PO.MetricsSpec.legacy(True, True, wire=True)
    assert spec.names == ("train_loss", "test_loss", "sigma_ap", "sigma_an", "wire_messages")
    assert [c.name for c in spec.gated] == ["test_loss", "sigma_ap", "sigma_an"]
    assert PO.MetricsSpec.legacy(False, False).names == ("train_loss",)
    for args in ((True, True), (True, False), (False, True), (False, False)):
        for wire in (False, True):
            assert PO.MetricsSpec.legacy(*args, wire=wire).names == JO.MetricsSpec.legacy(*args, wire=wire).names


def test_spec_rejects_duplicate_names():
    with pytest.raises(ValueError):
        PO.MetricsSpec((PO.Channel("a"), PO.Channel("a")))
    with pytest.raises(ValueError):
        PO.BinSpec(2, (PO.BinChannel("a"), PO.BinChannel("a")))


def test_recorder_step_gates_and_orders():
    rec = PO.Recorder(PO.MetricsSpec((PO.Channel("x"), PO.Channel("y", gated=True))))

    def one(gate):
        return rec.step({"x": torch.tensor(2.0)}, gate=gate, gated_fn=lambda op: {"y": op * 3.0},
                        operand=torch.tensor(1.0))

    on, off = [float(v) for v in one(True)], [float(v) for v in one(False)]
    assert on == [2.0, 3.0]
    assert off[0] == 2.0 and np.isnan(off[1])
    with pytest.raises(ValueError, match="did not provide"):
        rec.step({}, gate=False)


def test_recorder_assemble_types_and_constants():
    rec = PO.Recorder(PO.MetricsSpec((PO.Channel("loss"), PO.Channel("count", ints=True))))
    mask = np.array([True, False, True])
    hist = rec.assemble(mask, [np.array([0.5, 1.0, 1.5]), np.array([2.0, 4.0, 6.0])], constants={"wire_bytes": 128})
    assert hist["round"] == [0, 2]
    assert hist["loss"] == [0.5, 1.5] and hist["count"] == [2, 6]
    assert isinstance(hist["count"][0], int)
    assert hist["wire_bytes"] == [128, 128]
    assert hist["sigma_ap"] == []  # train_loop base keys always present
    # device scalars and host numbers mix in one column
    cols = [[torch.tensor(0.5), 1.0, torch.tensor(1.5)], [torch.tensor(2), 4, 6]]
    got = rec.assemble(mask, cols)
    assert got["loss"] == [0.5, 1.5] and got["count"] == [2, 6]
    j = JO.Recorder(JO.MetricsSpec((JO.Channel("loss"), JO.Channel("count", ints=True))))
    assert j.assemble(mask, [np.array([0.5, 1.0, 1.5]), np.array([2.0, 4.0, 6.0])]) == got


def test_binspec_shapes_and_fills():
    spec = PO.BinSpec(5, (PO.BinChannel("a"), PO.BinChannel("nanbuf", fill=float("nan")),
                          PO.BinChannel("wide", width=16)))
    acc = spec.init()
    assert acc["a"].shape == (5,) and float(acc["a"].sum()) == 0.0 and acc["a"].dtype == torch.float32
    assert acc["wide"].shape == (16,)
    assert torch.isnan(acc["nanbuf"]).all()
    j = JO.BinSpec(5, (JO.BinChannel("a"), JO.BinChannel("nanbuf", fill=float("nan")),
                       JO.BinChannel("wide", width=16))).init()
    for k in j:
        np.testing.assert_array_equal(acc[k].numpy(), np.asarray(j[k]))


# ----------------------------------------------------------------- wire cost
def test_param_row_bytes_hand_counted():
    params = {"w": torch.zeros((4, 3, 2)), "b": torch.zeros((4, 5))}
    assert PO.param_row_bytes(params) == (3 * 2 + 5) * 4
    mixed = {"w": torch.zeros((8, 100)), "h": torch.zeros((8, 50), dtype=torch.bfloat16), "s": torch.zeros(())}
    assert PO.param_row_bytes(mixed) == 100 * 4 + 50 * 2 + 4


@pytest.mark.parametrize("codec", ["none", "int8", "fp8", "topk", "qtopk"])
def test_param_row_bytes_equals_jax_on_the_converted_tree(codec):
    tree = _np_params()
    c_t, c_j = PCompression(codec=codec, chunk=128), JCompression(codec=codec, chunk=128)
    want = JO.param_row_bytes(jax.tree_util.tree_map(jnp.asarray, tree),
                              codec_bytes=None if codec == "none" else c_j.leaf_row_bytes)
    state = _t_state(tree, POpt.sgd(1e-3, 0.5))
    got = PO.param_row_bytes(state.tree, codec_bytes=None if codec == "none" else c_t.leaf_row_bytes)
    assert got == want
    assert PO.param_row_bytes(tree, codec_bytes=None if codec == "none" else c_t.leaf_row_bytes) == want


def test_static_wire_ring_hand_counted():
    # ring(8): 8 undirected edges → 16 messages every clean round
    plan = PC.compile_plan(PT.ring(8), backend="sparse", device="cpu")
    np.testing.assert_array_equal(PO.static_wire_messages(plan, 5), [16] * 5)
    np.testing.assert_array_equal(PO.static_wire_messages(plan, 5),
                                  JO.static_wire_messages(JC.compile_plan(JT.ring(8), backend="sparse"), 5))


def test_static_wire_schedule_follows_round_map():
    # cyclic period-2 over ring(8) (8 edges) and complete(8) (28 edges)
    sch = PC.compile_schedule([PT.ring(8), PT.complete(8)], "dense", round_map=PC.cyclic_map(2), device="cpu")
    np.testing.assert_array_equal(PO.static_wire_messages(sch, 6), [16, 16, 56, 56, 16, 16])


def test_static_wire_churned_schedule_equals_jax():
    # 4 churned snapshots of a kreg4-12 (a churn keeps the edge count) and a
    # ring-12 under a sequence map: each round counts its own snapshot
    seq = [2, 0, 4, 3, 1, 4, 2]
    gj, gp = JT.random_k_regular(12, 4, seed=1), PT.random_k_regular(12, 4, seed=1)
    sj = JC.compile_schedule([*JT.churn_sequence(gj, 4, 0.3, seed=5), JT.ring(12)], "sparse",
                             round_map=JC.sequence_map(seq))
    sp = PC.compile_schedule([*PT.churn_sequence(gp, 4, 0.3, seed=5), PT.ring(12)], "sparse",
                             round_map=PC.sequence_map(seq), device="cpu")
    got = PO.static_wire_messages(sp, 11)
    np.testing.assert_array_equal(got, JO.static_wire_messages(sj, 11))
    assert got.tolist() == [48, 48, 24, 48, 48, 24, 48, 48, 48, 24, 48]


def test_static_wire_none_for_directed():
    g = PT.ring(6)
    directed = PT.Graph(adjacency=np.triu(g.adjacency), name="dir", directed=True)
    plan = PC.compile_plan(directed, backend="dense", device="cpu")
    assert PO.static_wire_messages(plan, 3) is None
    assert PO.make_wire_fn(plan) is None
    gj = JT.ring(6)
    jplan = JC.compile_plan(JT.Graph(adjacency=np.triu(gj.adjacency), name="dir", directed=True), backend="dense")
    assert JO.static_wire_messages(jplan, 3) is None and JO.make_wire_fn(jplan) is None


def test_wire_fn_clean_masks_hand_counted():
    # ring(8) with node 0 inactive: edges (0,1) and (7,0) die → 6 live edges
    plan = PC.compile_plan(PT.ring(8), backend="sparse", device="cpu")
    wire = PO.make_wire_fn(plan)
    active = torch.ones(8, dtype=torch.bool)
    active[0] = False
    assert int(wire(None, 0, active=active)) == 12
    assert wire(None, 0) == 16
    jwire = JO.make_wire_fn(JC.compile_plan(JT.ring(8), backend="sparse"))
    assert float(jwire(None, 0, active=jnp.ones(8, bool).at[0].set(False))) == 12.0


@pytest.mark.parametrize("backend", ["dense", "sparse", "ppermute"])
def test_wire_fn_equals_jax_on_injected_draws(backend, monkeypatch):
    """The JAX package's failure masks for key s injected as the port's
    draw (``commplan._draw_failure_masks``): the two accountants count the
    same edges, on every backend, with and without membership masks."""
    fm = dict(link_p=0.6, node_p=0.8)
    pj = JC.compile_plan(JT.random_k_regular(8, 3, seed=0), backend="sparse", failures=JC.FailureModel(**fm))
    pp = PC.compile_plan(PT.random_k_regular(8, 3, seed=0), backend=backend, failures=PC.FailureModel(**fm),
                         device="cpu")
    jwire, pwire = JO.make_wire_fn(pj), PO.make_wire_fn(pp)
    act = np.array([1, 1, 0, 1, 1, 1, 1, 0], bool)
    for s in range(6):
        key = jax.random.PRNGKey(s)
        k_ek, k_na = (np.asarray(a) for a in pj._round_masks_ext(key, None, None))
        monkeypatch.setattr(PC, "_draw_failure_masks", lambda f, w, n, g, e=k_ek, a=k_na: (
            torch.tensor(e[:max(w, 1)]), torch.tensor(a)))
        uv = np.asarray(pj.event_uv)
        expect = 2 * sum(bool(k_ek[i] and k_na[u] and k_na[v]) for i, (u, v) in enumerate(uv))
        assert int(pwire(torch.Generator(), 0)) == int(float(jwire(key, 0))) == expect
        assert int(pwire(torch.Generator(), 0, active=torch.as_tensor(act))) == \
            int(float(jwire(key, 0, active=jnp.asarray(act))))


def test_sharded_wire_per_round_prices_the_halo():
    """ring-8 over 2 shards: each shard pulls its 2 remote neighbours, so 4
    rows cross a round, priced at the JAX package's row bytes (fp32 and the
    int8 codec's encoding), one collective a dtype buffer of the payload."""
    from repro_torch.core.shardplan import ShardedCommPlan, _layouts

    plan = PC.compile_plan(PT.ring(8), backend="sparse", device="cpu")
    recv, send = _layouts(plan, 2)
    sp = ShardedCommPlan(base=plan, group=None, n_shards=2, nps=4, rank=0, recv=recv, send=send)
    tree = {"w": torch.zeros((8, 10)), "b": {"v": torch.zeros((8, 3))}}
    jtree = {"w": jnp.zeros((8, 10)), "b": {"v": jnp.zeros((8, 3))}}
    assert PO.sharded_wire_per_round(sp, tree) == {
        "wire_bytes": 4 * JO.param_row_bytes(jtree), "wire_rows": 4, "wire_collectives": 1}
    comp, jcomp = PCompression("int8"), JCompression("int8")
    got = PO.sharded_wire_per_round(sp, tree, codec_bytes=comp.leaf_row_bytes)
    assert got["wire_bytes"] == 4 * JO.param_row_bytes(jtree, codec_bytes=jcomp.leaf_row_bytes)
    # a mixed-dtype payload packs into two buffers, two collectives
    mixed = {**tree, "h": torch.zeros((8, 2), dtype=torch.bfloat16)}
    assert PO.sharded_wire_per_round(sp, mixed)["wire_collectives"] == 2
    unsharded = ShardedCommPlan(base=plan, group=None, n_shards=1, nps=8, rank=0, recv=_layouts(plan, 1)[0])
    assert PO.sharded_wire_per_round(unsharded, tree) == {"wire_bytes": 0, "wire_rows": 0, "wire_collectives": 0}


# ----------------------------------------------- executor wire integration
def test_trajectory_reports_static_wire(data):
    xs, ys, test = data
    opt = POpt.sgd(1e-3, 0.5)
    rf = PF.make_round_fn(t_loss, opt, PC.compile_plan(PT.ring(N), backend="dense", device="cpu"))
    state = _t_state(_np_params(), opt)
    state, hist = PF.run_trajectory(state, rf, xs, ys, _sched(), n_rounds=ROUNDS, eval_every=3,
                                    eval_fn=PF.make_eval_fn(t_loss), eval_batch=test, device="cpu")
    assert hist["wire_messages"] == [2 * N] * len(hist["round"])
    row_bytes = JO.param_row_bytes(jax.tree_util.tree_map(jnp.asarray, _np_params()))
    assert hist["wire_bytes"] == [2 * N * row_bytes] * len(hist["round"])


def test_trajectory_traced_wire_replays_generator_stream(data):
    """Under failures each round's count replays exactly the draw its mix
    consumed: re-derived here from the initial state's generator."""
    xs, ys, _ = data
    opt = POpt.sgd(1e-3, 0.5)
    rf = PF.make_round_fn(t_loss, opt, PC.compile_plan(PT.ring(N), backend="dense", device="cpu"), link_p=0.5)
    state0 = _t_state(_np_params(), opt)
    _, hist = PF.run_trajectory(state0, rf, xs, ys, _sched(), n_rounds=ROUNDS, eval_every=1, device="cpu")
    eff = rf.plan
    gen = _copy_generator(state0.generator)
    uv = eff.event_uv.numpy()
    for r in range(ROUNDS):
        ek, na = (m.numpy() for m in eff.round_masks(gen))
        assert hist["wire_messages"][r] == 2 * sum(bool(ek[i] and na[u] and na[v]) for i, (u, v) in enumerate(uv))
    assert any(m < 2 * N for m in hist["wire_messages"])  # failures actually bit


def test_telemetry_does_not_perturb_trajectory(data):
    """The wire channel reads a copy of the generator: params, generator and
    the legacy channels are bitwise the same with and without it."""
    xs, ys, test = data
    opt = POpt.sgd(1e-3, 0.5)
    rf = PF.make_round_fn(t_loss, opt, PC.compile_plan(PT.ring(N), backend="dense", device="cpu"), link_p=0.5)

    def bare(state, batch):  # no .plan attribute → no wire channels
        return rf(state, batch)

    common = dict(n_rounds=ROUNDS, eval_every=3, eval_fn=PF.make_eval_fn(t_loss), eval_batch=test,
                  track_sigmas=True, device="cpu")
    s_wire, h_wire = PF.run_trajectory(_t_state(_np_params(), opt), rf, xs, ys, _sched(), **common)
    s_bare, h_bare = PF.run_trajectory(_t_state(_np_params(), opt), bare, xs, ys, _sched(), **common)
    assert "wire_messages" in h_wire and "wire_messages" not in h_bare
    assert torch.equal(s_wire.params, s_bare.params)
    assert torch.equal(s_wire.generator.get_state(), s_bare.generator.get_state())
    for k in ("round", *KEYS):
        assert h_wire[k] == h_bare[k]


def test_trajectory_on_chunk_streams_history(data):
    xs, ys, _ = data
    opt = POpt.sgd(1e-3, 0.5)
    rf = PF.make_round_fn(t_loss, opt, PC.compile_plan(PT.ring(N), backend="dense", device="cpu"))
    seen = []
    _, hist = PF.run_trajectory(_t_state(_np_params(), opt), rf, xs, ys, _sched(), n_rounds=ROUNDS, eval_every=2,
                                chunk_size=3, on_chunk=lambda r0, r1, h: seen.append((r0, r1, h)), device="cpu")
    assert [(r0, r1) for r0, r1, _ in seen] == [(0, 3), (3, 6), (6, 8)]
    assert [r for _, _, h in seen for r in h["round"]] == hist["round"]
    assert [v for _, _, h in seen for v in h["train_loss"]] == hist["train_loss"]
    assert all("wire_bytes" in h for _, _, h in seen)


# --------------------------------------------- keyword repairs against JAX
def test_run_trajectory_plan_keyword_matches_jax(data):
    """A hand-rolled round function (no ``.plan``) given ``plan=`` records
    the wire channels, as in the JAX package; the histories agree."""
    xs, ys, test = data
    oj, ot = JOpt.sgd(1e-3, 0.5), POpt.sgd(1e-3, 0.5)
    pj = JC.compile_plan(JT.ring(N), backend="dense")
    pp = PC.compile_plan(PT.ring(N), backend="dense", device="cpu")
    rf_j, rf_t = JF.make_round_fn(j_loss, oj, pj), PF.make_round_fn(t_loss, ot, pp)
    common = dict(n_rounds=ROUNDS, eval_every=2, eval_batch=test, track_sigmas=True, b_local=B_LOCAL)
    _, h_j = JF.run_trajectory(_j_state(_np_params(), oj), lambda s, b: rf_j(s, b), xs, ys, _sched(), plan=pj,
                               eval_fn=JF.make_eval_fn(j_loss), **common)
    _, h_t = PF.run_trajectory(_t_state(_np_params(), ot), lambda s, b: rf_t(s, b), xs, ys, _sched(), plan=pp,
                               eval_fn=PF.make_eval_fn(t_loss), device="cpu", **common)
    assert sorted(h_t) == sorted(h_j)
    assert h_t["round"] == h_j["round"]
    assert h_t["wire_messages"] == h_j["wire_messages"] and h_t["wire_bytes"] == h_j["wire_bytes"]
    for k in KEYS:
        np.testing.assert_allclose(h_t[k], h_j[k], rtol=1e-4, atol=1e-5, err_msg=k)
    # under failures the hand-rolled run counts what the plan's own round_fn run counts
    rf_f = PF.make_round_fn(t_loss, ot, pp, link_p=0.5)
    _, h_auto = PF.run_trajectory(_t_state(_np_params(), ot), rf_f, xs, ys, _sched(), device="cpu", **common)
    _, h_hand = PF.run_trajectory(_t_state(_np_params(), ot), lambda s, b: rf_f(s, b), xs, ys, _sched(),
                                  plan=rf_f.plan, device="cpu", **common)
    assert h_hand["wire_messages"] == h_auto["wire_messages"]


def test_sweep_per_run_schedules_and_chunks_match_jax(data):
    """``run_sweep(schedule_per_run=True, chunk_size=)``: each run takes its
    own batch order, as the JAX sweep does (held at a tolerance: the JAX
    test's own bitwise assert misses by an ulp on jax 0.9.0)."""
    xs, ys, test = data
    oj, ot = JOpt.sgd(1e-3, 0.5), POpt.sgd(1e-3, 0.5)
    scheds = np.stack([_sched(4, seed=s) for s in (0, 1)])
    inits = [_np_params(0), _np_params(1)]
    common = dict(n_rounds=4, eval_every=1, eval_batch=test, b_local=B_LOCAL, chunk_size=3,
                  schedule_per_run=True)
    _, h_j = JF.run_sweep([_j_state(p, oj) for p in inits],
                          JF.make_round_fn(j_loss, oj, JC.compile_plan(JT.ring(N), "dense")), xs, ys, scheds,
                          eval_fn=JF.make_eval_fn(j_loss), **common)
    rf_t = PF.make_round_fn(t_loss, ot, PC.compile_plan(PT.ring(N), "dense", device="cpu"))
    fin_t, h_t = PF.run_sweep([_t_state(p, ot) for p in inits], rf_t, xs, ys, scheds,
                              eval_fn=PF.make_eval_fn(t_loss), device="cpu", **common)
    for a, b in zip(h_t, h_j):
        assert a["round"] == b["round"]
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5, err_msg=k)
    # run i is run_trajectory on schedule i, and the chunking changes nothing
    _, h_1 = PF.run_trajectory(_t_state(inits[1], ot), rf_t, xs, ys, scheds[1], n_rounds=4, eval_every=1,
                               eval_fn=PF.make_eval_fn(t_loss), eval_batch=test, b_local=B_LOCAL, device="cpu")
    assert h_t[1]["train_loss"] == h_1["train_loss"] and h_t[1]["test_loss"] == h_1["test_loss"]
    assert h_t[0]["train_loss"] != h_t[1]["train_loss"]
    with pytest.raises(ValueError, match="leading axis"):
        PF.run_sweep([_t_state(p, ot) for p in inits], rf_t, xs, ys, scheds[:1], n_rounds=4, b_local=B_LOCAL,
                     schedule_per_run=True, device="cpu")


def test_warmup_keywords_take_the_jax_meaning(data):
    """``run_warmup_trajectory(chunk_size=)`` and ``run_warmup_sweep(chunk_size=,
    schedule_per_run=)``: the JAX signatures take them, and with the JAX
    meaning a chunked run is the unchunked one and sweep run i is the
    standalone warmup on schedule i."""
    import inspect

    for name in ("run_warmup_trajectory", "run_warmup_sweep", "run_sweep"):
        want = {"chunk_size", "schedule_per_run"} & set(inspect.signature(getattr(JF, name)).parameters)
        assert want <= set(inspect.signature(getattr(PF, name)).parameters), name
    xs, ys, test = data
    ot = POpt.sgd(1e-3, 0.5)
    rf = PF.make_round_fn(t_loss, ot, PC.compile_plan(PT.ring(N), "dense", device="cpu"))

    def init_one(g, gains):
        return PPM.init_mlp(InitConfig("he_normal", gains), g, hidden=HIDDEN)

    def estimate(seed, budget=None):
        return torch.full((N,), 1.0 + 0.1 * (seed % 7), dtype=torch.float32)

    kw = dict(n_nodes=N, init_one=init_one, optimizer=ot, estimate_gains=estimate, n_rounds=4, eval_every=1,
              eval_fn=PF.make_eval_fn(t_loss), eval_batch=test, b_local=B_LOCAL, device="cpu")
    s_a, h_a, _ = PF.run_warmup_trajectory(3, rf, xs, ys, _sched(4), chunk_size=3, **kw)
    s_b, h_b, _ = PF.run_warmup_trajectory(3, rf, xs, ys, _sched(4), **kw)
    assert torch.equal(s_a.params, s_b.params) and h_a == h_b
    scheds = np.stack([_sched(4, seed=s) for s in (0, 1)])
    _, hs, _ = PF.run_warmup_sweep([3, 4], rf, xs, ys, scheds, chunk_size=2, schedule_per_run=True, **kw)
    _, h_1, _ = PF.run_warmup_trajectory(4, rf, xs, ys, scheds[1], **kw)
    assert hs[1] == h_1 and hs[0] != hs[1]


def test_train_loop_progress_matches_jax(data, capsys):
    """``train_loop(progress=True)`` prints each recorded round as the JAX
    loop does; the lines agree to the printed digits and match the history."""
    xs, ys, test = data
    oj, ot = JOpt.sgd(1e-3, 0.5), POpt.sgd(1e-3, 0.5)
    sched = _sched(3)
    node_idx = np.arange(N)[:, None, None]

    def batches():
        for r in range(3):
            idx = sched[r * B_LOCAL:(r + 1) * B_LOCAL].transpose(1, 0, 2)
            yield xs[node_idx, idx], ys[node_idx, idx]

    common = dict(n_rounds=3, eval_every=1, eval_batch=test, progress=True)
    JF.train_loop(_j_state(_np_params(), oj), JF.make_round_fn(j_loss, oj, JC.compile_plan(JT.ring(N), "dense")),
                  batches(), eval_fn=JF.make_eval_fn(j_loss), **common)
    j_lines = capsys.readouterr().out.strip().splitlines()
    _, h_t = PF.train_loop(_t_state(_np_params(), ot),
                           PF.make_round_fn(t_loss, ot, PC.compile_plan(PT.ring(N), "dense", device="cpu")),
                           batches(), eval_fn=PF.make_eval_fn(t_loss), device="cpu", **common)
    t_lines = capsys.readouterr().out.strip().splitlines()
    assert len(t_lines) == len(j_lines) == 3
    assert t_lines == [f"round {r:4d} train {h_t['train_loss'][i]:.4f} test {h_t['test_loss'][i]:.4f}"
                       for i, r in enumerate(h_t["round"])]
    for a, b in zip(t_lines, j_lines):
        fa, fb = (np.array([float(w) for w in line.split()[3::2]]) for line in (a, b))
        assert a.split()[:2] == b.split()[:2]
        np.testing.assert_allclose(fa, fb, atol=1.5e-4)
    _, quiet = PF.train_loop(_t_state(_np_params(), ot),
                             PF.make_round_fn(t_loss, ot, PC.compile_plan(PT.ring(N), "dense", device="cpu")),
                             batches(), n_rounds=3, eval_every=1, eval_fn=PF.make_eval_fn(t_loss), eval_batch=test,
                             device="cpu")
    assert capsys.readouterr().out == "" and quiet == h_t


def test_make_eval_fn_batch_eval_matches_jax(data):
    _, _, test = data
    params = _np_params()
    j = {be: np.asarray(JF.make_eval_fn(j_loss, batch_eval=be)(jax.tree_util.tree_map(jnp.asarray, params), test))
         for be in (True, False)}
    tree = _t_state(params, POpt.sgd(1e-3, 0.5)).tree
    t = {be: PF.make_eval_fn(t_loss, batch_eval=be)(tree, tuple(torch.as_tensor(a) for a in test)).numpy()
         for be in (True, False)}
    np.testing.assert_array_equal(t[True], t[False])
    np.testing.assert_allclose(t[False], j[False], rtol=1e-5)


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
def test_init_kv_cache_dtype_matches_jax(dtype):
    cfg_j, cfg_t = j_reduced("qwen2.5-3b"), p_reduced("qwen2.5-3b")
    cj = JA.init_kv_cache(cfg_j, (2,), 16, dtype=None if dtype is None else jnp.dtype(dtype))
    ct = PA.init_kv_cache(cfg_t, (2,), 16, dtype=dtype, device="cpu")
    for k in ("k", "v"):
        assert tuple(ct[k].shape) == cj[k].shape
        assert str(ct[k].dtype).removeprefix("torch.") == str(cj[k].dtype)
        assert not ct[k].any()
    assert PA.init_kv_cache(cfg_t, (1,), 4, torch.bfloat16, device="cpu")["k"].dtype == torch.bfloat16


# --------------------------------------------------------- health channels
def test_consensus_distance_hand_counted():
    params = {"w": torch.tensor([[0.0], [2.0]])}
    assert float(PO.consensus_distance(params)) == 1.0  # mean over the two nodes of |w_i − 1|
    assert float(PO.consensus_distance({"w": torch.ones((4, 7))})) == 0.0


def test_consensus_distance_matches_jax():
    tree = _np_params(gain=2.0)
    want = float(JO.consensus_distance(jax.tree_util.tree_map(jnp.asarray, tree)))
    state = _t_state(tree, POpt.sgd(1e-3, 0.5))
    got = float(PO.consensus_distance(state.tree))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(PO.consensus_distance(state.params)) == got  # the flat buffer is the same model


def test_staleness_histogram_edges():
    h = PO.staleness_histogram(np.array([1.0, 0.0, 3.0, 0.0]), horizon=8.0)
    assert h["counts"] == [1.0, 0.0, 3.0, 0.0]
    assert h["edges"] == [0.0, 2.0, 4.0, 6.0, 8.0]
    assert PO.staleness_histogram(torch.tensor([1.0, 0.0, 3.0, 0.0]), 8.0) == h == \
        JO.staleness_histogram(np.array([1.0, 0.0, 3.0, 0.0]), 8.0)


@pytest.mark.parametrize("graph", ["ring16", "kreg4-16", "complete8"])
def test_gossip_health_matches_jax_on_a_clean_plan(graph):
    build = {"ring16": lambda T: T.ring(16), "kreg4-16": lambda T: T.random_k_regular(16, 4, seed=0),
             "complete8": lambda T: T.complete(8)}[graph]
    hj = JO.gossip_health(JC.compile_plan(build(JT), "dense"), rounds=16)
    hp = PO.gossip_health(PC.compile_plan(build(PT), "dense", device="cpu"), rounds=16)
    assert sorted(hp) == sorted(hj)
    assert hp["rounds_to_1pct"] == hj["rounds_to_1pct"]
    for k in ("fitted_rate", "predicted_rate", "max_rel_err", "mass_drift"):
        np.testing.assert_allclose(np.asarray(hp[k], dtype=float), np.asarray(hj[k], dtype=float), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert len(hp["mass_drift"]) == 17 and hp["mass_drift"][0] == 0.0
    json.dumps(hp)  # JSON-able


def test_mass_drift_stays_at_fp32_level_on_ring1024_with_failures():
    """The level chip_smoke.py phase 4j holds the card to: ring-1024,
    sparse, link_p 0.9, 64 rounds of failure draws keyed seed 17."""
    plan = PC.compile_plan(PT.ring(1024), "sparse", failures=PC.FailureModel(link_p=0.9), device="cpu")
    drift = PO.mass_drift_trace(plan, 64, seed=17)
    assert drift.shape == (65,) and drift[0] == 0.0
    assert 0.0 <= drift.max() < MASS_DRIFT_FP32
    with pytest.raises(ValueError, match="seed"):
        PO.mass_drift_trace(plan, 2)


# ------------------------------------------------------------ run-log export
def test_run_log_round_trip(tmp_path):
    manifest = PO.run_manifest({"fig": "smoke", "lr": 0.1}, seed=7, argv=["x", "--y"], device="cpu")
    hist = {"round": [0, 3], "train_loss": [1.0, float("nan")], "test_loss": [0.5, 0.4],
            "sigma_ap": [], "sigma_an": []}
    rows = PO.history_rows(hist)
    path = tmp_path / "run.jsonl"
    assert PO.write_run_log(path, [manifest, *rows, {"kind": "summary", "final": torch.tensor(0.4)}]) == 4
    back = PO.read_run_log(path)
    assert back[0]["kind"] == "manifest" and back[0]["seed"] == 7
    assert back[0]["jax_version"] is None and back[0]["backend"] == "cpu"
    assert back[0]["torch_version"] == torch.__version__ and back[0]["n_devices"] == 1
    assert set(JO.export.MANIFEST_KEYS) <= set(back[0])
    assert back[1] == {"kind": "round", "round": 0, "train_loss": 1.0, "test_loss": 0.5}
    assert back[2]["train_loss"] is None  # NaN sanitised to null (strict JSON)
    assert PO.validate_run_log(path) == [] == JO.validate_run_log(path)
    for line in path.read_text().splitlines():
        json.loads(line, parse_constant=lambda _: pytest.fail("non-strict JSON"))
    assert PO.history_rows(hist) == JO.history_rows(hist)


def test_run_log_schema_gate_catches_breakage(tmp_path):
    manifest = PO.run_manifest({}, seed=0, device="cpu")
    bad = dict(manifest)
    del bad["git_rev"]
    path = tmp_path / "bad.jsonl"
    PO.write_run_log(path, [bad, {"kind": "round", "round": 0}])
    assert any("git_rev" in p for p in PO.validate_run_log(path))
    assert PO.validate_run_log(path) == JO.validate_run_log(path)
    PO.write_run_log(path, [{"kind": "round", "round": 0}])
    assert any("manifest" in p for p in PO.validate_run_log(path))
    PO.write_run_log(path, [manifest])
    assert any("no data records" in p for p in PO.validate_run_log(path))
    assert PO.validate_run_log(tmp_path / "missing.jsonl")[0].startswith("unreadable")


def test_history_rows_uses_bin_axis_for_event_histories():
    hist = {"bin": [0, 1], "time": [2.0, 4.0], "messages": [4, 4], "round": []}
    rows = PO.history_rows(hist, kind="bin")
    assert [r["kind"] for r in rows] == ["bin", "bin"]
    assert rows[1]["messages"] == 4 and rows[1]["time"] == 4.0
    assert rows == JO.history_rows(hist, kind="bin")


def _port_log(path: Path) -> Path:
    manifest = PO.run_manifest({"model": "mlp", "rounds": 2}, seed=3, device="cpu")
    rows = PO.history_rows({"round": [0, 1], "train_loss": [1.5, 1.25], "wire_bytes": [64, 64]})
    PO.write_run_log(path, [manifest, *rows, {"kind": "summary", "final_train_loss": 1.25}])
    return path


def test_port_run_log_passes_check_bench_gate(tmp_path):
    log = _port_log(tmp_path / "run.jsonl")
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "check_bench.py"), "--run-log", str(log)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ok (4 records)" in out.stdout


def test_dashboard_run_mode_renders_port_telemetry(tmp_path):
    log = _port_log(tmp_path / "run.jsonl")
    out = tmp_path / "run.md"
    subprocess.run([sys.executable, str(ROOT / "tools" / "dashboard.py"), "--run", str(log), "--out-md", str(out)],
                   check=True, capture_output=True, timeout=120)
    text = out.read_text()
    assert "Manifest" in text and "History (2 round records)" in text
    assert "wire_bytes" in text and "summary" in text


def test_profile_trace_is_a_noop_without_a_dir_and_records_scopes(tmp_path):
    with PO.profile_trace(None):
        pass
    assert not (tmp_path / "tr").exists()
    from repro_torch.obs.export import scope

    with PO.profile_trace(tmp_path / "tr"):
        for name in ("dfl_local", "dfl_mix", "dfl_eval"):
            with scope(name):
                torch.ones(4).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"dfl_local", "dfl_mix", "dfl_eval"} <= names
