"""The uncoordinated warmup of the port (estimate → per-node gain → init →
train, §4.4) and the drivers on it, against the JAX package's.

- ``run_warmup_trajectory`` equals the port's own estimate +
  ``init_fl_state`` + ``run_trajectory`` with the same seed split, bitwise
  on the CPU; a budget-b cell of ``run_warmup_sweep`` equals a standalone
  budget-b run, bitwise.
- Training after the JAX package's estimated gains: the JAX
  ``init_fl_state(k_init, gains=...)`` ensemble, converted through
  ``convert.py``, trained by the port's ``run_trajectory``, against JAX's
  ``run_warmup_trajectory`` to the trajectory tolerance of
  ``test_torch_trainer.py`` (rtol 1e-4, atol 1e-5).
- fig4 is held call for call (both sides' runners replaced by one
  recorder): the recorded arguments and the emitted rows equal.
- The CLI's ``--uncoordinated-init`` modes, the uncoordinated and failure
  examples and the estimates benchmark run on the CPU at cut sizes.
"""
import json
import math
import zlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.gossip as JG  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig4_estimates as jfig4  # noqa: E402
from repro import fed as JF  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.core import commplan as JC  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.initialisation import InitConfig as JInitConfig  # noqa: E402
from repro.data import batch_index_schedule, mnist_like, node_datasets  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402
from repro_torch import fed as PF  # noqa: E402
from repro_torch import optim as PO  # noqa: E402
from repro_torch.benchmarks import common as pcommon  # noqa: E402
from repro_torch.benchmarks import estimates_bench  # noqa: E402
from repro_torch.benchmarks import fig4_estimates as pfig4  # noqa: E402
from repro_torch.convert import state_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.initialisation import InitConfig  # noqa: E402
from repro_torch.examples import failure_resilience, uncoordinated_init  # noqa: E402
from repro_torch.gossip import make_gain_estimator, split_seed  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import paper_models as PPM  # noqa: E402

N, PER, BS, B_LOCAL, ROUNDS, HIDDEN = 8, 32, 8, 2, 3, (32,)
KEYS = ("train_loss", "test_loss", "sigma_ap", "sigma_an")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU products run fastest on one thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def torch_loss(p, b):
    return PPM.classifier_loss(PPM.mlp_forward(p, b[0]), b[1])


def jax_loss(p, b):
    return JPM.classifier_loss(JPM.mlp_forward(p, b[0]), b[1])


def init_one(g, gains):
    return PPM.init_mlp(InitConfig("he_normal", gains), g, hidden=HIDDEN)


@pytest.fixture(scope="module")
def setup():
    ds = mnist_like(N * PER + 64, seed=0)
    xs, ys = node_datasets(ds, [np.arange(i * PER, (i + 1) * PER) for i in range(N)])
    sched = batch_index_schedule(PER, N, BS, ROUNDS * B_LOCAL, seed=0)
    graph = PT.random_k_regular(N, 4, seed=0)
    opt = PO.sgd(1e-3, 0.5)
    plan = PC.compile_plan(graph, "sparse", failures=PC.FailureModel(link_p=0.8), device="cpu")
    common = dict(n_rounds=ROUNDS, eval_every=1, eval_fn=PF.make_eval_fn(torch_loss), eval_batch=(ds.x[-64:], ds.y[-64:]),
                  track_sigmas=True, b_local=B_LOCAL, device="cpu")
    return dict(xs=xs, ys=ys, sched=sched, graph=graph, opt=opt, plan=plan, common=common,
                rf=PF.make_round_fn(torch_loss, opt, graph, link_p=0.8, device="cpu"))


def test_warmup_trajectory_equals_its_three_phases(setup):
    s = setup
    est = make_gain_estimator(s["plan"], pi_rounds=12, ps_rounds=16)
    fin, hist, gains = PF.run_warmup_trajectory(
        5, s["rf"], s["xs"], s["ys"], s["sched"], n_nodes=N, init_one=init_one, optimizer=s["opt"],
        estimate_gains=est, **s["common"])
    k_est, k_init = split_seed(5, 2)
    gains2 = est(k_est)
    state = PF.init_fl_state(k_init, N, init_one, s["opt"], gains=gains2, device="cpu")
    fin2, hist2 = PF.run_trajectory(state, s["rf"], s["xs"], s["ys"], s["sched"], **s["common"])
    np.testing.assert_array_equal(gains, gains2.numpy())
    assert torch.equal(fin.params, fin2.params)
    assert sorted(hist) == sorted(set(hist2) - {"wire_messages", "wire_bytes"})  # the warmup records no wire
    assert hist == {k: hist2[k] for k in hist}
    assert np.isfinite(hist["test_loss"]).all() and gains.shape == (N,)


@pytest.mark.parametrize("budget", [4, 10])
def test_sweep_cell_equals_a_standalone_budget_run(setup, budget):
    s = setup
    est_max = make_gain_estimator(s["plan"], pi_rounds=10, ps_rounds=10)
    states, hists, gains = PF.run_warmup_sweep(
        [3, 3], s["rf"], s["xs"], s["ys"], s["sched"], n_nodes=N, init_one=init_one, optimizer=s["opt"],
        estimate_gains=est_max, budgets=[4, 10], **s["common"])
    i = [4, 10].index(budget)
    fin, hist, g = PF.run_warmup_trajectory(
        3, s["rf"], s["xs"], s["ys"], s["sched"], n_nodes=N, init_one=init_one, optimizer=s["opt"],
        estimate_gains=make_gain_estimator(s["plan"], pi_rounds=budget, ps_rounds=budget), **s["common"])
    np.testing.assert_array_equal(gains[i], g)
    assert hists[i] == hist
    assert torch.equal(states.params[i], fin.params)
    with pytest.raises(ValueError, match="budget"):
        est_max(0, 11)


def test_training_after_jax_gains_matches_jax(setup):
    """JAX's own warmup (its gossip on its draws, its init at those gains);
    the port trains the same ensemble, converted, on a failure-free round."""
    s = setup
    gj = JT.random_k_regular(N, 4, seed=0)
    opt_j = JO.sgd(1e-3, 0.5)
    icfg = JInitConfig("he_normal", 1.0)

    def init_one_j(k, gn):
        return JPM.init_mlp(icfg.replace(gain=gn), k, hidden=HIDDEN)

    est_j = JG.make_gain_estimator(JC.compile_plan(gj, "sparse", failures=JC.FailureModel(link_p=0.8)),
                                   pi_rounds=12, ps_rounds=16)
    key = jax.random.PRNGKey(5)
    test = s["common"]["eval_batch"]
    fin_j, hist_j, gains_j = JF.run_warmup_trajectory(
        key, JF.make_round_fn(jax_loss, opt_j, gj), s["xs"], s["ys"], s["sched"], n_nodes=N,
        init_one=init_one_j, optimizer=opt_j, estimate_gains=est_j, n_rounds=ROUNDS, eval_every=1,
        eval_fn=JF.make_eval_fn(jax_loss), eval_batch=test, track_sigmas=True, b_local=B_LOCAL)
    _, k_init = jax.random.split(key)
    init_j = jax.jit(lambda k, g: JF.init_fl_state(k, N, init_one_j, opt_j, gains=g))(k_init, gains_j)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    state = state_from_numpy(to_np(init_j.params), to_np(init_j.opt_state), device="cpu")
    rf = PF.make_round_fn(torch_loss, s["opt"], s["graph"], device="cpu")
    fin, hist = PF.run_trajectory(state, rf, s["xs"], s["ys"], s["sched"], **s["common"])
    assert hist["round"] == hist_j["round"] == list(range(ROUNDS))
    assert gains_j.min() > 1.0 and np.isfinite(gains_j).all()
    for k in KEYS:
        np.testing.assert_allclose(hist[k], hist_j[k], rtol=1e-4, atol=1e-5, err_msg=k)
    params_j = to_np(fin_j.params)
    for layer, leaves in to_numpy(fin)[0].items():
        for name, leaf in leaves.items():
            np.testing.assert_allclose(leaf, params_j[layer][name], rtol=1e-4, atol=1e-5, err_msg=f"{layer}/{name}")


def test_uncoordinated_runner_is_its_sweep_cell():
    small = dict(n_nodes=N, graph=PT.random_k_regular(N, 4, seed=0), rounds=2, per_node=PER, batch_size=BS,
                 hidden=HIDDEN, eval_every=1, test_size=64, device="cpu")
    hist, spr, gains = pcommon.run_dfl_mlp_uncoordinated(est_rounds=6, **small)
    grid, spr_sweep = pcommon.run_dfl_mlp_uncoordinated_sweep(budgets=(3, 6), seeds=(0,), **small)
    assert len(grid) == 2 and len(grid[0]) == 1 and spr > 0 and spr_sweep > 0
    assert grid[1][0][0] == hist
    np.testing.assert_array_equal(grid[1][0][1], gains)
    assert not np.array_equal(grid[0][0][1], gains)  # 3 rounds is another estimate


# ------------------------------------------------------------------ fig4
def _norm(kwargs):
    out = {}
    for k, v in kwargs.items():
        if k == "device":
            continue
        if isinstance(v, (JT.Graph, PT.Graph)):
            v = (v.name, v.adjacency.tobytes())
        out[k] = v
    return out


def _level(kwargs):
    return 1.0 + zlib.crc32(repr(sorted(_norm(kwargs).items())).encode()) % 1000 / 1000


def test_fig4_call_for_call(monkeypatch):
    calls = {"jax": [], "torch": []}

    def make(side):
        def run_dfl_mlp(**kw):
            calls[side].append(("run_dfl_mlp", _norm(kw)))
            return {"round": [0], "test_loss": [_level(kw)]}, 0.0625

        def sweep(**kw):
            calls[side].append(("sweep", _norm(kw)))
            grid = [[({"round": [0], "test_loss": [_level({**kw, "b": b})]}, np.linspace(1.0, b, N))]
                    for b in kw["budgets"]]
            return grid, 0.125

        return run_dfl_mlp, sweep

    for side, mod in (("jax", jfig4), ("torch", pfig4)):
        run, sweep = make(side)
        monkeypatch.setattr(mod, "run_dfl_mlp", run)
        monkeypatch.setattr(mod, "run_dfl_mlp_uncoordinated_sweep", sweep)
    jcommon.ROWS.clear()
    pcommon.ROWS.clear()
    jfig4.run(quick=True)
    pfig4.run(quick=True, device="cpu")
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) == 11
    assert pcommon.ROWS == jcommon.ROWS and len(pcommon.ROWS) == 13


# ------------------------------------------------------------------ CLI
@pytest.mark.parametrize("extra", [[], ["--estimate-mode", "alpha"], ["--estimate-mode", "degree"], ["--leaderless"]])
def test_cli_uncoordinated_init_on_cpu(extra, capsys):
    hist = cli.main([
        "--model", "mlp", "--device", "cpu", "--nodes", "8", "--topology", "kregular", "--rounds", "2",
        "--items-per-node", "32", "--local-batches", "1", "--uncoordinated-init", "--estimate-rounds", "6",
        "--link-p", "0.9", *extra,
    ])
    assert hist["round"] == [0, 1] and all(np.isfinite(hist[k]).all() for k in KEYS)
    out = capsys.readouterr().out
    assert "gossip gains: mean=" in out
    assert ("reached 8 of 8 nodes" in out) == ("--leaderless" not in extra)


RING_1024_MAX_GAIN = 43046700.0  # the JAX package's leader gains at ring-1024, 32 + 32 rounds


def test_ring1024_leader_gains_match_jax_and_the_frontier_diverges():
    """The CLI's ring-1024 ``--uncoordinated-init --estimate-rounds 32``
    estimation (no failures, so no draws) in both packages: 65 nodes
    reached, the other 959 at gain 1.0, the frontier's gain 43,046,700.
    One node initialised at that gain with the full-width MLP, then one
    SGD(1e-3) step on a 16-item batch: the loss goes from ~1e31 to NaN in
    both packages, so the CLI's losses go NaN in both.  (A JAX CLI run at
    1024 nodes of the full-width MLP is too large for a CPU test.)"""
    k_est = jax.random.split(jax.random.PRNGKey(0))[0]
    gj = np.asarray(JG.make_gain_estimator(JC.compile_plan(JT.ring(1024)), pi_rounds=32, ps_rounds=32)(k_est))
    est = make_gain_estimator(PC.compile_plan(PT.ring(1024), device="cpu"), pi_rounds=32, ps_rounds=32)
    gp = est(split_seed(0, 2)[0]).numpy()
    np.testing.assert_allclose(gp, gj, rtol=1e-5)
    assert int(est.reached.sum()) == 65 and int((gj == 1.0).sum()) == int((gp == 1.0).sum()) == 1024 - 65
    np.testing.assert_allclose([gj.max(), gp.max()], RING_1024_MAX_GAIN, rtol=1e-5)

    ds = mnist_like(16, seed=0)
    jb = (jax.numpy.asarray(ds.x[:16]), jax.numpy.asarray(ds.y[:16]))
    pj = JPM.init_mlp(JInitConfig("he_normal", RING_1024_MAX_GAIN), jax.random.PRNGKey(0))
    l0, grads = jax.value_and_grad(jax_loss)(pj, jb)
    l1 = jax_loss(jax.tree_util.tree_map(lambda a, b: a - 1e-3 * b, pj, grads), jb)
    pb = (torch.as_tensor(ds.x[:16]), torch.as_tensor(ds.y[:16]))
    pp = PPM.init_mlp(InitConfig("he_normal", RING_1024_MAX_GAIN), torch.Generator().manual_seed(0))
    leaves = [p for layer in pp.values() for p in layer.values()]
    for p in leaves:
        p.requires_grad_(True)
    m0 = torch_loss(pp, pb)
    m0.backward()
    with torch.no_grad():
        for p in leaves:
            p -= 1e-3 * p.grad
        m1 = torch_loss(pp, pb)
    assert float(l0) > 1e30 and float(m0.detach()) > 1e30
    assert not math.isfinite(float(l1)) and not math.isfinite(float(m1))


def test_cli_uncoordinated_init_refusals(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--uncoordinated-init", "--no-gain-correction"])
    assert "contradicts --no-gain-correction" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--uncoordinated-init", "--estimate-mode", "degree", "--async"])
    assert "degree polling needs the round-based walker" in capsys.readouterr().err


# ------------------------------------------------------- examples, bench
def test_uncoordinated_example_runs(monkeypatch, capsys):
    """1 of its 40 rounds and its converged budget only (chip_smoke.py runs
    it whole on the card)."""
    monkeypatch.setattr(uncoordinated_init, "ROUNDS", 1)
    monkeypatch.setattr(uncoordinated_init, "BUDGETS", {"converged budget (32 rounds)": 32})
    out = uncoordinated_init.run(device="cpu")
    labels = ["converged budget (32 rounds)", "perfect knowledge", "He baseline (no correction)"]
    assert [k for k in out if k != "report"] == labels
    for label in labels:
        hist, gains = out[label]
        assert hist["round"] == [0] and np.isfinite(hist["test_loss"]).all() and gains.shape == (16,)
    converged = out["converged budget (32 rounds)"][1]
    assert np.abs(converged / 4.0 - 1).max() < 0.1  # kreg-16: ‖v_steady‖⁻¹ = 4
    report = out["report"]
    assert 0 < report["rounds_to_1pct"] < 64 and math.isfinite(report["fitted_rate"])
    assert "converged budget" in capsys.readouterr().out


def test_failure_resilience_example_runs(monkeypatch, capsys):
    for name, value in (("N", 4), ("ROUNDS", 2), ("PS", (0.5,))):
        monkeypatch.setattr(failure_resilience, name, value)
    out = failure_resilience.run(device="cpu")
    assert sorted(out) == [("link", 0.5), ("node", 0.5)]
    assert all(math.isfinite(v) for finals in out.values() for v in finals.values())
    assert "proposed final" in capsys.readouterr().out


def test_estimates_bench_writes_its_own_json(monkeypatch, tmp_path):
    monkeypatch.setattr(estimates_bench, "BLOCK", 4)
    monkeypatch.setattr(estimates_bench, "FAMILIES", {"kreg": estimates_bench.FAMILIES["kreg"]})
    out = tmp_path / "est.json"
    result = estimates_bench.run(ns=(16,), out_path=out, device="cpu")
    assert json.loads(out.read_text()) == result
    (row,) = result["records"]
    assert row["family"] == "kreg" and row["n"] == 16 and row["rounds_block"] == 4
    assert all(row[k] > 0 for k in ("us_dense", "us_sparse", "us_pi_dense", "us_pi_sparse"))


def test_uncoordinated_entry_points_default_to_cuda():
    """Without ``device`` (``--device``) the entry points ask for the card,
    and on a host without one they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    g = PT.random_k_regular(8, 4, seed=0)
    calls = (
        lambda: cli.main(["--model", "mlp", "--nodes", "8", "--topology", "kregular", "--uncoordinated-init"]),
        lambda: make_gain_estimator(g, pi_rounds=2, ps_rounds=2),
        lambda: pcommon.run_dfl_mlp_uncoordinated(n_nodes=8, est_rounds=2, graph=g, rounds=1),
        lambda: PF.run_warmup_trajectory(0, None, None, None, None, n_nodes=8, init_one=init_one,
                                         optimizer=PO.sgd(1e-3), estimate_gains=lambda s: torch.ones(8), n_rounds=1),
        lambda: pfig4.run(quick=True),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
