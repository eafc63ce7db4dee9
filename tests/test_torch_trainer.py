"""The slice as a whole: the port's run_trajectory against the JAX package's
on the same injected init (a numpy-seeded He draw held as a JAX ``DFLState``,
whose leaves go through ``state_from_numpy``), the same data and the same
batch schedule.  History and final parameters to
rtol 1e-4 / atol 1e-5 — not bitwise: the two frameworks sum in different
orders (and the JAX package's own executor-vs-legacy bitwise asserts differ
by 1 ulp on jax 0.9.0)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import commplan as JC  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.initialisation import gain_from_graph  # noqa: E402
from repro.data import batch_index_schedule, mnist_like, node_batch_iterator, node_datasets  # noqa: E402
from repro import fed as JF  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro_torch import fed as PF  # noqa: E402
from repro_torch import optim as PO  # noqa: E402
from repro_torch.convert import state_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.initialisation import InitConfig  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import paper_models as PPM  # noqa: E402

PER_NODE, BS, B_LOCAL, ROUNDS, HIDDEN = 32, 8, 2, 3, (32, 16)
KEYS = ("train_loss", "test_loss", "sigma_ap", "sigma_an")

CASES = {
    # name: (graph constructor, backend, init gain corrected?).  The ring runs
    # the uncorrected He init: gain 4 there puts the first logits in the
    # hundreds, where softmax saturation amplifies fp32 summation-order
    # differences past 1e-4 within a round.  The optimizer is the paper's
    # SGD; AdamW is held step by step in test_torch_models (over whole rounds
    # its m/sqrt(v) turns last-ulp gradient differences near 0 into ±lr steps).
    "complete8-dense": (lambda T: T.complete(8), "dense", True),
    "ring16-sparse": (lambda T: T.ring(16), "sparse", False),
}


def jax_loss(p, b):
    return JPM.classifier_loss(JPM.mlp_forward(p, b[0]), b[1])


def torch_loss(p, b):
    return PPM.classifier_loss(PPM.mlp_forward(p, b[0]), b[1])


def _data(n):
    ds = mnist_like(n * PER_NODE + 64, seed=0)
    xs, ys = node_datasets(ds, [np.arange(i * PER_NODE, (i + 1) * PER_NODE) for i in range(n)])
    return xs, ys, (ds.x[-64:], ds.y[-64:])


def _jax_init(g, gain, opt_j):
    """He normal at ``gain`` drawn with numpy (JAX's eager ``init_fl_state``
    costs seconds a call here), with JAX's own optimizer init."""
    rng = np.random.default_rng(0)
    dims = (784, *HIDDEN, 10)
    params = {
        f"fc{i}": {
            "w": jnp.asarray((rng.standard_normal((g.n, a, b)) * np.sqrt(2.0 / a) * gain).astype(np.float32)),
            "b": jnp.zeros((g.n, b), jnp.float32),
        }
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
    }
    opt_state = jax.vmap(opt_j.init)(params)
    return JF.DFLState(params=params, opt_state=opt_state, round=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=sorted(CASES))
def both_runs(request):
    build, backend, corrected = CASES[request.param]
    gj, gp = build(JT), build(PT)
    gain = gain_from_graph(gj) if corrected else 1.0
    opt_j, opt_t = JO.sgd(1e-3, 0.5), PO.sgd(1e-3, 0.5)
    xs, ys, test = _data(gj.n)
    sched = batch_index_schedule(PER_NODE, gj.n, BS, ROUNDS * B_LOCAL, seed=0)
    common = dict(n_rounds=ROUNDS, eval_every=1, eval_batch=test, track_sigmas=True, b_local=B_LOCAL)
    s_j = _jax_init(gj, gain, opt_j)
    rf_j = JF.make_round_fn(jax_loss, opt_j, JC.compile_plan(gj, backend))
    fin_j, h_j = JF.run_trajectory(s_j, rf_j, xs, ys, sched, eval_fn=JF.make_eval_fn(jax_loss), **common)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    s_t = state_from_numpy(to_np(s_j.params), to_np(s_j.opt_state), device="cpu")
    plan = PC.compile_plan(gp, backend, device="cpu")
    rf_t = PF.make_round_fn(torch_loss, opt_t, plan)
    fin_t, h_t = PF.run_trajectory(
        s_t, rf_t, xs, ys, sched, eval_fn=PF.make_eval_fn(torch_loss), device="cpu", **common
    )
    return dict(
        jax=(to_np(fin_j.params), to_np(fin_j.opt_state), h_j), torch=(fin_t, h_t),
        init=s_t, round_fn=rf_t, data=(xs, ys, test, sched), gain=gain_from_graph(gj), opt=opt_t,
    )


def test_trajectory_matches_jax(both_runs):
    params_j, opt_j, h_j = both_runs["jax"]
    fin_t, h_t = both_runs["torch"]
    assert h_t["round"] == h_j["round"] == list(range(ROUNDS))
    assert sorted(h_t) == sorted(h_j)
    for k in KEYS:
        np.testing.assert_allclose(h_t[k], h_j[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert h_t["wire_messages"] == h_j["wire_messages"] and h_t["wire_bytes"] == h_j["wire_bytes"]
    params_t, opt_t = to_numpy(fin_t)
    for layer in params_j:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(params_t[layer][leaf], params_j[layer][leaf], rtol=1e-4, atol=1e-5)
    # optimizer state after the round's reinit (Algorithm 1 line 15)
    for name, value in zip(opt_t._fields, opt_t):
        want = getattr(opt_j, name)
        if isinstance(value, dict):
            for layer in value:
                for leaf in ("w", "b"):
                    np.testing.assert_array_equal(value[layer][leaf], want[layer][leaf])
        else:
            np.testing.assert_array_equal(value, want)
    assert fin_t.round == ROUNDS


def test_caller_state_untouched(both_runs):
    init = both_runs["init"]
    xs, ys, test, sched = both_runs["data"]
    before = init.params.clone()
    PF.run_trajectory(init, both_runs["round_fn"], xs, ys, sched, n_rounds=ROUNDS, b_local=B_LOCAL, device="cpu")
    assert torch.equal(init.params, before)


def test_sweep_equals_independent_runs(both_runs):
    xs, ys, test, sched = both_runs["data"]
    rf, opt = both_runs["round_fn"], both_runs["opt"]
    n = xs.shape[0]
    init_one = lambda g, gains: PPM.init_mlp(InitConfig("he_normal", gains), g, hidden=HIDDEN)  # noqa: E731
    states = [PF.init_fl_state(s, n, init_one, opt, gains=gn, device="cpu") for s, gn in ((0, 1.0), (1, both_runs["gain"]))]
    common = dict(n_rounds=ROUNDS, eval_every=2, eval_fn=PF.make_eval_fn(torch_loss), eval_batch=test,
                  track_sigmas=True, b_local=B_LOCAL, device="cpu")
    stacked, hists = PF.run_sweep(PF.stack_states(states), rf, xs, ys, sched, **common)
    for i, s in enumerate(states):
        fin, h = PF.run_trajectory(s, rf, xs, ys, sched, **common)
        # the sweep records no wire channels, as the JAX package's
        assert sorted(set(h) - set(hists[i])) == ["wire_bytes", "wire_messages"]
        assert {k: h[k] for k in hists[i]} == hists[i]
        assert torch.equal(fin.params, PF.unstack_states(stacked)[i].params)
    assert hists[0]["round"] == [0, 2]


def test_train_loop_equals_run_trajectory(both_runs):
    xs, ys, test, sched = both_runs["data"]
    rf, init = both_runs["round_fn"], both_runs["init"]

    def batches():
        it = node_batch_iterator(xs, ys, BS, seed=0)
        while True:
            bs = [next(it) for _ in range(B_LOCAL)]
            yield np.stack([b.x for b in bs], 1), np.stack([b.y for b in bs], 1)

    common = dict(eval_every=1, eval_fn=PF.make_eval_fn(torch_loss), eval_batch=test, track_sigmas=True, device="cpu")
    fin_l, h_l = PF.train_loop(init, rf, batches(), n_rounds=ROUNDS, **common)
    fin_r, h_r = PF.run_trajectory(init, rf, xs, ys, sched, n_rounds=ROUNDS, b_local=B_LOCAL, **common)
    # the executor adds the wire channels, as the JAX package's does; train_loop has none
    assert sorted(set(h_r) - set(h_l)) == ["wire_bytes", "wire_messages"]
    assert h_l == {k: h_r[k] for k in h_l}
    assert torch.equal(fin_l.params, fin_r.params)


def test_cli_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "hist.json"
    hist = cli.main([
        "--model", "mlp", "--device", "cpu", "--nodes", "4", "--rounds", "2",
        "--items-per-node", "64", "--local-batches", "2", "--history-out", str(out),
    ])
    assert hist["round"] == [0, 1]
    assert all(np.isfinite(hist[k]).all() for k in KEYS)
    assert json.loads(out.read_text()) == hist
    assert "gain=2.00" in capsys.readouterr().out
    hist = cli.main(["--device", "cpu", "--nodes", "80", "--rounds", "1", "--topology", "ring",
                     "--items-per-node", "16", "--local-batches", "1", "--no-gain-correction"])
    assert np.isfinite(hist["test_loss"]).all()


@pytest.mark.parametrize(
    "settings",
    [dict(link_p=0.7), dict(node_p=0.9), dict(data_sizes=np.linspace(1.0, 2.0, 8)), dict(device="cpu")],
)
def test_round_fn_settings_go_with_a_graph_only(settings):
    """A Graph is compiled from the settings; on a compiled plan they
    override its own (recompiled through ``with_options``, as the JAX
    package's ``make_round_fn`` does), and a device other than the plan's
    is refused."""
    g = PT.complete(8)
    rf = PF.make_round_fn(torch_loss, PO.sgd(1e-3), g, **{"device": "cpu", **settings})
    want = PC.compile_plan(
        g, data_sizes=settings.get("data_sizes"),
        failures=PC.FailureModel(settings.get("link_p", 1.0), settings.get("node_p", 1.0)), device="cpu",
    )
    assert rf.plan.failures == want.failures and rf.plan.backend == "dense"
    torch.testing.assert_close(rf.plan.receive, want.receive, atol=0, rtol=0)
    again = PC.compile_plan(g, device="cpu").with_options(data_sizes=want.data_sizes, failures=want.failures)
    assert again.failures == want.failures
    torch.testing.assert_close(again.receive, want.receive, atol=0, rtol=0)
    over = PF.make_round_fn(torch_loss, PO.sgd(1e-3), PC.compile_plan(g, device="cpu"), **settings)
    assert over.plan.failures == want.failures
    torch.testing.assert_close(over.plan.receive, want.receive, atol=0, rtol=0)
    with pytest.raises(ValueError, match="lies on"):
        PF.make_round_fn(torch_loss, PO.sgd(1e-3), want, **{**settings, "device": "meta"})


@pytest.mark.parametrize("argv", [["--arch", "jamba-1.5-large-398b", "--reduced"], ["--model", "rwkv"],
                                  ["--arch", "rwkv6-3b", "--reduced"]])
def test_cli_trains_mamba_and_rwkv(argv):
    """jamba's mamba blocks and RWKV training through the CLI, host-fed and
    through the executor at the topology and optimizer flags: 2 rounds of
    AdamW on a ring of 3, finite losses that the second round changes."""
    args = ["--device", "cpu", *argv, "--nodes", "3", "--topology", "ring", "--optimizer", "adamw", "--rounds", "2",
            "--local-batches", "1", "--batch-size", "2"]
    if argv[0] == "--model":
        args += ["--items-per-node", "8", "--seq-len", "16"]
    hist = cli.main(args)
    assert hist["round"] == [0, 1] and np.isfinite(hist["train_loss"]).all()
    assert hist["train_loss"][0] != hist["train_loss"][1]
