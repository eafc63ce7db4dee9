"""The figure drivers and examples of the port against the JAX package's.

``run_dfl_mlp`` / ``run_dfl_mlp_sweep`` run from one injected state on each
side (the driver's ``init_fl_state`` monkeypatched to a numpy-seeded He
draw): the same history keys and rounds, losses and σ to rtol 1e-4 / atol
1e-5 (the trajectory tolerance of ``test_torch_trainer.py``), the wire
channels equal.  The figure drivers that train (figs 1, 2, 6, 7) are held
call for call: both sides' ``run_dfl_mlp`` / ``run_dfl_mlp_sweep`` replaced
by one recorder, the recorded arguments and the emitted CSV rows must be
equal.  Fig. 3 runs both sides from one injected state with the diffusion
model stubbed (``test_torch_diffusion.py`` holds it), its rows to their
printed precision; fig. 5 (numpy only) runs both sides whole, its rows
equal.  The examples run on the CPU at their own sizes (topology_study for
2 rounds)."""
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig1_scaling as jfig1  # noqa: E402
from benchmarks import fig2_failures as jfig2  # noqa: E402
from benchmarks import fig3_dynamics as jfig3  # noqa: E402
from benchmarks import fig5_vsteady as jfig5  # noqa: E402
from benchmarks import fig6_env as jfig6  # noqa: E402
from benchmarks import fig7_constant_data as jfig7  # noqa: E402
from repro import fed as JF  # noqa: E402
from repro.core import diffusion as JDiff  # noqa: E402
from repro.core import mixing as JM  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro_torch.benchmarks import common as pcommon  # noqa: E402
from repro_torch.benchmarks import fig1_scaling as pfig1  # noqa: E402
from repro_torch.benchmarks import fig2_failures as pfig2  # noqa: E402
from repro_torch.benchmarks import fig3_dynamics as pfig3  # noqa: E402
from repro_torch.benchmarks import fig5_vsteady as pfig5  # noqa: E402
from repro_torch.benchmarks import fig6_env as pfig6  # noqa: E402
from repro_torch.benchmarks import fig7_constant_data as pfig7  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.core import diffusion as PDiff  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core import commplan as commplan_mod  # noqa: E402
from repro_torch.core.commplan import FailureModel, compile_plan  # noqa: E402
from repro.core.commplan import FailureModel as jax_failure_model  # noqa: E402
from repro.core.commplan import compile_plan as jax_compile_plan  # noqa: E402
from repro_torch.examples import quickstart, topology_study  # noqa: E402

HIDDEN = (128, 64)
KEYS = ("train_loss", "test_loss", "sigma_ap", "sigma_an")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU products run fastest on one thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mlp_np(n, gain, seed=0):
    rng = np.random.default_rng(seed)
    dims = (784, *HIDDEN, 10)
    return {
        f"fc{i}": {
            "w": (rng.standard_normal((n, a, b)) * np.sqrt(2.0 / a) * gain).astype(np.float32),
            "b": np.zeros((n, b), np.float32),
        }
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
    }


@pytest.fixture
def injected(monkeypatch):
    """Both drivers' ``init_fl_state`` draw the same numpy He ensemble; the
    JAX side takes its gains from ``gains`` in call order (its ``init_one``
    closes over the gain), the port side from its ``gains`` argument."""
    gains: list[float] = []

    def fake_j(key, n, init_one=None, optimizer=None):
        params = jax.tree_util.tree_map(jnp.asarray, _mlp_np(n, gains.pop(0)))
        return JF.DFLState(params=params, opt_state=jax.vmap(optimizer.init)(params),
                           round=jnp.zeros((), jnp.int32), rng=key)

    def fake_t(seed, n, init_one, optimizer, gains=1.0, device=None):
        return state_from_numpy(_mlp_np(n, float(gains)), optimizer=optimizer, device=device)

    for mod in (jcommon, jfig3):
        monkeypatch.setattr(mod, "init_fl_state", fake_j)
    for mod in (pcommon, pfig3):
        monkeypatch.setattr(mod, "init_fl_state", fake_t)
    return gains


def _same_history(h_t, h_j):
    assert sorted(h_t) == sorted(h_j)
    assert h_t["round"] == h_j["round"]
    for k in KEYS:
        np.testing.assert_allclose(h_t[k], h_j[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("wire_messages", "wire_bytes"):
        assert h_t.get(k) == h_j.get(k), k


SMALL = dict(n_nodes=4, rounds=3, per_node=32, batch_size=8, eval_every=1, test_size=64)


@pytest.mark.parametrize("executor", [True, False], ids=["run_trajectory", "train_loop"])
def test_run_dfl_mlp_matches_jax(injected, executor):
    injected.append(2.0)
    h_j, _ = jcommon.run_dfl_mlp(track_sigmas=True, gain=2.0, executor=executor, **SMALL)
    h_t, spr = pcommon.run_dfl_mlp(track_sigmas=True, gain=2.0, executor=executor, device="cpu", **SMALL)
    _same_history(h_t, h_j)
    assert h_t["round"] == [0, 1, 2] and spr > 0


def _inject_draws(monkeypatch, masks):
    """The port's failure draws become ``masks[i]`` (edge_keep, node_active),
    i the order in which the generator states are first seen: a round's
    draw and its wire count's replay (a copy of the generator taken before
    the round) get the same masks."""
    seen = {}

    def fake(failures, width, n, generator):
        i = seen.setdefault(bytes(generator.get_state().numpy()), len(seen))
        torch.rand(1, generator=generator)  # advance the stream: the next round is another draw
        return masks[i]

    monkeypatch.setattr(commplan_mod, "_draw_failure_masks", fake)


def test_run_dfl_mlp_on_a_graph_and_a_plan(monkeypatch, injected):
    g = PT.ring(4)
    injected.append(1.0)
    h_j, _ = jcommon.run_dfl_mlp(graph=JT.ring(4), gain=1.0, **SMALL)
    h_t, _ = pcommon.run_dfl_mlp(graph=g, gain=1.0, device="cpu", **SMALL)
    _same_history(h_t, h_j)
    # a compiled plan overrides the operator; it carries its own settings
    h_p, _ = pcommon.run_dfl_mlp(graph=g, plan=compile_plan(g, "sparse", device="cpu"), gain=1.0, device="cpu",
                                 **SMALL)
    _same_history(h_p, h_j)
    # link_p on a compiled plan overrides its failure model (make_round_fn
    # recompiles it, as the JAX package's does): held on the JAX run's own
    # draws, replayed from its key stream and injected into the port's rounds
    gj = JT.ring(4)
    fm = jax_failure_model(0.5)
    masks, rng = [], jax.random.PRNGKey(0)
    for _ in range(SMALL["rounds"]):
        rng, k_mix = jax.random.split(rng)
        ek, na = jax_compile_plan(gj, failures=fm).round_masks(k_mix)
        masks.append((torch.as_tensor(np.array(ek)), torch.as_tensor(np.array(na))))
    injected.append(1.0)
    h_j, _ = jcommon.run_dfl_mlp(graph=gj, plan=jax_compile_plan(gj), link_p=0.5, gain=1.0, **SMALL)
    _inject_draws(monkeypatch, masks)
    h_f, _ = pcommon.run_dfl_mlp(graph=g, plan=compile_plan(g, device="cpu"), link_p=0.5, gain=1.0, device="cpu",
                                 **SMALL)
    _same_history(h_f, h_j)
    assert h_f["wire_messages"] == h_j["wire_messages"] and min(h_f["wire_messages"]) < 8


def test_run_dfl_mlp_sweep_matches_jax(injected):
    gains = [1.0, 2.0]
    injected.extend(gains)
    kw = dict(n_nodes=4, gains=gains, rounds=3, per_node=32, batch_size=8, eval_every=2, test_size=64)
    grid_j, _ = jcommon.run_dfl_mlp_sweep(**kw)
    grid_t, _ = pcommon.run_dfl_mlp_sweep(device="cpu", **kw)
    assert len(grid_t) == 2 and all(len(row) == 1 for row in grid_t)
    for row_t, row_j in zip(grid_t, grid_j):
        _same_history(row_t[0], row_j[0])
    assert grid_t[0][0]["round"] == [0, 2]


def test_isolated_node_and_refusals(injected):
    """aggregate=False: one node, local steps only, its momentum carried
    across rounds (no aggregation, so no re-initialisation), as the JAX
    round function without aggregation."""
    kw = dict(n_nodes=1, rounds=3, per_node=64, batch_size=8, eval_every=1, test_size=64, aggregate=False, gain=1.0)
    injected.append(1.0)
    h_j, _ = jcommon.run_dfl_mlp(**kw)
    h_t, _ = pcommon.run_dfl_mlp(device="cpu", **kw)
    _same_history(h_t, h_j)
    assert "wire_messages" not in h_t
    with pytest.raises(ValueError, match="n_nodes must be 1"):
        pcommon.run_dfl_mlp(n_nodes=2, aggregate=False, device="cpu")
    # timing=True (ported): the chunked run's history is the JAX package's,
    # and the split has the JAX driver's three keys
    kw = {**SMALL, "rounds": 8}
    injected.append(1.0)
    h_j, t_j = jcommon.run_dfl_mlp(gain=1.0, timing=True, **kw)
    h_t, t_t = pcommon.run_dfl_mlp(gain=1.0, timing=True, device="cpu", **kw)
    _same_history(h_t, h_j)
    assert sorted(t_t) == sorted(t_j) == ["compile_seconds", "sec_per_round", "us_per_round_steady"]
    assert t_t["us_per_round_steady"] > 0 and t_t["compile_seconds"] >= 0
    with pytest.raises(ValueError, match="executor"):
        pcommon.run_dfl_mlp(n_nodes=2, timing=True, executor=False, device="cpu")


def test_wire_messages_replay_the_failure_draws(injected):
    """Under failures each recorded round counts the messages its mix
    delivered: two a surviving edge, from the same draws (held against the
    round's operator, rebuilt from a copy of the generator)."""
    injected.append(2.0)
    h, _ = pcommon.run_dfl_mlp(link_p=0.5, node_p=0.9, device="cpu", **{**SMALL, "rounds": 8})
    assert len(h["wire_messages"]) == 8 and all(0 <= m <= 12 for m in h["wire_messages"])
    assert h["wire_bytes"] == [m * 4 * 109_386 for m in h["wire_messages"]]
    plan = compile_plan(PT.complete(6), failures=FailureModel(0.5, 0.8), device="cpu")
    g = torch.Generator().manual_seed(3)
    for _ in range(5):
        before = torch.Generator().set_state(g.get_state())
        op = plan.round_operator(g)
        live = int(((op > 0) & ~torch.eye(6, dtype=torch.bool)).sum())
        assert int(plan.wire_messages(before)) == live


def test_rounds_to_loss_bitwise():
    hists = [
        {"round": [0, 4, 8, 12], "test_loss": [2.31, 2.30, 2.24, 1.9]},
        {"round": [0, 4], "test_loss": [2.31, 2.30]},
        {"round": [], "test_loss": []},
    ]
    for h in hists:
        for thr in (2.25, 2.305, 1.0):
            assert pcommon.rounds_to_loss(h, thr) == jcommon.rounds_to_loss(h, thr)


# ------------------------------------------------------------ figure drivers
def _norm(kwargs):
    """A driver call's arguments, comparable across the two packages."""
    out = {}
    for k, v in kwargs.items():
        if k == "device":
            continue
        if isinstance(v, (JT.Graph, PT.Graph)):
            v = (v.name, v.adjacency.tobytes())
        out[k] = v
    return out


def _fake_hist(kwargs, rounds, eval_every, plateau=0):
    """A made-up history, a function of the call's arguments only."""
    r = list(range(0, rounds, eval_every))
    level = 1.0 + zlib.crc32(repr(sorted(_norm(kwargs).items())).encode()) % 1000 / 1000
    return {"round": r, "test_loss": [2.31 if x < plateau else level for x in r]}


def _recorders(monkeypatch, j_mod, t_mod, name):
    calls = {"jax": [], "torch": []}

    def make(side):
        def rec(**kw):
            calls[side].append(_norm(kw))
            if name == "run_dfl_mlp_sweep":
                n = kw["n_nodes"]
                grid = [[_fake_hist({**kw, "gain": g}, kw["rounds"], kw["eval_every"],
                                    plateau=10 * n if g == 1.0 else 0)] for g in kw["gains"]]
                return grid, 0.125
            return _fake_hist(kw, kw.get("rounds", 60), kw.get("eval_every", 5)), 0.0625

        return rec

    monkeypatch.setattr(j_mod, name, make("jax"))
    monkeypatch.setattr(t_mod, name, make("torch"))
    return calls


@pytest.mark.parametrize("fig", ["fig1", "fig2", "fig6", "fig7"])
def test_training_figures_call_for_call(monkeypatch, fig):
    j_mod, t_mod, name = {
        "fig1": (jfig1, pfig1, "run_dfl_mlp_sweep"),
        "fig2": (jfig2, pfig2, "run_dfl_mlp"),
        "fig6": (jfig6, pfig6, "run_dfl_mlp"),
        "fig7": (jfig7, pfig7, "run_dfl_mlp"),
    }[fig]
    calls = _recorders(monkeypatch, j_mod, t_mod, name)
    jcommon.ROWS.clear()
    pcommon.ROWS.clear()
    j_mod.run(quick=True)
    t_mod.run(quick=True, device="cpu")
    assert calls["torch"] == calls["jax"] and calls["torch"]
    assert pcommon.ROWS == jcommon.ROWS and pcommon.ROWS


def test_fig5_rows_equal():
    jcommon.ROWS.clear()
    pcommon.ROWS.clear()
    jfig5.run(quick=True)
    pfig5.run(quick=True)
    strip = lambda rows: [(r.split(",")[0], r.split(",", 2)[2]) for r in rows]  # noqa: E731
    assert strip(pcommon.ROWS) == strip(jcommon.ROWS) and len(pcommon.ROWS) == 6


def _derived(rows):
    out = {}
    for row in rows:
        name, _, derived = row.split(",", 2)
        for item in derived.split(";"):
            k, v = item.split("=")
            out[f"{name}.{k}"] = v
    return out


def test_fig3_rows_match_jax(monkeypatch, injected):
    """The ANN panels from one injected He ensemble (32 nodes on the
    driver's random 8-regular graph, 40 rounds); the numerical model
    stubbed on both sides."""
    injected.append(1.0)
    stub = dict(sigma_an=np.array([1.0, 2e-4]), sigma_ap=np.array([1.0, 0.1768]), sigma_ap_prediction=0.1768,
                v_steady_norm=0.1768)
    monkeypatch.setattr(jfig3, "run_diffusion", lambda *a, **k: JDiff.DiffusionResult(**stub))
    monkeypatch.setattr(pfig3, "run_diffusion", lambda *a, **k: PDiff.DiffusionResult(**stub))
    jcommon.ROWS.clear()
    pcommon.ROWS.clear()
    jfig3.run(quick=True)
    pfig3.run(quick=True, device="cpu")
    got, want = _derived(pcommon.ROWS), _derived(jcommon.ROWS)
    assert sorted(got) == sorted(want) and len(pcommon.ROWS) == 3
    for k, v in want.items():
        digits = len(v.split(".")[1].split("e")[0]) if "." in v else 0
        exp = int(v.split("e")[1]) if "e" in v else 0
        resolution = 10.0 ** (exp - digits)  # one unit of the printed last digit
        assert math.isclose(float(got[k]), float(v), rel_tol=1e-4, abs_tol=resolution), (k, got[k], v)


# ------------------------------------------------------------------ examples
def test_quickstart_runs(monkeypatch, capsys):
    """6 of its 40 rounds (chip_smoke.py runs all 40 on the card and holds
    the plateau and the descent): He starts on the ln 10 plateau."""
    monkeypatch.setattr(quickstart, "ROUNDS", 6)
    gain, hists = quickstart.run(device="cpu")
    assert gain == pytest.approx(4.0)
    assert hists[0]["round"] == hists[1]["round"] == [0, 5]
    assert all(abs(v - math.log(10)) < 0.05 for v in hists[0]["test_loss"])
    assert all(np.isfinite(h[k]).all() for h in hists for k in ("train_loss", "test_loss"))
    assert "plateau" in capsys.readouterr().out


def test_topology_study_numbers(monkeypatch, capsys):
    monkeypatch.setattr(topology_study, "ROUNDS", 2)
    rows = topology_study.main(["--device", "cpu"])
    j_graphs = {"complete": JT.complete(16), "4-regular": JT.random_k_regular(16, 4, seed=0),
                "barabasi-albert m=4": JT.barabasi_albert(16, 4, seed=0), "ring": JT.ring(16),
                "torus 4x4": JT.torus_lattice((4, 4))}
    assert list(rows) == list(j_graphs)
    for name, g in j_graphs.items():
        assert rows[name]["gap"] == JM.spectral_gap(g) and rows[name]["t_mix"] == JM.mixing_time_estimate(g)
        assert rows[name]["vnorm"] == JM.v_steady_norm(g) and np.isfinite(rows[name]["final"])
    assert "torus 4x4" in capsys.readouterr().out
