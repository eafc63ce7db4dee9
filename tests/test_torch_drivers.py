"""The port's measurement drivers against the JAX package's: fig12
(``benchmarks/fig12_compress.py``), the kernel benchmarks
(``benchmarks/kernels_bench.py``) and the harness (``benchmarks/run.py``).

fig12 call for call: both packages' ``run_dfl_mlp`` replaced by one
recorder (the same arguments, the same made-up histories), so the codec
table, the sweep's calls and every derived record field must agree; the
transformer trajectory with both ``run_trajectory`` replaced by a recorder:
the token windows and the batch schedule bitwise, the same codecs and
executor arguments, the same records.  A real 2-round transformer record
of the port has the JAX keys and the wire bytes of the JAX package's
``BENCH_compress.json`` (shapes only, no draws).  The JAX ``fig12.run()``
is never called, nor ``run_mixing`` without an ``out_path`` in a
temporary directory: both write ``BENCH_*.json`` at the repository root.
"""
import dataclasses
import json
import pathlib
import zlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig12_compress as jfig12  # noqa: E402
from benchmarks import kernels_bench as jkb  # noqa: E402
from benchmarks import run as jrun  # noqa: E402
from repro.core import commplan as JCP  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro_torch.benchmarks import common as pcommon  # noqa: E402
from repro_torch.benchmarks import fig12_compress as pfig12  # noqa: E402
from repro_torch.benchmarks import kernels_bench as pkb  # noqa: E402
from repro_torch.benchmarks import run as prun  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def setup_module(module):
    torch.set_num_threads(1)


def _codec(comp):
    return None if comp is None else dataclasses.asdict(comp)


def _norm(kwargs):
    out = {}
    for k, v in kwargs.items():
        if k == "device":
            continue
        if isinstance(v, (JT.Graph, PT.Graph)):
            v = (v.name, v.adjacency.tobytes())
        elif k == "compression":
            v = _codec(v)
        out[k] = v
    return out


def _fake_codec_run(kw):
    """A made-up (history, timing) of one ``run_dfl_mlp(timing=True)``
    call, a function of its arguments only."""
    h = zlib.crc32(repr(sorted(_norm(kw).items())).encode())
    codec = (kw.get("compression").codec if kw.get("compression") is not None else "none")
    wire = {"none": 4000, "int8": 1002, "fp8": 1002, "topk": 600, "qtopk": 900}[codec] * kw["n_nodes"]
    rounds = list(range(0, kw["rounds"], kw["eval_every"]))
    hist = {"round": rounds, "test_loss": [1.0 + h % 100 / 1000 for _ in rounds], "wire_bytes": [wire] * kw["rounds"]}
    return hist, {"sec_per_round": 0.5, "compile_seconds": h % 7 / 8, "us_per_round_steady": float(h % 1000)}


def test_fig12_codec_sweep_call_for_call(monkeypatch):
    assert {k: _codec(v) for k, v in pfig12.CODECS.items()} == {k: _codec(v) for k, v in jfig12.CODECS.items()}
    calls = {"jax": [], "torch": []}

    def recorder(side):
        def rec(**kw):
            calls[side].append(_norm(kw))
            return _fake_codec_run(kw)

        return rec

    monkeypatch.setattr(jfig12, "run_dfl_mlp", recorder("jax"))
    monkeypatch.setattr(pfig12, "run_dfl_mlp", recorder("torch"))
    jcommon.ROWS.clear()
    pcommon.ROWS.clear()
    want = jfig12._fig1_codec_records(True)
    got = pfig12._fig1_codec_records(True, device="cpu")
    assert calls["torch"] == calls["jax"] and len(calls["torch"]) == 10
    assert got == want
    assert pcommon.ROWS == jcommon.ROWS


def test_fig12_transformer_records_call_for_call(monkeypatch):
    """The transformer trajectory's inputs bitwise and its records, both
    executors replaced by one recorder."""
    calls = {"jax": [], "torch": []}

    def fake_round_fn(side):
        def make(loss_fn, opt, graph, compression=None, **kw):
            calls[side].append(("round_fn", graph.name, _codec(compression)))
            return SimpleNamespace(codec=None if compression is None else compression.codec)

        return make

    def fake_run(side):
        def run_trajectory(state, rf, xs, ys, sched, **kw):
            eval_batch = tuple(np.asarray(a) for a in kw.pop("eval_batch"))
            kw = {k: v for k, v in kw.items() if k not in ("eval_fn", "on_chunk", "device")}
            calls[side].append(("run", np.asarray(xs), np.asarray(ys), np.asarray(sched), eval_batch, kw))
            r = list(range(0, kw["n_rounds"], kw["eval_every"]))
            wire = {None: 23_142_400, "int8": 5_797_248}[rf.codec]
            loss = {None: 6.25, "int8": 6.26}[rf.codec]
            return state, {"round": r, "test_loss": [loss] * len(r), "wire_bytes": [wire] * kw["n_rounds"]}

        return run_trajectory

    def jax_init(key, n, init_one, opt):
        return SimpleNamespace(params=jax.eval_shape(lambda k: jax.vmap(init_one)(jax.random.split(k, n)), key))

    monkeypatch.setattr(jfig12, "make_round_fn", fake_round_fn("jax"))
    monkeypatch.setattr(pfig12, "make_round_fn", fake_round_fn("torch"))
    monkeypatch.setattr(jfig12, "run_trajectory", fake_run("jax"))
    monkeypatch.setattr(pfig12, "run_trajectory", fake_run("torch"))
    monkeypatch.setattr(jfig12, "init_fl_state", jax_init)
    want = jfig12._transformer_records(True)
    got = pfig12._transformer_records(True, device="cpu")
    assert len(calls["torch"]) == len(calls["jax"]) == 4
    for a, b in zip(calls["torch"], calls["jax"]):
        assert a[0] == b[0]
        if a[0] == "round_fn":
            assert a == b
            continue
        for x, y in zip(a[1:4], b[1:4]):  # xs, ys, the schedule
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a[4], b[4]))  # the held-out batch
        assert a[5] == b[5]
    assert [r["params_per_node"] for r in got] == [361_600] * 2
    drop = ("sec_per_round",)  # wall clock
    assert [{k: v for k, v in r.items() if k not in drop} for r in got] == \
           [{k: v for k, v in r.items() if k not in drop} for r in want]


def test_fig12_transformer_record_has_the_jax_keys_and_wire_bytes(tmp_path):
    """Two real rounds of the port's transformer trajectory on the CPU:
    the records' keys, and the wire bytes and reduction the JAX package
    recorded in ``BENCH_compress.json`` (they depend on shapes only)."""
    bench = json.loads((ROOT / "BENCH_compress.json").read_text())
    want = {r["codec"]: r for r in bench["records"] if r["kind"] == "transformer"}
    got = pfig12._transformer_records(True, device="cpu", rounds=2)
    assert [r["codec"] for r in got] == ["none", "int8"]
    for r in got:
        assert sorted(r) == sorted(want[r["codec"]])
        assert r["wire_bytes_per_round"] == want[r["codec"]]["wire_bytes_per_round"]
        assert r["bytes_reduction_vs_fp32"] == pytest.approx(want[r["codec"]]["bytes_reduction_vs_fp32"], rel=1e-12)
        assert r["params_per_node"] == want[r["codec"]]["params_per_node"] and r["rounds"] == 2
        assert np.isfinite(r["curve_test_loss"]).all() and r["curve_round"] == [0, 1]


def test_fig12_run_writes_under_build(monkeypatch, tmp_path):
    monkeypatch.setattr(pfig12, "run_dfl_mlp", lambda **kw: _fake_codec_run(kw))
    monkeypatch.setattr(pfig12, "_transformer_records", lambda quick, device=None: [])
    out = pfig12.run(device="cpu", out_path=tmp_path / "build" / "fig12.json")
    disk = json.loads((tmp_path / "build" / "fig12.json").read_text())
    assert disk["device"] == "cpu" and disk["quick"] is True and len(disk["records"]) == 10
    assert sorted(disk) == sorted(json.loads((ROOT / "BENCH_compress.json").read_text())) == sorted(out)
    assert pcommon.ROWS[-1].startswith("fig12.acceptance,0.0,codecs_meeting_4x_2pct=")


# ------------------------------------------------------------ kernels_bench
def test_run_mixing_matches_jax_plan_mix(monkeypatch, tmp_path):
    """``run_mixing`` at n = 16, d = 64: every backend's round equals the
    JAX ``plan.mix`` of the same graph on the same input to fp32 rounding,
    and the JSON has the JAX driver's schema."""
    seen = []
    real_compile = pkb.compile_plan

    def recording_compile(graph, backend, **kw):
        plan = real_compile(graph, backend, **kw)
        real_mix = plan.mix

        def mix(params):
            out = real_mix(params)
            seen.append((graph, backend, params["w"].numpy().copy(), out["w"].numpy()))
            return out

        return SimpleNamespace(mix=mix)

    monkeypatch.setattr(pkb, "compile_plan", recording_compile)
    got = pkb.run_mixing(ns=(16,), d=64, iters=1, out_path=tmp_path / "p.json", device="cpu")
    assert {(g.name, b) for g, b, _, _ in seen} == {(pkb._MIX_FAMILIES[f](16).name, b) for f in pkb._MIX_FAMILIES
                                                    for b in ("dense", "sparse", "ppermute")}
    for graph, backend, w, out in seen:
        jg = jkb._MIX_FAMILIES[_family_of(graph)](16)
        assert np.array_equal(np.asarray(jg.adjacency), graph.adjacency)
        want = np.asarray(jax.jit(JCP.compile_plan(jg, backend).mix)({"w": jnp.asarray(w)})["w"])
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    want = jkb.run_mixing(ns=(16,), d=64, iters=1, out_path=tmp_path / "j.json")
    assert sorted(got) == sorted(want) and json.loads((tmp_path / "p.json").read_text()).keys() == want.keys()
    for a, b in zip(got["records"], want["records"]):
        assert sorted(a) == sorted(b)
        assert {k: a[k] for k in ("family", "n", "d", "n_edges")} == {k: b[k] for k in ("family", "n", "d", "n_edges")}
        assert a["mean_degree"] == pytest.approx(b["mean_degree"])


def _family_of(graph):
    for family, build in pkb._MIX_FAMILIES.items():
        g = build(graph.n)
        if g.name == graph.name and np.array_equal(g.adjacency, graph.adjacency):
            return family
    raise KeyError(graph.name)


def test_kernels_run_rows_on_cpu():
    """The JAX driver's four rows; on the CPU every wrapper runs its plain
    version, so each error against it is 0."""
    pcommon.ROWS.clear()
    rows = pkb.run(quick=True, device="cpu")
    assert list(rows) == ["kernels.mix", "kernels.flash", "kernels.flash_swa", "kernels.rwkv6"]
    assert [r.split(",")[0] for r in pcommon.ROWS] == list(rows)
    assert [r["route"] for r in rows.values()] == ["wide", "wgmma_tf32x3", "wgmma_tf32x3", "tc_fp32"]
    for r in rows.values():
        assert r["max_abs_err"] == 0.0 and r["gflops"] > 0 and r["ref_scale"] > 0


# ------------------------------------------------------------------ run.py
def test_run_modules_are_the_jax_harness_names():
    """Every module of the JAX harness is ported, ``roofline`` included."""
    assert set(prun.MODULES) == set(jrun.MODULES)
    assert not hasattr(prun, "NOT_PORTED")


@pytest.mark.parametrize("argv,what", [
    (["--full", "--quick"], "mutually exclusive"),
    (["fig1", "--only", "fig2"], "not both"),
    (["fig99"], "unknown modules"),
])
def test_run_flag_errors_and_refusals(argv, what, capsys):
    with pytest.raises(SystemExit) as exc:
        prun.main([*argv, "--device", "cpu"])
    assert exc.value.code == 2
    assert what in capsys.readouterr().err


@pytest.mark.parametrize("argv,with_record", [(["roofline"], False), (["--only", "roofline"], True)])
def test_run_roofline_reads_build_dryrun(argv, with_record, monkeypatch, tmp_path, capsys):
    """``roofline`` runs (no refusal) and reads the dry run's records under
    build/dryrun of the working directory: a note without records, else
    one row a record and the summary; exit 0 either way."""
    from repro_torch.benchmarks import roofline_report

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(roofline_report, "RESULTS_DIR", "build/dryrun")
    if with_record:
        (tmp_path / "build" / "dryrun").mkdir(parents=True)
        terms = {"dominant": "memory", "compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5}
        rec = {"arch": "qwen2.5-3b", "shape": "prefill_32k", "mesh": "pod16x16", "mixing": None,
               "status": "ok", "terms": terms, "useful_flops_ratio": 0.5, "wall_s": 1.0}
        (tmp_path / "build" / "dryrun" / "a.json").write_text(json.dumps(rec))
        (tmp_path / "build" / "dryrun" / "b.json").write_text(json.dumps(
            {**rec, "mesh": "pod2x16x16", "status": "error", "error": "ValueError: x"}))
    prun.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    if with_record:
        assert "roofline.qwen2.5-3b.prefill_32k.pod16x16,1000000.0,dominant=memory;" in out
        assert "roofline.qwen2.5-3b.prefill_32k.pod2x16x16,0.0,ERROR=ValueError: x" in out
        assert "roofline.summary,0.0,ok=1;errors=1" in out
    else:
        assert "roofline.NOTE,0.0,no dry-run records in build/dryrun" in out


def test_run_fig10_writes_under_build(monkeypatch, tmp_path, capsys):
    """``fig10`` runs through the harness and writes build/fig10_scaling.json
    (here at one shard, in this process's world-size-1 gloo group, which
    the test destroys after)."""
    import functools

    import torch.distributed as dist

    from repro_torch.benchmarks import fig10_scaling as pfig10

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pfig10, "run", functools.partial(pfig10.run, shards=(1,)))
    try:
        prun.main(["fig10", "--device", "cpu"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    doc = json.loads((tmp_path / "build" / "fig10_scaling.json").read_text())
    assert [r["family"] for r in doc["records"]] == list(pfig10.FAMILIES)
    assert all(r["parity_bitexact"] and r["n_shards"] == 1 for r in doc["records"])
    assert "fig10.ring.S1" in capsys.readouterr().out


def test_run_failed_module_prints_failed_and_exits_1(monkeypatch, capsys):
    seen = []

    def boom(quick, device):
        raise RuntimeError("no card")

    def ok(quick, device):
        seen.append((quick, device))
        pcommon.emit("fine.row", 1.0, "x=1")

    monkeypatch.setattr(prun, "MODULES", {"boom": SimpleNamespace(run=boom), "fine": SimpleNamespace(run=ok)})
    with pytest.raises(SystemExit) as exc:
        prun.main(["--device", "cpu"])
    assert exc.value.code == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert "boom.FAILED,0.0,RuntimeError: no card" in out and "fine.row,1.0,x=1" in out
    assert seen == [(True, "cpu")]
    prun.main(["--full", "fine", "--device", "cpu"])  # no failure: returns
    assert seen[-1] == (False, "cpu")


def test_fig12_codec_wire_bytes_equal_the_jax_records(monkeypatch):
    """The codec sweep through the real ``run_dfl_mlp`` at 2 rounds a run:
    every codec's wire bytes a round and reduction against fp32 are the
    JAX package's in ``BENCH_compress.json`` (shapes and codecs only)."""
    real = pfig12.run_dfl_mlp
    monkeypatch.setattr(pfig12, "run_dfl_mlp", lambda **kw: real(**{**kw, "rounds": 2, "eval_every": 1}))
    bench = {(r["family"], r["codec"]): r for r in json.loads((ROOT / "BENCH_compress.json").read_text())["records"]
             if r["kind"] == "codec"}
    got = pfig12._fig1_codec_records(True, device="cpu")
    assert len(got) == len(bench) == 10
    for r in got:
        want = bench[(r["family"], r["codec"])]
        assert r["wire_bytes_per_round"] == want["wire_bytes_per_round"], (r["family"], r["codec"])
        assert r["bytes_reduction_vs_fp32"] == pytest.approx(want["bytes_reduction_vs_fp32"], rel=1e-12)
