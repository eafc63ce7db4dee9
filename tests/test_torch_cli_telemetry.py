"""The port's CLIs with ``--telemetry`` / ``--profile-trace`` and the rest of
the training CLI (``--model transformer``, ``--arch --reduced``,
``--legacy-loop``, ``--seq-len``), on the CPU at a small size.

The run log of the port's training CLI holds the JAX CLI's record kinds,
keys and counts for the same arguments (MLP, kreg-8 at link_p 0.8, 3
rounds): the manifest carries the JAX package's keys (``jax_version``
null) and the port's own beside them, its config the JAX CLI's flags plus
``--device``; every other record's keys are the JAX log's exactly.  Values
are not compared here: the two CLIs draw their init and failures from
different generators (the trajectories are held in ``test_torch_trainer``).
Every log passes the JAX package's ``validate_run_log``."""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as j_cli  # noqa: E402
from repro.obs import export as JE  # noqa: E402
from repro.obs import validate_run_log as j_validate  # noqa: E402
from repro_torch.launch import serve as p_serve  # noqa: E402
from repro_torch.launch import train as p_cli  # noqa: E402
from repro_torch.obs import read_run_log, validate_run_log  # noqa: E402

SMALL = ["--model", "mlp", "--nodes", "8", "--rounds", "3", "--items-per-node", "32", "--local-batches", "1",
         "--topology", "kregular", "--link-p", "0.8"]
TINY = ["--nodes", "8", "--topology", "kregular", "--rounds", "3", "--items-per-node", "32", "--local-batches", "1",
        "--device", "cpu"]


def setup_module(module):
    torch.set_num_threads(1)


def _port_log(tmp_path, name, args):
    path = tmp_path / f"{name}.jsonl"
    hist = p_cli.main([*args, "--telemetry", str(path)])
    recs = read_run_log(path)
    assert validate_run_log(recs) == [] == j_validate(path)
    return hist, recs


@pytest.fixture(scope="module")
def jax_log(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "run.jsonl"
    argv = sys.argv
    sys.argv = ["train", *SMALL, "--telemetry", str(path)]
    try:
        j_cli.main()
    finally:
        sys.argv = argv
    return read_run_log(path)


def test_cli_telemetry_matches_the_jax_cli(jax_log, tmp_path):
    hist, recs = _port_log(tmp_path, "mlp", [*SMALL, "--device", "cpu"])
    assert [r["kind"] for r in recs] == [r["kind"] for r in jax_log] == \
        ["manifest", "round", "round", "round", "summary", "gossip_health"]
    man_p, man_j = recs[0], jax_log[0]
    assert set(man_j) <= set(man_p) and man_p["jax_version"] is None and man_j["jax_version"]
    assert set(man_p) - set(man_j) == {"torch_version", "cuda", "device_name"}
    assert set(man_p["config"]) - set(man_j["config"]) == {"device"} and set(man_j["config"]) <= set(man_p["config"])
    assert man_p["argv"][-2:] == ["--telemetry", str(tmp_path / "mlp.jsonl")]
    for a, b in zip(recs[1:], jax_log[1:]):
        assert sorted(a) == sorted(b), a["kind"]
    assert len(recs[-1]["mass_drift"]) == len(jax_log[-1]["mass_drift"]) == 17  # min(64, max(16, 2n)) + 1
    # the rows are the history, the summary its sums
    rows = recs[1:4]
    assert [r["round"] for r in rows] == hist["round"] == [0, 1, 2]
    assert [r["wire_messages"] for r in rows] == hist["wire_messages"]
    assert recs[4]["recorded_wire_messages"] == sum(hist["wire_messages"])
    assert recs[4]["recorded_wire_bytes"] == sum(hist["wire_bytes"])
    assert recs[4]["rounds_run"] == 3
    assert all(0 < r["wire_messages"] <= 2 * 16 for r in rows)  # kreg4-8: 16 edges, some lost at link_p 0.8


def test_profile_trace_holds_the_round_phases(tmp_path):
    out = tmp_path / "trace"
    p_cli.main([*TINY, "--rounds", "2", "--profile-trace", str(out)])
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    names = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
    assert names.count("dfl_local") == 2 and names.count("dfl_mix") == 2 and names.count("dfl_eval") == 2


@pytest.mark.parametrize("mode", ["async", "elastic", "schedule", "legacy", "int8"])
def test_cli_telemetry_paths(tmp_path, mode):
    extra = {
        "async": ["--async", "--link-p", "0.8"],
        "elastic": ["--join-nodes", "2", "--join-round", "1", "--join-warmup", "1", "--fault-scenario", "crash"],
        "schedule": ["--topology-schedule", "churn", "--plans", "2"],
        "legacy": ["--legacy-loop"],
        "int8": ["--compress", "int8"],
    }[mode]
    hist, recs = _port_log(tmp_path, mode, [*TINY, *extra])
    kinds = [r["kind"] for r in recs]
    row = "bin" if mode == "async" else "round"
    n_rows = 20 if mode == "async" else 3
    health = [] if mode == "schedule" else ["gossip_health"]  # a PlanSchedule gets no health record
    assert kinds == ["manifest", *[row] * n_rows, "summary", *health]
    if mode == "async":
        assert recs[-2]["recorded_wire_messages"] == sum(hist["messages"])
        assert all(r["wire_bytes"] == r["messages"] * (recs[1]["wire_bytes"] // max(recs[1]["messages"], 1))
                   for r in recs[1:-2] if r["messages"])
    elif mode == "legacy":
        assert "wire_messages" not in recs[1]  # train_loop records no wire channels, as the JAX loop
    else:
        assert [r["wire_messages"] for r in recs[1:4]] == hist["wire_messages"]
    if mode == "elastic":
        assert [r["n_active"] for r in recs[1:4]] == hist["n_active"]
    if mode == "int8":
        plain = _port_log(tmp_path, "plain", TINY)[0]
        assert hist["wire_messages"] == plain["wire_messages"]
        assert hist["wire_bytes"][0] * 3 < plain["wire_bytes"][0]  # priced by the codec


def test_transformer_and_arch_paths(tmp_path, capsys):
    hist, recs = _port_log(tmp_path, "lm", ["--model", "transformer", "--nodes", "2", "--rounds", "2",
                                            "--items-per-node", "8", "--seq-len", "16", "--local-batches", "1",
                                            "--batch-size", "4", "--compress", "int8", "--device", "cpu"])
    assert [r["kind"] for r in recs] == ["manifest", "round", "round", "summary", "gossip_health"]
    assert all(np.isfinite(hist[k]).all() for k in ("train_loss", "test_loss"))
    assert hist["wire_messages"] == [2, 2]
    assert "params/node, seq 16" in capsys.readouterr().out
    hist = p_cli.main(["--arch", "qwen2.5-3b", "--reduced", "--nodes", "2", "--rounds", "2", "--local-batches", "1",
                       "--batch-size", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round    0 train" in out and "round    1 train" in out  # train_loop(progress=True)
    assert hist["round"] == [0, 1] and np.isfinite(hist["train_loss"]).all() and hist["test_loss"] == []


@pytest.mark.parametrize("argv,what", [
    (["--model", "moe"], "item 15"),
    (["--model", "rwkv"], "item 15"),
    (["--arch", "rwkv6-3b", "--reduced"], "item 15"),
    (["--arch", "granite-moe-1b-a400m", "--reduced"], "item 15"),
    (["--model", "transformer", "--legacy-loop"], "--legacy-loop"),
    (["--async", "--legacy-loop"], "--async"),
])
def test_cli_refusals(argv, what, capsys):
    with pytest.raises(SystemExit):
        p_cli.main([*argv, "--device", "cpu"])
    assert what in capsys.readouterr().err


def test_serve_cli_telemetry(tmp_path):
    path = tmp_path / "serve.jsonl"
    hist, summ = p_serve.main(["--device", "cpu", "--nodes", "4", "--horizon", "3", "--per-node", "16",
                               "--telemetry", str(path), "--log-queries", "5"])
    recs = read_run_log(path)
    assert validate_run_log(recs) == [] == j_validate(path)
    n_q = min(5, summ["served"])
    assert [r["kind"] for r in recs] == ["manifest", *["bin"] * 10, *["query"] * n_q, "summary"]
    assert n_q == 5
    # the JAX serve CLI's query record and summary keys
    assert list(recs[11]) == ["kind", "time", "home", "node", "latency", "staleness", "hops", "answer"]
    assert set(recs[-1]) == {"kind", "wall_seconds", *summ}
    assert set(JE.MANIFEST_KEYS) <= set(recs[0])
