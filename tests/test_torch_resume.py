"""Preemption-safe trajectories of the port: a real ``SIGKILL`` after a
chunk's checkpoint, then a resume from the checkpoint directory, give the
uninterrupted run's final state and history bit for bit, for
``run_trajectory``, ``run_event_trajectory`` and ``run_elastic_trajectory``.

- Across processes: a child runs each executor's reference, a child per
  executor dies by ``SIGKILL`` right after chunk 0's checkpoint lands (no
  handler, no flush), and a child resumes all three from their
  directories.  Every child runs torch on one thread, so each product is
  blocked the same way in every process.
- In process: a resume from a mid-run LATEST (with the history's chunk
  hook), from a finished run's directory (every chunk skipped: the full
  history and state still come back), a directory without LATEST (a fresh
  run), the ``meta_id`` mismatch error, and ``keep_last`` on a run's
  directory.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import fed as PF  # noqa: E402
from repro_torch.checkpoint import restore_train_state  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.membership import membership_schedule  # noqa: E402
from repro_torch.fed import CheckpointPolicy  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the three runs, each in chunks: the round executor (12 rounds in chunks of
# 4, link_p 0.8, int8, sigmas), the event executor (ring-6, link_p 0.8,
# chunks of 16 events) and the elastic one (a join, a crash, chunks of 4)
RUNS = r'''
import numpy as np
import torch

from repro_torch import fed as PF
from repro_torch.core import commplan as PC
from repro_torch.core import topology as PT
from repro_torch.core.compress import Compression
from repro_torch.core.faults import crash_burst
from repro_torch.core.initialisation import InitConfig
from repro_torch.core.membership import membership_schedule
from repro_torch.data import batch_index_schedule, mnist_like, node_datasets
from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
from repro_torch.optim import sgd

N, PER, BS, BL, R = 6, 32, 8, 2, 12
ds = mnist_like(N * PER + 64, seed=0)
xs, ys = node_datasets(ds, [np.arange(i * PER, (i + 1) * PER) for i in range(N)])
test = (ds.x[-64:], ds.y[-64:])


def loss_fn(p, b):
    return classifier_loss(mlp_forward(p, b[0]), b[1])


def init_one(g, gains):
    return init_mlp(InitConfig("he_normal", gains), g, hidden=(16,))


def run(kind, checkpoint=None, resume_from=None, on_chunk=None):
    """(final state, history, aux) of one of the three runs."""
    opt = sgd(1e-3, 0.5)
    state = PF.init_fl_state(0, N, init_one, opt, gains=2.0, device="cpu")
    eval_fn = PF.make_eval_fn(loss_fn)
    ring = PT.ring(N)
    kw = dict(checkpoint=checkpoint, resume_from=resume_from, on_chunk=on_chunk, device="cpu")
    if kind == "traj":
        sched = batch_index_schedule(PER, N, BS, R * BL, seed=0)
        rf = PF.make_round_fn(loss_fn, opt, PC.compile_plan(ring, device="cpu"), link_p=0.8,
                              compression=Compression("int8", chunk=256))
        state, hist = PF.run_trajectory(state, rf, xs, ys, sched, n_rounds=R, eval_every=3, eval_fn=eval_fn,
                                        eval_batch=test, track_sigmas=True, chunk_size=4, **kw)
        return state, hist, {}
    if kind == "event":
        stream = PT.poisson_event_stream(ring, 6.0, 1.0, seed=2)
        sched = batch_index_schedule(PER, N, BS, 6 * BL, seed=0)
        plan = PC.compile_plan(ring, failures=PC.FailureModel(link_p=0.8), device="cpu")
        hook = None if on_chunk is None else (lambda ci, i0, i1, acc: on_chunk(i0, i1, acc))
        kw["on_chunk"] = hook
        return PF.run_event_trajectory(state, loss_fn, opt, plan, stream, xs, ys, sched, b_local=BL, n_bins=6,
                                       eval_fn=eval_fn, eval_batch=test, chunk_events=16, **kw)
    sched = batch_index_schedule(PER, N, BS, R * BL, seed=0)
    mem = membership_schedule(N, R, initial=N - 1, arrivals={1: [N - 1]}, join_warmup=3)
    faults = crash_burst(ring, R, at=5, size=2, duration=3, seed=1)
    plan = PC.compile_plan(ring, failures=PC.FailureModel(link_p=0.8), device="cpu")
    return PF.run_elastic_trajectory(state, loss_fn, opt, plan, mem, xs, ys, sched, n_rounds=R, eval_every=3,
                                     eval_fn=eval_fn, eval_batch=test, chunk_size=4, init_one=init_one,
                                     faults=faults, **kw)


def arrays(out):
    """Everything a run returns, as named numpy arrays."""
    state, hist, aux = out
    got = {"params": state.params.numpy(), "round": np.asarray(state.round),
           "generator": state.generator.get_state().numpy()}
    got.update({f"opt_{i}": f.numpy() for i, f in enumerate(state.opt_state)})
    if state.residual is not None:
        got["residual"] = state.residual.numpy()
    got.update({f"h_{k}": np.asarray(v, dtype=np.float64) for k, v in hist.items()})
    for k, v in aux.items():
        got[f"aux_{k}"] = np.asarray(v if not isinstance(v, dict) else v["counts"], dtype=np.float64)
    return got
'''

CHILD = RUNS + r'''
import sys

from repro_torch.fed import CheckpointPolicy

torch.set_num_threads(1)
mode, root = sys.argv[1], sys.argv[2]
kinds = ("traj", "event", "elastic") if mode != "kill" else (sys.argv[3],)
for kind in kinds:
    d = f"{root}/{kind}"
    if mode == "kill":  # SIGKILL right after chunk 0's checkpoint lands
        run(kind, checkpoint=CheckpointPolicy(d, every=1, kill_after=0))
        raise SystemExit("still alive after the kill")
    out = run(kind, resume_from=d if mode == "resume" else None)
    np.savez(f"{root}/{mode}_{kind}.npz", **arrays(out))
'''

namespace = {}
exec(RUNS, namespace)
run, arrays = namespace["run"], namespace["arrays"]
KINDS = ("traj", "event", "elastic")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spawn(script, *argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run([sys.executable, script, *argv], env=env, capture_output=True, text=True, timeout=600)


def _assert_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sigkill_then_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    script = str(tmp_path / "child.py")
    Path(script).write_text(CHILD)
    ref = _spawn(script, "ref", str(tmp_path))
    assert ref.returncode == 0, ref.stderr
    for kind in KINDS:
        killed = _spawn(script, "kill", str(tmp_path), kind)
        assert killed.returncode == -signal.SIGKILL, (kind, killed.returncode, killed.stderr)
        _, meta = restore_train_state(str(tmp_path / kind))
        assert meta["chunk"] == 0 and meta["kind"] == {"traj": "trajectory"}.get(kind, kind)
    res = _spawn(script, "resume", str(tmp_path))
    assert res.returncode == 0, res.stderr
    for kind in KINDS:
        want, got = np.load(tmp_path / f"ref_{kind}.npz"), np.load(tmp_path / f"resume_{kind}.npz")
        _assert_equal({k: got[k] for k in got.files}, {k: want[k] for k in want.files})


@pytest.mark.parametrize("kind", KINDS)
def test_resume_from_a_mid_run_latest_in_process(kind, tmp_path):
    """A checkpointed run whose directory is cut back to chunk 1 (LATEST
    repointed, as a kill after chunk 1 would leave it), then resumed: the
    uninterrupted run bit for bit; the hook fires for the remaining chunks
    only."""
    want = arrays(run(kind))
    d = str(tmp_path / "ck")
    seen = []
    full = arrays(run(kind, checkpoint=CheckpointPolicy(d, every=1, keep_last=10),
                      on_chunk=lambda a, b, h: seen.append(a)))
    _assert_equal(full, want)
    steps = sorted(f for f in os.listdir(d) if f.startswith("step_"))
    assert len(steps) == len(seen) >= 3
    (Path(d) / "LATEST").write_text(f'{{"step": 1, "path": "{d}/step_00000001.ckpt"}}')
    resumed_at = []
    got = arrays(run(kind, resume_from=d, on_chunk=lambda a, b, h: resumed_at.append(a)))
    _assert_equal(got, want)
    assert resumed_at == seen[2:]


@pytest.mark.parametrize("kind", KINDS)
def test_resume_from_a_finished_run_skips_every_chunk(kind, tmp_path):
    want = arrays(run(kind))
    d = str(tmp_path / "done")
    run(kind, checkpoint=CheckpointPolicy(d, every=2))
    calls = []
    got = arrays(run(kind, resume_from=d, on_chunk=lambda *a: calls.append(a)))
    assert calls == []
    _assert_equal(got, want)


def test_no_latest_starts_fresh_and_mismatch_raises(tmp_path):
    want = arrays(run("traj"))
    # a directory without LATEST (here: a step file's path) runs from the start
    _assert_equal(arrays(run("traj", resume_from=str(tmp_path / "step_00000001.ckpt"))), want)
    d = str(tmp_path / "ev")
    run("event", checkpoint=CheckpointPolicy(d, every=1))
    with pytest.raises(ValueError, match="was written with kind='event', but this run has kind='trajectory'"):
        run("traj", resume_from=d)
    d2 = str(tmp_path / "el")
    run("elastic", checkpoint=CheckpointPolicy(d2, every=1, keep_last=2))
    assert sorted(f for f in os.listdir(d2) if f.endswith(".ckpt")) == ["step_00000001.ckpt", "step_00000002.ckpt"]
    opt = sgd(1e-3, 0.5)
    state = PF.init_fl_state(0, 6, namespace["init_one"], opt, gains=2.0, device="cpu")
    with pytest.raises(ValueError, match="chunk_size=4, but this run has chunk_size=6"):
        PF.run_elastic_trajectory(state, namespace["loss_fn"], opt, PC.compile_plan(PT.ring(6), device="cpu"),
                                  membership_schedule(6, 12, initial=5, arrivals={1: [5]}, join_warmup=3),
                                  namespace["xs"], namespace["ys"], np.zeros((12, 6, 2, 8), np.int64), n_rounds=12,
                                  eval_every=3, chunk_size=6, init_one=namespace["init_one"], resume_from=d2,
                                  device="cpu")
