"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or the JAX package, importing the whole port
leaves jax out of ``sys.modules``, and on a host without CUDA an entry point
called without ``device`` raises instead of carrying on on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules, sorted(sys.modules)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    from repro_torch import fed
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import topology as T
    from repro_torch.core.commplan import compile_plan
    from repro_torch.launch import train as cli
    from repro_torch.models.paper_models import init_mlp
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.optim import sgd

    opt = sgd()
    init_one = lambda g, gains: init_mlp(InitConfig("he_normal", gains), g, hidden=(4,))  # noqa: E731
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_plan(T.ring(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        fed.init_fl_state(0, 4, init_one, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        fed.make_round_fn(lambda p, b: None, opt, T.ring(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy({"w": np.zeros((4, 3), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--nodes", "4", "--rounds", "1"])
    # the serving path: decoder init, conversion, generation, the engine
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.fed import ServeEngine, generate
    from repro_torch.models import transformer as TF

    cfg = get_reduced_config("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.init_params(0, cfg, InitConfig("trunc_normal"))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros((4, 3), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, cache_len=16)
    cpu_params = TF.init_params(0, cfg, InitConfig("trunc_normal"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(cpu_params, cfg, np.zeros((1, 4), np.int32), 2, 16)
    # a state built on the CPU still needs the caller to say "cpu"
    state = fed.init_fl_state(0, 4, init_one, opt, device="cpu")
    rf = fed.make_round_fn(lambda p, b: None, opt, T.ring(4), device="cpu")
    sched = np.zeros((1, 4, 1), np.int32)
    xs, ys = np.zeros((4, 1, 784), np.float32), np.zeros((4, 1), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        fed.run_trajectory(state, rf, xs, ys, sched, n_rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        fed.run_sweep([state], rf, xs, ys, sched, n_rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        fed.train_loop(state, rf, iter([]), n_rounds=1)
    # the event-driven path: the executor, the engine's event protocols, the
    # fig9 runner and its run(), the CLI's --async
    from repro_torch import gossip
    from repro_torch.benchmarks import common, fig9_async

    stream = T.poisson_event_stream(T.ring(4), 2.0, seed=0)
    plan = compile_plan(T.ring(4), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fed.run_event_trajectory(state, lambda p, b: None, opt, plan, stream, xs, ys, sched, b_local=1)
    for fn in (gossip.spread_events, gossip.push_sum_events):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(T.ring(4), np.ones(4, np.float32), stream)
    with pytest.raises(RuntimeError, match="CUDA"):
        gossip.estimate_size_leaderless_events(T.ring(4), stream, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        common.run_dfl_mlp_async(n_nodes=4, horizon=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        fig9_async.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--nodes", "4", "--rounds", "1", "--async"])
    # the live serving path: the serving executor, the serve CLI, fig13 and
    # the consensus example
    from repro_torch.benchmarks import fig13_serve
    from repro_torch.examples import serve_consensus
    from repro_torch.launch import serve as serve_cli

    queries = fed.poisson_query_stream(4, 2.0, 2.0, seed=0)
    router = fed.make_router(T.ring(4), "consensus")
    with pytest.raises(RuntimeError, match="CUDA"):
        fed.run_serve_trajectory(state, lambda p, b: None, opt, plan, stream, queries, router, xs, ys, sched,
                                 b_local=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--nodes", "4", "--horizon", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        fig13_serve.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_consensus.setup()
    # the elastic path and the checkpointed runs: the executor, fig11, the
    # example, the CLI's --elastic and its checkpoint flags
    from repro_torch.benchmarks import fig11_elastic
    from repro_torch.core.membership import membership_schedule
    from repro_torch.examples import elastic_membership

    with pytest.raises(RuntimeError, match="CUDA"):
        fed.run_elastic_trajectory(state, lambda p, b: None, opt, plan, membership_schedule(4, 1), xs, ys, sched,
                                   n_rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        fed.run_trajectory(state, rf, xs, ys, sched, n_rounds=1, checkpoint=fed.CheckpointPolicy("unused"))
    with pytest.raises(RuntimeError, match="CUDA"):
        fig11_elastic.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        elastic_membership.setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--nodes", "4", "--rounds", "1", "--elastic", "--join-nodes", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--nodes", "4", "--rounds", "1", "--ckpt-dir", "unused", "--checkpoint-every", "1"])
