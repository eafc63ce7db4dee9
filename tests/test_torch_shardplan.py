"""The node-sharded rendering (``core/shardplan.py``, ``run_sharded_trajectory``,
the colour and circulant collectives, gossip over a sharded plan, fig10)
against the JAX package and against the port's unsharded plan, on the CPU.

Ranks are real processes: ``launch.mesh.spawn_ranks`` starts S gloo ranks
over a ``file://`` store in a temporary directory (no port, safe under
xdist), one spawn per S covering every check of that S (``_rank_results``;
one shard runs in this process), each spawn with its own timeout so a hang
fails instead of stalling the suite.  The JAX references are computed here, on one device, and handed to
the ranks' results; the JAX counts of ``ShardedCommPlan`` come from one
subprocess with 8 forced host devices that compiles no operator.

Tolerances.  At one shard the sharded round is the unsharded one, bit for
bit.  At more, a row sums its terms in the ``[local | halo]`` order: the
result is the unsharded one to ``ULPS`` = 2⁻²⁰ · max|x| (a few fp32 ulps of
the payload's largest entry); the min-exchange is exact at any S.  Against
the JAX single-device plan: 1e-6 absolute and 1e-5 relative, the bound of
``test_torch_commplan``.  Trajectories (6 rounds of the paper MLP on
kreg4-8): params to rtol 1e-5 (atol 1e-7) and metrics to 5e-6 absolute of
the port's unsharded run; with the int8 codec a quantisation code can flip
where the value before quantising moved by an ulp, so params are held to
one int8 step of the payload (max|x| / 127) and metrics to 1e-4; against
the JAX run on the clean plan, ``test_torch_trainer``'s 1e-4 / 1e-5.
"""
import functools
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import gossip as PG  # noqa: E402
from repro_torch.convert import state_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import decavg as PD  # noqa: E402
from repro_torch.core import shardplan as PS  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.compress import Compression  # noqa: E402
from repro_torch.core.mixing import receive_matrix  # noqa: E402
from repro_torch.data import batch_index_schedule, mnist_like, node_datasets  # noqa: E402
from repro_torch.fed import make_eval_fn, make_round_fn, run_sharded_trajectory, run_trajectory  # noqa: E402
from repro_torch.launch.mesh import node_group, spawn_ranks  # noqa: E402
from repro_torch.models.paper_models import classifier_loss, mlp_forward  # noqa: E402
from repro_torch.obs import sharded_wire_per_round  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPAWN_TIMEOUT = 240.0
ULPS = 2.0**-20
JAX_TOL = dict(atol=1e-6, rtol=1e-5)
GRAPHS = {
    "kreg4-16": lambda T: T.random_k_regular(16, 4, seed=1),
    "ba-16": lambda T: T.barabasi_albert(16, 3, seed=2),
}
LAYOUT_GRAPHS = {
    "ring": lambda T, n: T.ring(n),
    "kreg4": lambda T, n: T.random_k_regular(n, 4, seed=1),
    "ba": lambda T, n: T.barabasi_albert(n, 3, seed=2),
}
# ppermute plans, one node a rank: n = S
COLOUR_GRAPHS = {
    4: {"complete-4": lambda T: T.complete(4), "ring-4": lambda T: T.ring(4)},
    8: {"kreg4-8": lambda T: T.random_k_regular(8, 4, seed=1), "ring-8": lambda T: T.ring(8)},
}
CIRCULANT = {4: (1,), 8: (1, 3)}
# fig10 quick's points held here: S = 1 in this process, S = 2 measured by
# the ranks of the S = 2 spawn
FIG10_SHARDS = (1, 2)
N_TRAJ, PER_NODE, BS, B_LOCAL, ROUNDS, HIDDEN = 8, 32, 8, 2, 6, (16,)
# (backend, link_p, codec)
TRAJ_CASES = {
    "sparse-clean": ("sparse", 1.0, None),
    "sparse-link0.8": ("sparse", 0.8, None),
    "sparse-int8": ("sparse", 1.0, "int8"),
    "dense-link0.8": ("dense", 0.8, None),
}
KEYS = ("train_loss", "test_loss", "sigma_ap", "sigma_an")


def _np(t):
    return t.detach().cpu().numpy()


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    n = 16
    return {
        "x": rng.normal(size=(n, 5)).astype(np.float32),
        "params": {"w": rng.normal(size=(n, 3, 2)).astype(np.float32), "b": rng.normal(size=(n, 5)).astype(np.float32)},
        "active": rng.random(n) < 0.75,
        "edge_live": {g: rng.random(64) < 0.7 for g in GRAPHS},
    }


def _traj_data():
    ds = mnist_like(N_TRAJ * PER_NODE + 32, seed=0)
    xs, ys = node_datasets(ds, [np.arange(i * PER_NODE, (i + 1) * PER_NODE) for i in range(N_TRAJ)])
    sched = batch_index_schedule(PER_NODE, N_TRAJ, BS, ROUNDS * B_LOCAL, seed=0)
    return xs, ys, (ds.x[-32:], ds.y[-32:]), sched


def _numpy_init() -> dict:
    """He-normal MLP params drawn with numpy, gain 2 (the JAX executor test's)."""
    rng = np.random.default_rng(0)
    dims = (784, *HIDDEN, 10)
    return {
        f"fc{i}": {"w": (rng.standard_normal((N_TRAJ, a, b)) * np.sqrt(2.0 / a) * 2.0).astype(np.float32),
                   "b": np.zeros((N_TRAJ, b), np.float32)}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
    }


def torch_loss(p, b):
    return classifier_loss(mlp_forward(p, b[0]), b[1])


# ------------------------------------------------------------------ ranks
def _ops(n_shards: int, inp: dict) -> dict:
    """The sharded mix / spread / spread_min against the unsharded port plan:
    clean, injected masks, and a failure model's generator draws."""
    out = {}
    x = torch.as_tensor(inp["x"])
    params = {k: torch.as_tensor(v) for k, v in inp["params"].items()}
    for gname, build in GRAPHS.items():
        graph = build(PT)
        el = torch.as_tensor(inp["edge_live"][gname][: len(graph.edge_list())])
        for backend in ("dense", "sparse"):
            for failures in (PC.FailureModel(), PC.FailureModel(link_p=0.7, node_p=0.9)):
                plan = PC.compile_plan(graph, backend, failures=failures, device="cpu")
                sp = PS.shard_plan(plan, n_shards=n_shards)
                gen = (lambda: torch.Generator().manual_seed(42)) if failures.active else (lambda: None)
                masks = {"clean": {}, "injected": {"active": torch.as_tensor(inp["active"]), "edge_live": el}}
                for mname, kw in masks.items():
                    tag = (gname, backend, "failing" if failures.active else mname)
                    if failures.active and mname == "injected":
                        continue
                    got, want = sp.mix(params, gen(), **kw), plan.mix(params, gen(), **kw)
                    for k in params:
                        out[(*tag, f"mix.{k}")] = (_np(got[k]), _np(want[k]))
                    for op in ("spread", "spread_min"):
                        out[(*tag, op)] = (_np(getattr(sp, op)(x, gen(), **kw)), _np(getattr(plan, op)(x, gen(), **kw)))
                    flat = params["b"].contiguous()
                    out[(*tag, "mix.flat")] = (_np(sp.mix(flat, gen(), **kw)), _np(plan.mix(flat, gen(), **kw)))
    return out


def _gossip(n_shards: int) -> dict:
    """Estimation over a sharded plan (with data sizes, which as_plan drops,
    and a failure model) against the unsharded plan."""
    plan = PC.compile_plan(PT.random_k_regular(16, 4, seed=3), "sparse", failures=PC.FailureModel(link_p=0.85),
                           data_sizes=np.arange(1, 17, dtype=np.float64), device="cpu")
    sp = plan.shard(n_shards=n_shards)
    est = PG.as_plan(sp)
    out = {"as_plan": (isinstance(est, PS.ShardedCommPlan) and est.data_sizes is None and est.n_shards == n_shards
                       and est.failures == plan.failures)}
    ref, got = PG.estimate_all(plan, pi_rounds=5, ps_rounds=8, seed=7), PG.estimate_all(sp, pi_rounds=5, ps_rounds=8,
                                                                                      seed=7)
    for k in ("n_hat", "vnorm", "mean_degree", "reached"):
        out[k] = (_np(getattr(got, k)), _np(getattr(ref, k)))
    out["leaderless"] = (_np(PG.estimate_size_leaderless(sp, 8, 7)), _np(PG.estimate_size_leaderless(plan, 8, 7)))
    gains = PG.make_gain_estimator(sp, pi_rounds=5, ps_rounds=8, mode="alpha")(11)
    out["gains_alpha"] = (_np(gains), _np(PG.make_gain_estimator(plan, pi_rounds=5, ps_rounds=8, mode="alpha")(11)))
    return out


def _trajectories(n_shards: int, init: dict) -> dict:
    xs, ys, test, sched = _traj_data()
    opt = sgd(1e-3, 0.5)
    eval_fn = make_eval_fn(torch_loss)
    common = dict(n_rounds=ROUNDS, eval_every=3, eval_fn=eval_fn, eval_batch=test, track_sigmas=True,
                  b_local=B_LOCAL)
    out = {}
    for name, (backend, link_p, codec) in TRAJ_CASES.items():
        comp = None if codec is None else Compression(codec)
        plan = PC.compile_plan(PT.random_k_regular(N_TRAJ, 4, seed=1), backend,
                               failures=PC.FailureModel(link_p=link_p), device="cpu")
        s0 = state_from_numpy(init, optimizer=opt, device="cpu")
        rf = make_round_fn(torch_loss, opt, plan, device="cpu", compression=comp)
        fin_u, h_u = run_trajectory(s0, rf, xs, ys, sched, device="cpu", **common)
        sp = plan.shard(n_shards=n_shards)
        runs = [run_sharded_trajectory(s0, torch_loss, opt, sp, xs, ys, sched, compression=comp, **common)
                for _ in range(2)]
        (fin_s, h_s), (fin_r, h_r) = runs
        out[name] = dict(
            params=(_np(fin_s.params), _np(fin_u.params)), hist=(h_s, h_u),
            rerun_bitwise=bool(torch.equal(fin_s.params, fin_r.params)) and h_s == h_r,
            round=fin_s.round, untouched=bool(torch.equal(s0.params, state_from_numpy(init, optimizer=opt,
                                                                                      device="cpu").params)),
            params_tree=to_numpy(fin_s)[0] if name == "sparse-clean" else None,
            wire=sharded_wire_per_round(sp, s0.tree, codec_bytes=None if comp is None else comp.leaf_row_bytes),
        )
    with pytest.raises(ValueError, match="ranks"):
        plan.shard(n_shards=n_shards + 1)
    with pytest.raises(TypeError, match="ShardedCommPlan"):
        run_sharded_trajectory(s0, torch_loss, opt, plan, xs, ys, sched, n_rounds=ROUNDS, b_local=B_LOCAL)
    return out


def _colours(n_shards: int) -> dict:
    """The ppermute backend and the circulant mix, one node a rank."""
    out = {}
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(n_shards, 3)).astype(np.float32))
    me = torch.distributed.get_rank()
    for gname, build in COLOUR_GRAPHS[n_shards].items():
        graph = build(PT)
        for failures in (PC.FailureModel(), PC.FailureModel(link_p=0.7, node_p=0.9)):
            plan = PC.compile_plan(graph, "ppermute", failures=failures, device="cpu")
            sp = plan.shard(n_shards=n_shards)
            gen = (lambda: torch.Generator().manual_seed(3)) if failures.active else (lambda: None)
            tag = (gname, "failing" if failures.active else "clean")
            for op in ("mix", "spread", "spread_min"):
                out[(*tag, op)] = (_np(getattr(sp, op)(x, gen())), _np(getattr(plan, op)(x, gen())))
            # the decavg form itself, on this rank's row
            cw, sw = plan.color_round_weights(gen())
            row = PD.mix_pytree_colored(x[me : me + 1], plan.partners, cw[:, me : me + 1], sw[me : me + 1],
                                        process_group=torch.distributed.group.WORLD)
            out[(*tag, "colored_row")] = (_np(row), _np(plan.mix(x, gen())[me : me + 1]))
    offsets = CIRCULANT[n_shards]
    w = np.linspace(1.0, 2.0, 2 * len(offsets) + 1)
    weights = torch.as_tensor(w / w.sum(), dtype=torch.float32)
    for tag, w in (("uniform", None), ("weighted", weights)):
        got = PD.mix_pytree_circulant({"x": x[me : me + 1]}, offsets, w, process_group=torch.distributed.group.WORLD)
        out[("circulant", tag)] = (_np(got["x"]), _np(PD.mix_pytree_circulant(x, offsets, w)[me : me + 1]))
    return out


def _rank(rank: int, n_shards: int, inp: dict, init: dict) -> dict | None:
    out = {"ops": _ops(n_shards, inp), "gossip": _gossip(n_shards)}
    if n_shards in FIG10_SHARDS[1:]:
        from repro_torch.benchmarks import fig10_scaling as F

        out["fig10"] = F._measure(rank, n_shards, F._sizes(True), "cpu")
    if N_TRAJ % n_shards == 0:
        out["traj"] = _trajectories(n_shards, init)
    if n_shards in COLOUR_GRAPHS:
        out["colours"] = _colours(n_shards)
    out["rank"] = rank
    return out


@functools.cache
def _rank_results(n_shards: int) -> list[dict]:
    """Every rank's results at ``n_shards``: one spawn, cached for the file.
    One shard runs here, in a world-size-1 gloo group made and destroyed
    around the call (one thread, as a spawned rank)."""
    if n_shards > 1:
        return spawn_ranks(_rank, n_shards, n_shards, _inputs(), _numpy_init(), timeout=SPAWN_TIMEOUT)
    threads = torch.get_num_threads()
    with tempfile.TemporaryDirectory() as tmp:
        torch.distributed.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        torch.set_num_threads(1)
        try:
            return [_rank(0, 1, _inputs(), _numpy_init())]
        finally:
            torch.distributed.destroy_process_group()
            torch.set_num_threads(threads)


def _colour_only(rank: int, n_shards: int) -> dict:
    return {"colours": _colours(n_shards)}


@functools.cache
def _colour_results(n_shards: int) -> list[dict]:
    return spawn_ranks(_colour_only, n_shards, n_shards, timeout=SPAWN_TIMEOUT)


def _close_to_unsharded(got, want, n_shards, what):
    if n_shards == 1:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ULPS * max(float(np.abs(want).max()), 1.0), err_msg=what)


# ------------------------------------------------------------ JAX side
@functools.cache
def _jax_ops() -> dict:
    """JAX single-device refs of every clean / injected op of ``_ops``."""
    import jax.numpy as jnp

    from repro.core import commplan as JC
    from repro.core import topology as JT

    inp = _inputs()
    out = {}
    for gname, build in GRAPHS.items():
        graph = build(JT)
        el = jnp.asarray(inp["edge_live"][gname][: len(graph.edge_list())])
        for backend in ("dense", "sparse"):
            plan = JC.compile_plan(graph, backend)
            for mname, kw in (("clean", {}), ("injected", {"active": jnp.asarray(inp["active"]), "edge_live": el})):
                mixed = plan.mix({k: jnp.asarray(v) for k, v in inp["params"].items()}, **kw)
                for k in inp["params"]:
                    out[(gname, backend, mname, f"mix.{k}")] = np.asarray(mixed[k])
                out[(gname, backend, mname, "mix.flat")] = np.asarray(mixed["b"])
                for op in ("spread", "spread_min"):
                    out[(gname, backend, mname, op)] = np.asarray(getattr(plan, op)(jnp.asarray(inp["x"]), **kw))
    return out


@functools.cache
def _jax_colours(n_shards: int) -> dict:
    import jax.numpy as jnp

    from repro.core import commplan as JC
    from repro.core import topology as JT

    x = np.random.default_rng(5).normal(size=(n_shards, 3)).astype(np.float32)
    out = {}
    for gname, build in COLOUR_GRAPHS[n_shards].items():
        plan = JC.compile_plan(build(JT), "ppermute")
        out[(gname, "mix")] = np.asarray(plan.mix({"x": jnp.asarray(x)})["x"])
        for op in ("spread", "spread_min"):
            out[(gname, op)] = np.asarray(getattr(plan, op)(jnp.asarray(x)))
    return out


@functools.cache
def _jax_trajectory() -> tuple:
    """The JAX run_trajectory on the clean sparse kreg4-8 plan from the
    numpy init: (params tree, history)."""
    import jax
    import jax.numpy as jnp

    from repro import fed as JF
    from repro import optim as JO
    from repro.core import commplan as JC
    from repro.core import topology as JT
    from repro.models import paper_models as JPM

    def jax_loss(p, b):
        return JPM.classifier_loss(JPM.mlp_forward(p, b[0]), b[1])

    xs, ys, test, sched = _traj_data()
    opt = JO.sgd(1e-3, 0.5)
    params = jax.tree_util.tree_map(jnp.asarray, _numpy_init())
    s0 = JF.DFLState(params=params, opt_state=jax.vmap(opt.init)(params), round=jnp.zeros((), jnp.int32),
                     rng=jax.random.PRNGKey(0))
    rf = JF.make_round_fn(jax_loss, opt, JC.compile_plan(JT.random_k_regular(N_TRAJ, 4, seed=1), "sparse"))
    fin, hist = JF.run_trajectory(s0, rf, xs, ys, sched, n_rounds=ROUNDS, eval_every=3,
                                  eval_fn=JF.make_eval_fn(jax_loss), eval_batch=test, track_sigmas=True,
                                  b_local=B_LOCAL)
    return jax.tree_util.tree_map(np.asarray, fin.params), hist


_JAX_COUNTS = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    from repro.core import topology as T
    from repro.core.commplan import compile_plan
    from repro.core.shardplan import shard_plan
    cases = json.loads(sys.argv[1])
    out = []
    for family, n, s, backend in cases:
        g = {"ring": lambda: T.ring(n), "kreg4": lambda: T.random_k_regular(n, 4, seed=1),
             "ba": lambda: T.barabasi_albert(n, 3, seed=2)}[family]()
        sp = shard_plan(compile_plan(g, backend=backend), n_shards=s)
        hub = sp.hyb is not None and int(sp.hyb["hub_loc"].shape[-1]) > 0
        out.append({"case": [family, n, s, backend], "hub": hub,
                    **{f"rows_{op}": sp.cross_shard_rows_per_round(op) for op in ("mix", "spread", "spread_min")},
                    **{f"coll_{op}": sp.collectives_per_round(op) for op in ("mix", "spread", "spread_min")}})
    print(json.dumps(out))
    """
)
COUNT_CASES = [[f, n, s, b] for f in LAYOUT_GRAPHS for n in (16, 64) for s in (1, 2, 4, 8)
               for b in ("sparse", "dense")] + [["ba", 1024, s, "sparse"] for s in (1, 2, 4, 8)]


@functools.cache
def _jax_counts() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _JAX_COUNTS, json.dumps(COUNT_CASES)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return {tuple(r["case"]): r for r in json.loads(res.stdout.strip().splitlines()[-1])}


def _port_unbound(plan, n_shards: int) -> PS.ShardedCommPlan:
    """A ShardedCommPlan with its layouts but no process group: enough for
    the static counts."""
    kw = {}
    if plan.backend == "sparse":
        kw = dict(zip(("recv", "send"), PS._layouts(plan, n_shards)))
        kw["hyb"] = PS._build_hyb_tables(plan, kw["recv"], n_shards)
    return PS.ShardedCommPlan(base=plan, group=None, n_shards=n_shards, nps=plan.n // n_shards, rank=0, **kw)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("family", sorted(LAYOUT_GRAPHS))
def test_layout_tables_equal_jax(family, n, n_shards):
    """The port's receive and send layouts are the JAX ``_build_layout``
    tables exactly: every table, ``h_max`` and the gather positions."""
    from repro.core import commplan as JC
    from repro.core import topology as JT
    from repro.core.shardplan import _build_layout

    jp = JC.compile_plan(LAYOUT_GRAPHS[family](JT, n), backend="sparse")
    src, dst = np.asarray(jp.src), np.asarray(jp.dst)
    args = (np.asarray(jp.edge_uid), np.asarray(jp.edge_w), np.asarray(jp.raw_edge_w))
    ident = np.arange(len(src), dtype=np.int32)
    sw, rsw = np.asarray(jp.self_w), np.asarray(jp.raw_self_w)
    order = np.lexsort((dst, src))
    want = {
        "recv": _build_layout(n, n_shards, dst, src, *args, ident, sw, rsw),
        "send": _build_layout(n, n_shards, src[order], dst[order], *(a[order] for a in args), ident[order], sw, rsw),
    }
    got = dict(zip(("recv", "send"), PS._layouts(PC.compile_plan(LAYOUT_GRAPHS[family](PT, n), "sparse",
                                                                 device="cpu"), n_shards)))
    for which in ("recv", "send"):
        w, g = want[which], got[which]
        assert (g.nps, g.n_shards, g.h_max, g.pos) == (w.nps, w.n_shards, w.h_max, w.pos), which
        for name, table in g.tables().items():
            np.testing.assert_array_equal(table, np.asarray(w.tables()[name]), err_msg=f"{which}.{name}")
            assert table.dtype == np.asarray(w.tables()[name]).dtype, f"{which}.{name}"


@pytest.mark.parametrize("backend", ["sparse", "dense"])
@pytest.mark.parametrize("family", sorted(LAYOUT_GRAPHS))
def test_counts_match_jax(family, backend):
    """Static traffic counts equal the JAX ``ShardedCommPlan``'s on every
    family, the hub all-gather of the clean HYB mix included (BA's hub rows
    contract against the all-gathered payload: S·(n − nps) rows and one
    collective more a round)."""
    jax_counts = _jax_counts()
    for case in [c for c in COUNT_CASES if c[0] == family and c[3] == backend]:
        _, n, s, _ = case
        sp = _port_unbound(PC.compile_plan(LAYOUT_GRAPHS[family](PT, n), backend, device="cpu"), s)
        j = jax_counts[tuple(case)]
        assert sp.hub_gather == j["hub"] or backend == "dense", case
        for op in ("mix", "spread", "spread_min"):
            assert sp.cross_shard_rows_per_round(op) == j[f"rows_{op}"], (case, op)
            assert sp.collectives_per_round(op) == j[f"coll_{op}"], (case, op)


def test_local_bsr_at_one_shard_is_the_plan_bsr():
    """At one shard a rank's receive BSR is the unsharded plan's, tile for
    tile, and its send BSR is the plan's Mᵀ: the same kernel call."""
    for build in (lambda: PT.ring(16), lambda: PT.barabasi_albert(64, 3, seed=2)):
        plan = PC.compile_plan(build(), "sparse", device="cpu")
        sp = _port_unbound(plan, 1)
        for name, want in (("recv", plan.bsr), ("send", plan._send[0])):
            got = sp._op(name).bsr
            for a, b in zip(got, want):
                assert torch.equal(a, b), name


def test_row_block_kernels_plain_versions():
    """The row-block forms of kernels #1 and #2 on the CPU (their plain
    versions): the rows of the square product; ``mix_bsr_rows_ref`` (the
    CUDA walk's rendering) over a [local | halo] buffer of more rows."""
    from repro_torch.kernels.mix import bsr_from_dense, mix_bsr, mix_bsr_rows_ref, mix_matmul

    rng = np.random.default_rng(1)
    m = torch.as_tensor(rng.random((16, 16)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(16, 7)).astype(np.float32))
    torch.testing.assert_close(mix_matmul(m[4:8].contiguous(), w), (m @ w)[4:8], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="r <= 16"):
        mix_matmul(torch.zeros(17, 16), w)
    dense = np.zeros((6, 20), np.float32)  # 6 output rows over a 20-row buffer
    dense[np.arange(6), np.arange(6)] = 0.5
    dense[np.arange(6), 10 + np.arange(6)] = 0.25
    dense[np.arange(6), 19] = 0.25
    pad = np.zeros((20, 20), np.float32)
    pad[:6] = dense
    bc, tiles, counts = bsr_from_dense(pad, 4)
    keep = -(-6 // 4)
    op = [torch.as_tensor(a[:keep]) for a in (bc, tiles, counts)]
    x = torch.as_tensor(rng.normal(size=(20, 5)).astype(np.float32))
    want = torch.as_tensor(dense) @ x
    torch.testing.assert_close(mix_bsr(*op, x, 6), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mix_bsr_rows_ref(*op, x, 6), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="do not cover"):
        mix_bsr(*op, x, 12)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_ops_match_jax_and_unsharded(n_shards):
    """mix (dict and flat) / spread / spread_min over S gloo ranks, dense and
    sparse, clean, on injected masks and on a failure model's draws: the
    unsharded port plan's (bitwise at S = 1, the min bitwise at any S) and,
    clean and injected, the JAX single-device plan's."""
    jax_ref = _jax_ops()
    for res in _rank_results(n_shards):
        for tag, (got, want) in res["ops"].items():
            if tag[-1] == "spread_min":
                np.testing.assert_array_equal(got, want, err_msg=str(tag))
            else:
                _close_to_unsharded(got, want, n_shards, str(tag))
            if tag in jax_ref:
                np.testing.assert_allclose(got, jax_ref[tag], **JAX_TOL, err_msg=f"jax {tag}")
    assert len(jax_ref) == 2 * 2 * 2 * 5 and all(t in _rank_results(n_shards)[0]["ops"] for t in jax_ref)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_gossip_over_sharded_plan(n_shards):
    """estimate_all, the leaderless sketches and a gain estimator over a
    sharded plan: the unsharded estimates (bitwise at S = 1; the minima at
    any S)."""
    for res in _rank_results(n_shards):
        g = res["gossip"]
        assert g["as_plan"]
        np.testing.assert_array_equal(*g["reached"])
        np.testing.assert_array_equal(*g["leaderless"])
        for k in ("n_hat", "vnorm", "mean_degree", "gains_alpha"):
            if n_shards == 1:
                np.testing.assert_array_equal(*g[k], err_msg=k)
            else:
                np.testing.assert_allclose(*g[k], rtol=1e-5, atol=0, err_msg=k)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_trajectory(n_shards):
    """run_sharded_trajectory at S ranks: the port's unsharded run_trajectory
    (bitwise at S = 1, params and losses), the JAX run on the clean plan,
    reruns bitwise, the caller's state untouched, the wire constants."""
    jax_params, jax_hist = _jax_trajectory()
    results = _rank_results(n_shards)
    for name, (backend, _, codec) in TRAJ_CASES.items():
        per_rank = [res["traj"][name] for res in results]
        first = per_rank[0]
        for r in per_rank[1:]:  # every rank holds the same bits
            np.testing.assert_array_equal(r["params"][0], first["params"][0])
            assert r["hist"][0] == first["hist"][0]
        (got, want), (h_s, h_u) = first["params"], first["hist"]
        assert first["rerun_bitwise"] and first["untouched"] and first["round"] == ROUNDS, name
        assert h_s["round"] == h_u["round"] == [0, 3, 5], name
        if n_shards == 1:
            np.testing.assert_array_equal(got, want, err_msg=name)
            for k in ("train_loss", "test_loss", "sigma_ap"):
                assert h_s[k] == h_u[k], (name, k)
        elif codec is None:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=float(np.abs(want).max()) / 127, err_msg=name)
        for k in KEYS:
            np.testing.assert_allclose(h_s[k], h_u[k], rtol=0, atol=5e-6 if codec is None else 1e-4,
                                       err_msg=f"{name} {k}")
        wire = first["wire"]
        assert {k: h_s[k][0] for k in wire} == wire, name
        row_bytes = (784 * 16 + 16 + 16 * 10 + 10) * (4 if codec is None else 1)
        if n_shards == 1:
            assert wire == {"wire_bytes": 0, "wire_rows": 0, "wire_collectives": 0}, name
        else:
            # the halo exchange, and on a sparse plan without a failure model
            # the hub all-gather, which the JAX package counts: kreg4-8's HYB
            # layout holds every row as a hub row (its cost picks t = 0)
            want_coll = 2 if backend == "sparse" and name != "sparse-link0.8" else 1
            assert wire["wire_collectives"] == want_coll and wire["wire_bytes"] >= wire["wire_rows"] * row_bytes > 0, name
    # the JAX executor on the clean plan
    tree = results[0]["traj"]["sparse-clean"]["params_tree"]
    for layer in jax_params:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(tree[layer][leaf], jax_params[layer][leaf], rtol=1e-4, atol=1e-5)
    h_s = results[0]["traj"]["sparse-clean"]["hist"][0]
    for k in KEYS:
        np.testing.assert_allclose(h_s[k], jax_hist[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("n_shards", [4, 8])
def test_colour_and_circulant_collectives(n_shards):
    """The ppermute backend (one batch_isend_irecv exchange a colour) and
    the circulant mix (a send/receive pair a term), one node a rank: the
    single-device renderings bitwise, and the JAX plan's mix / spread /
    spread_min."""
    results = _rank_results(n_shards) if n_shards == 4 else _colour_results(n_shards)
    jax_ref = _jax_colours(n_shards)
    for res in results:
        for tag, (got, want) in res["colours"].items():
            np.testing.assert_array_equal(got, want, err_msg=str(tag))
            if tag[-1] in ("mix", "spread", "spread_min") and tag[1] == "clean":
                np.testing.assert_allclose(got, jax_ref[(tag[0], tag[-1])], **JAX_TOL, err_msg=f"jax {tag}")
    # the circulant collective is the circulant graph's DecAvg operator
    x = np.random.default_rng(5).normal(size=(n_shards, 3)).astype(np.float32)
    m = receive_matrix(PT.circulant(n_shards, CIRCULANT[n_shards])).astype(np.float32)
    got = np.concatenate([res["colours"][("circulant", "uniform")][0] for res in results])
    np.testing.assert_allclose(got, m @ x, rtol=1e-5, atol=1e-6)


def test_fig10_quick_records(tmp_path, monkeypatch):
    """fig10 quick at S = 1 (in this process, its world-size-1 gloo group
    destroyed after) and S = 2 (``_measure`` on the ranks of the S = 2
    spawn, handed to ``run`` in place of its own spawn): the schema, the
    parity, the port plan's counts, the model."""
    from repro_torch.benchmarks import fig10_scaling as F

    def ranks_of_the_spawn(fn, n_ranks, *args, device):
        assert fn is F._measure and args == (n_ranks, F._sizes(True), "cpu") and device == "cpu"
        return [res["fig10"] for res in _rank_results(n_ranks)]

    monkeypatch.setattr(F, "spawn_ranks", ranks_of_the_spawn)
    out_path = tmp_path / "fig10.json"
    try:
        F.run(quick=True, device="cpu", out_path=out_path, shards=FIG10_SHARDS)
    finally:
        torch.distributed.destroy_process_group()
    doc = json.loads(out_path.read_text())
    assert doc["quick"] and doc["model_bw_gbps"] == F.MODEL_BW_GBPS and "NVLink" in doc["model_source"]
    assert sorted(doc["modelled_growth"]) == sorted(F.FAMILIES)
    keys = {"family", "n", "n_shards", "nodes_per_shard", "d", "rounds", "backend", "collective_backend",
            "rank_device", "us_per_round", "us_per_round_serialized", "us_compute_per_round", "collectives_per_round",
            "cross_shard_bytes_per_round", "parity_bitexact", "parity_max_abs_err"}
    assert len(doc["records"]) == 2 * len(F.FAMILIES)
    for r in doc["records"]:
        assert set(r) == keys and r["collective_backend"] == "gloo" and r["rank_device"] == "cpu"
        assert r["n"] == 64 * r["n_shards"] and r["d"] == 256 and r["us_per_round_serialized"] > 0
        plan = PC.compile_plan(F.FAMILIES[r["family"]](r["n"]), "sparse", device="cpu")
        sp = _port_unbound(plan, r["n_shards"])
        assert r["collectives_per_round"] == sp.collectives_per_round()
        assert r["cross_shard_bytes_per_round"] == sp.cross_shard_bytes_per_round(256 * 4)
        assert r["parity_max_abs_err"] <= F.PARITY_RTOL * 5.0
        if r["n_shards"] == 1:
            assert r["parity_bitexact"] and r["cross_shard_bytes_per_round"] == 0
            assert r["us_per_round"] == r["us_compute_per_round"] == r["us_per_round_serialized"]
        else:
            assert r["us_per_round"] > r["us_compute_per_round"]


def test_fig10_on_the_card_stays_on_the_card(tmp_path, monkeypatch, capsys):
    """On the card every point is an NCCL point: an S above the host's card
    count raises (no gloo point in a cuda document), and the default sweep
    stops at the card count, naming what it left to a CPU run."""
    from repro_torch.benchmarks import fig10_scaling as F

    measured = []

    def measure(rank, n_shards, sizes, device):
        measured.append((n_shards, device))
        return [{"family": f, "n_shards": n_shards, "n": sizes["nps"] * n_shards, "collectives_per_round": 0,
                 "cross_shard_bytes_per_round": 0, "us_per_round_serialized": 1.0, "collective_backend": "nccl",
                 "parity_bitexact": True} for f in F.FAMILIES]

    monkeypatch.setattr(F, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(F, "_measure", measure)
    with pytest.raises(ValueError, match="--device cpu"):
        F.run(device="cuda", out_path=tmp_path / "f.json", shards=(1, 2))
    assert measured == []
    doc = F.run(device="cuda", out_path=tmp_path / "f.json")
    assert measured == [(1, "cuda")] and {r["n_shards"] for r in doc["records"]} == {1}
    assert "S = 2, 4, 8 left to a --device cpu run" in capsys.readouterr().out


def test_no_group_no_fallback():
    """No process group at more than one shard raises (nothing starts one
    process quietly), the default device is the card, a plan needs a group
    or a shard count, and a schedule is not sharded."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="launcher"):
        node_group(2, device="cpu")
    plan = PC.compile_plan(PT.ring(8), "sparse", device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        PS.shard_plan(plan)
    with pytest.raises(RuntimeError, match="launcher"):
        plan.shard(n_shards=2)
    with pytest.raises(TypeError, match="schedules"):
        PS.shard_plan(PC.compile_schedule([PT.ring(8)], "sparse", device="cpu"), n_shards=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            node_group(1)
    assert not torch.distributed.is_initialized()


def test_spawn_ranks_reports_a_failed_rank():
    """A rank that raises fails the spawn with its traceback; the others,
    waiting in a collective, are stopped."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn_ranks(_fail_on_one, 2, timeout=60)


def _fail_on_one(rank: int) -> None:
    if rank == 1:
        raise ValueError("boom")
    torch.distributed.barrier()

