"""The port's step builders (``repro_torch/launch/steps.py``) against the JAX
package's ``repro/launch/steps.py``.

* ``SHAPES``, ``ShapeSpec`` and the training graph's offsets.
* Abstract args: every builder's example args (fake tensors) against the
  JAX builder's ``ShapeDtypeStruct``s, shape and dtype leaf for leaf, for
  all ten configs × four shapes at a (1, 1) mesh (the port's over a fake
  world of one rank, the JAX one over ``jax.make_mesh((1, 1))``).
* One train round at a (1, 1) mesh over a world-size-1 gloo group against
  the JAX step, jitted (reduced qwen2.5-3b at d_model 128, ``n_fl_nodes``
  patched to 2, the shapes shrunk as ``tests/test_launch_steps.py`` does),
  on numpy-seeded params and batches: params and loss at rtol 1e-4 / atol
  1e-5, ``test_torch_trainer``'s tolerance.  Both builders take
  ``sgd(LR, 0.5)`` with ``LR`` = 1: at the builders' default 1e-3 a node's
  gradient step (about 1e-5 here) is the size of that tolerance and the
  comparison would see only the forward pass and the mix.  The test checks
  that in every leaf the step is at least ten times the tolerance somewhere
  (the round at lr 0 against the round at ``LR``), so that a dropped,
  halved or mis-reduced gradient shows.
* The prefill and decode steps at that mesh against the port's unsharded
  ``forward`` + ``hidden_to_logits`` and ``decode_step``.
* The dense, sparse and ppermute backends on 4 spawned gloo ranks at a
  (2, 2) ``("data", "model")`` mesh: each rank's params and loss agree
  across the three, and with the (1, 1) round, at rtol 1e-5 / atol 1e-6.
* The prefill, decode and train steps on 4 spawned gloo ranks at a (1, 4)
  mesh, the ``model`` axis wider than the K/V heads (8 q heads, 2 or 1 K/V
  heads of 16), as on the production meshes: the K/V projections are
  gathered, each rank reads the K/V heads of its own q heads, the token
  lookup is vocab-parallel outside autograd and the loss's target pick is
  vocab-parallel.  Each against the port's unsharded ``forward`` +
  ``hidden_to_logits``, ``decode_step``, and round (each node's step
  p − LR·g, then the plan's mix), at rtol 1e-4 / atol 1e-5: the model
  axis splits the row-parallel projections' sums, so they are added in
  another order than the unsharded ones.
"""
import dataclasses
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced_config as jget_reduced  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import shardings as JSH  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.initialisation import InitConfig  # noqa: E402
from repro_torch.dtensor import fake_world  # noqa: E402
from repro_torch.flat import tree_leaves  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.launch import steps as PS  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)
BACKENDS = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32)
SPAWN_TIMEOUT = 300.0
LR = 1.0  # one step from a zero momentum: p − LR·g, resolved by TRAJ in every leaf


def test_shape_registry_and_offsets():
    assert {k: dataclasses.astuple(v) for k, v in PS.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JS.SHAPES.items()}
    assert PS.CIRCULANT_OFFSETS == JS.CIRCULANT_OFFSETS


# ------------------------------------------------------------ abstract args
_JAX_ABSTRACT = JS._abstract_params


@functools.cache
def _jax_abstract(cfg, gain):
    return _JAX_ABSTRACT(cfg, gain)


def _jpath(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name", None))) for k in path)


def _leaves(tree) -> dict:
    """path → leaf of a port tree (NamedTuple fields by name)."""
    out = {}
    PS.shard_rules.map_with_path(lambda p, t: out.__setitem__(p, t), tree)
    return out


@pytest.fixture
def jax_cached(monkeypatch):
    """The JAX builders' ``eval_shape`` of ``init_params`` once per config."""
    monkeypatch.setattr(JS, "_abstract_params", _jax_abstract)


@pytest.mark.parametrize("shape", list(JS.SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_abstract_args_match_jax(jax_cached, arch, shape):
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    _, jargs, _, _ = JS.build(jget_config(arch), shape, jmesh)
    with fake_world(1):
        mesh = PM.make_production_mesh(n_devices=1)
        _, args, in_sh, _ = PS.build(get_config(arch), shape, mesh)
    want = {_jpath(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(jargs)[0]}
    got = _leaves(args)
    assert sorted(map(str, got)) == sorted(map(str, want))
    by_str = {str(k): v for k, v in want.items()}
    for path, t in got.items():
        w = by_str[str(path)]
        assert tuple(t.shape) == tuple(w.shape) and str(t.dtype).removeprefix("torch.") == str(w.dtype), path
        assert t.device.type == "cpu" and type(t).__name__ == "FakeTensor", path
    assert len(_leaves(in_sh)) == len(got)


# ------------------------------------------------------- (1, 1) round vs JAX
def _small_cfgs():
    return (dataclasses.replace(jget_reduced("qwen2p5_3b"), **SMALL),
            dataclasses.replace(get_reduced_config("qwen2p5_3b"), **SMALL))


def _patch_small(mods, monkeypatch):
    for m in mods:
        sh = dict(m.SHAPES)
        sh["train_4k"] = dataclasses.replace(sh["train_4k"], seq_len=64, global_batch=4)
        sh["decode_32k"] = dataclasses.replace(sh["decode_32k"], seq_len=64, global_batch=4)
        monkeypatch.setattr(m, "SHAPES", sh)
        monkeypatch.setattr(m, "n_fl_nodes", lambda multi_pod=False: 2)


def _numpy_args(jargs, seed: int = 0):
    """Numpy draws in the JAX args' layout: params N(0, 0.02²) (a norm
    scale 1 + that), the optimizer state zero, tokens and targets in the
    vocabulary."""
    rng = np.random.default_rng(seed)

    def draw(path, sds):
        base = 1.0 if _jpath(path)[-1] == "scale" else 0.0
        return (base + 0.02 * rng.standard_normal(sds.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, jargs[0])
    opt = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jargs[1])
    batch = jax.tree_util.tree_map(lambda s: rng.integers(0, 256, s.shape).astype(np.int32), jargs[2])
    return params, opt, batch


def _port_args(np_args, args):
    params_np, opt_np, batch_np = np_args
    params = params_from_numpy(params_np, device="cpu")
    opt = type(args[1])(*(params_from_numpy(f, device="cpu") for f in opt_np))
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    return params, opt, batch


def _world1():
    tmp = tempfile.mkdtemp(prefix="repro_steps_")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=1, rank=0)


def _np_tree(tree):
    return {str(p): (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy()
            for p, t in _leaves(tree).items()}


@pytest.fixture(scope="module")
def jax_round():
    """The JAX step's round on the (1, 1) mesh, and its numpy inputs."""
    mp = pytest.MonkeyPatch()
    try:
        _patch_small([JS], mp)
        jcfg, _ = _small_cfgs()
        jmesh = jax.make_mesh((1, 1), ("data", "model"))
        with jmesh:
            step, jargs, in_sh, out_sh = JS.build_train_step(jcfg, jmesh, mixing="dense", optimizer=jsgd(LR, 0.5))
            np_args = _numpy_args(jargs)
            p2, _, loss = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)(*np_args)
        want = {str(_jpath(p)): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(p2)[0]}
        return np_args, want, float(loss)
    finally:
        mp.undo()


@pytest.fixture
def small(monkeypatch):
    _patch_small([PS], monkeypatch)
    return _small_cfgs()[1]


def test_train_round_at_one_rank_matches_jax(jax_round, small):
    np_args, want, want_loss = jax_round
    _world1()
    try:
        mesh = PM.make_production_mesh(n_devices=1)
        step, args, in_sh, out_sh = PS.build_train_step(small, mesh, mixing="dense", optimizer=sgd(LR, 0.5))
        p2, o2, loss = step(*PS.shard_args(_port_args(np_args, args), in_sh))
        got = _np_tree(p2)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TRAJ)
        # the gradient step is resolved: somewhere in every leaf it is ten
        # times the tolerance (the round at lr 0 is the mix of p0 alone)
        step0, _, in0, _ = PS.build_train_step(small, mesh, mixing="dense", optimizer=sgd(0.0, 0.5))
        mixed0 = _np_tree(step0(*PS.shard_args(_port_args(np_args, args), in0))[0])
        for k in want:
            tol = TRAJ["atol"] + TRAJ["rtol"] * np.abs(want[k])
            assert (np.abs(want[k] - mixed0[k]) > 10 * tol).any(), f"{k}: the gradient step is below the tolerance"
        np.testing.assert_allclose(float(loss.full_tensor()), want_loss, **TRAJ)
        assert all(float(t.full_tensor().abs().max()) == 0.0 for t in _leaves(o2).values())
        want_pl = {k: s.placements for k, s in _leaves(out_sh[0]).items()}
        assert {k: p.placements for k, p in _leaves(p2).items()} == want_pl
    finally:
        dist.destroy_process_group()


def test_prefill_and_decode_match_unsharded(small):
    _world1()
    try:
        mesh = PM.make_production_mesh(n_devices=1)
        params = PTF.init_params(3, small, InitConfig("trunc_normal", 1.0), device="cpu")
        tokens = torch.randint(0, small.vocab_size, (32, 24), generator=torch.Generator().manual_seed(1))
        step, args, in_sh, out_sh = PS.build_prefill_step(small, mesh, seq_len=24)
        assert tuple(args[1]["tokens"].shape) == (32, 24)
        got = step(*PS.shard_args((params, {"tokens": tokens}), in_sh)).full_tensor()
        with torch.no_grad():
            hidden, _ = PTF.forward(params, small, tokens, remat=False)
            want = PTF.hidden_to_logits(params, small, hidden[..., -1:, :])[..., 0, :]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

        step_d, args_d, in_d, _ = PS.build_decode_step(small, mesh)
        b = args_d[2].shape[0]
        prompt = torch.randint(0, small.vocab_size, (b, 8), generator=torch.Generator().manual_seed(2))
        _, cache = PTF.prefill_cache(params, small, prompt, 64)
        cache_ref = PS.shard_rules.map_with_path(lambda _, t: t.clone(), cache)
        nxt = torch.randint(0, small.vocab_size, (b, 1), generator=torch.Generator().manual_seed(3))
        pos = torch.tensor(8, dtype=torch.int32)
        logits, cache2 = step_d(*PS.shard_args((params, cache, nxt, pos), in_d))
        want_l, cache_ref = PTF.decode_step(params, small, cache_ref, nxt, 8)
        torch.testing.assert_close(logits.full_tensor(), want_l, rtol=1e-5, atol=1e-6)
        for (_, a), (_, w) in zip(tree_leaves(cache2), tree_leaves(cache_ref)):
            torch.testing.assert_close(a.full_tensor(), w, rtol=1e-5, atol=1e-6)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------- backends at (2, 2), 4 ranks
def _rank_backends(rank: int, np_args) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import steps as S

    sh = dict(S.SHAPES)
    sh["train_4k"] = dataclasses.replace(sh["train_4k"], seq_len=64, global_batch=4)
    S.SHAPES = sh
    S.n_fl_nodes = lambda multi_pod=False: 2
    cfg = dataclasses.replace(get_reduced_config("qwen2p5_3b"), **SMALL)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for backend in ("dense", "sparse", "ppermute"):
        step, args, in_sh, _ = S.build_train_step(cfg, mesh, mixing=backend, optimizer=sgd(LR, 0.5))
        p2, _, loss = step(*S.shard_args(_port_args(np_args, args), in_sh))
        out[backend] = (_np_tree(p2), float(loss.full_tensor()))
    return out


def test_backends_agree_on_four_gloo_ranks(jax_round):
    np_args, want, want_loss = jax_round
    ranks = spawn_ranks(_rank_backends, 4, np_args, timeout=SPAWN_TIMEOUT)
    for r, got in enumerate(ranks):
        for backend, (params, loss) in got.items():
            np.testing.assert_allclose(loss, want_loss, err_msg=f"rank {r} {backend}", **TRAJ)
            for k in want:
                np.testing.assert_allclose(params[k], ranks[0]["dense"][0][k], err_msg=f"rank {r} {backend} {k}",
                                           **BACKENDS)
                np.testing.assert_allclose(params[k], want[k], err_msg=f"rank {r} {backend} {k}", **TRAJ)


# ------------------------------------ serving and training steps at (1, 4)
def _rank_model4(rank: int, kv_heads: int) -> dict:
    """The steps at (1, 4) and their unsharded counterparts: name → (got, want)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import topology
    from repro_torch.core.commplan import compile_plan
    from repro_torch.launch import steps as S

    sh = dict(S.SHAPES)
    sh["train_4k"] = dataclasses.replace(sh["train_4k"], seq_len=64, global_batch=4)
    sh["decode_32k"] = dataclasses.replace(sh["decode_32k"], seq_len=64, global_batch=4)
    S.SHAPES = sh
    S.n_fl_nodes = lambda multi_pod=False: 2
    cfg = dataclasses.replace(get_reduced_config("qwen2p5_3b"), n_heads=8, n_kv_heads=kv_heads, head_dim=16)
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    params = PTF.init_params(3, cfg, InitConfig("trunc_normal", 1.0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    out = {}

    tokens = torch.randint(0, cfg.vocab_size, (32, 24), generator=gen)
    step, _, in_sh, _ = S.build_prefill_step(cfg, mesh, seq_len=24)
    got = step(*S.shard_args((params, {"tokens": tokens}), in_sh)).full_tensor()
    with torch.no_grad():
        hidden, _ = PTF.forward(params, cfg, tokens, remat=False)
        out["prefill"] = (got, PTF.hidden_to_logits(params, cfg, hidden[..., -1:, :])[..., 0, :])

    step_d, args_d, in_d, _ = S.build_decode_step(cfg, mesh)
    b = args_d[2].shape[0]
    _, cache = PTF.prefill_cache(params, cfg, torch.randint(0, cfg.vocab_size, (b, 8), generator=gen), 64)
    cache_ref = S.shard_rules.map_with_path(lambda _, t: t.clone(), cache)
    nxt = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen)
    logits, cache2 = step_d(*S.shard_args((params, cache, nxt, torch.tensor(8, dtype=torch.int32)), in_d))
    want_l, cache_ref = PTF.decode_step(params, cfg, cache_ref, nxt, 8)
    out["decode"] = (logits.full_tensor(), want_l)
    for (p, a), (_, w) in zip(tree_leaves(cache2), tree_leaves(cache_ref)):
        out[f"cache {p}"] = (a.full_tensor(), w)

    step_t, args_t, in_t, _ = S.build_train_step(cfg, mesh, mixing="dense", optimizer=sgd(LR, 0.5))
    nodes = PTF.init_params(4, cfg, InitConfig("trunc_normal", torch.ones(2)), device="cpu")
    zeros = type(args_t[1])(*(S.shard_rules.map_with_path(lambda _, t: torch.zeros_like(t), nodes)
                              for _ in args_t[1]))
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 1, 2, 64), generator=gen) for k in ("tokens", "targets")}
    p2, _, loss = step_t(*S.shard_args((nodes, zeros, batch), in_t))
    stepped, losses = [], []
    for j in range(2):
        p_j = S.shard_rules.map_with_path(lambda _, t: t[j].detach().requires_grad_(True), nodes)
        hidden, aux = PTF.forward(p_j, cfg, batch["tokens"][j, 0])
        loss_j = PTF.lm_loss(p_j, cfg, hidden, batch["targets"][j, 0]) + PTF.AUX_WEIGHT * aux
        leaves_j = [t for _, t in tree_leaves(p_j)]
        grads = torch.autograd.grad(loss_j, leaves_j)
        stepped.append([(t - LR * g).detach() for t, g in zip(leaves_j, grads)])
        losses.append(float(loss_j.detach()))
    want_t = [torch.stack(rows) for rows in zip(*stepped)]
    leaves = [path for path, _ in tree_leaves(nodes)]
    want_t = compile_plan(topology.complete(2), "dense", device="cpu").mix(
        S.shard_rules.map_with_path(lambda path, _: want_t[leaves.index(path)], nodes))
    for (p, a), (_, w) in zip(tree_leaves(p2), tree_leaves(want_t)):
        out[f"train {p}"] = (a.full_tensor(), w)
    out["train loss"] = (loss.full_tensor(), torch.tensor(sum(losses) / 2))
    return {k: (a.detach().float().numpy(), w.detach().float().numpy()) for k, (a, w) in out.items()}


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_steps_at_a_model_axis_wider_than_kv_heads(kv_heads):
    ranks = spawn_ranks(_rank_model4, 4, kv_heads, timeout=SPAWN_TIMEOUT)
    for r, got in enumerate(ranks):
        assert {"prefill", "decode", "train loss"} <= set(got)
        for name, (a, w) in got.items():
            np.testing.assert_allclose(a, w, err_msg=f"rank {r} {name}", **TRAJ)
