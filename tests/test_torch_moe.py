"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``moe_forward`` on the same numpy inputs, the reduced granite-moe-1b-a400m
(E 4, top 2), and the ``--model moe`` CLI.

fp32 at ``TOL`` (rtol 1e-4, atol 1e-5): y and the aux loss, at the
configured capacity factor, at 0.5 (pairs drop; the dropped set is the one
the JAX routing drops) and with zero rows (every logit equal: ``top_k``'s
ties go to the lower expert id, and the tied pairs take capacity from the
others).  In bf16 the expert products round differently in the two
frameworks (a dense bf16 FFN differs by one bf16 ulp too), so the whole
call is held to two bf16 ulps of the output's scale, and the combine alone
bitwise: on the same expert outputs it equals the JAX scatter-add, whose
updates round in bf16 one at a time in ascending expert id, and differs
from one fp32 sum rounded once.  One node's loss (lm + 0.01·aux) and its
gradient against ``jax.value_and_grad``; ``node_loss`` a node at a time
against ``jax.vmap`` (capacity per node).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced_config as jreduced  # noqa: E402
from repro.core.initialisation import InitConfig as JInitConfig  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_reduced_config as preduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.initialisation import InitConfig  # noqa: E402
from repro_torch.flat import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import train as p_cli  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402
from repro_torch.obs import read_run_log, validate_run_log  # noqa: E402
from test_torch_transformer import numpy_params  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
GRANITE = "granite-moe-1b-a400m"
BF16_ULP = 2.0**-7  # relative spacing of bf16 values


def setup_module(module):
    torch.set_num_threads(1)


def cfg_pair(**changes):
    return (dataclasses.replace(jreduced(GRANITE), **changes), dataclasses.replace(preduced(GRANITE), **changes))


def moe_params(seed: int = 0):
    jcfg = jreduced(GRANITE)
    shapes = jax.eval_shape(lambda k: JM.init_moe(JInitConfig(), k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: (rng.standard_normal(s.shape) / math.sqrt(s.shape[-2])).astype(np.float32),
                                  shapes)


def tokens_x(seed: int, zero_rows: int = 0):
    x = np.random.default_rng(seed).standard_normal((2, 40, 128)).astype(np.float32)
    x[0, :zero_rows] = 0.0
    return x


def jax_routing(jcfg, p, x):
    """The JAX moe_forward's routing steps (``repro/models/moe.py:66-84``) on
    the same inputs: its top-k experts and its dropped (token, expert) pairs."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    t, e, k = xt.shape[0], jcfg.n_experts, jcfg.experts_per_token
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt, jnp.asarray(p["router"]["w"])).astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se, st = flat_e[order], jnp.repeat(jnp.arange(t), k)[order]
    pos = jnp.arange(t * k) - jnp.searchsorted(se, jnp.arange(e), side="left")[se]
    drop = pos >= JM._capacity(jcfg, t)
    return np.asarray(idx), {(int(a), int(b)) for a, b, d in zip(st, se, drop) if d}


def port_dropped(r):
    e_sorted = r.idx.reshape(-1)[r.order]
    return {(int(a), int(b)) for a, b, k in zip(r.st, e_sorted, r.keep) if not k}


CASES = {
    # name: (capacity factor, zero rows in the batch's first sequence)
    "cf1.25": (1.25, 0),
    "cf0.5_drops": (0.5, 0),
    "zero_rows_ties": (0.5, 24),
}


@pytest.mark.parametrize("name", list(CASES))
def test_moe_forward_matches_jax(name):
    cf, zeros = CASES[name]
    jcfg, pcfg = cfg_pair(capacity_factor=cf)
    p, x = moe_params(1), tokens_x(2, zeros)
    yj, aj = jax.jit(lambda p, x: JM.moe_forward(p, jcfg, x))(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    pt = tree_map(torch.as_tensor, p)
    yp, ap = PM.moe_forward(pt, pcfg, torch.as_tensor(x))
    assert yp.shape == x.shape and yp.dtype == torch.float32 and ap.dtype == torch.float32
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(ap), float(aj), **TOL)
    # the routing: the JAX top-k experts and the same dropped pairs
    xt = torch.as_tensor(x).reshape(-1, 128)
    t = xt.shape[0]
    r = PM.route(torch.softmax(xt @ pt["router"]["w"], -1), pcfg.experts_per_token, PM._capacity(pcfg, t))
    idx_j, dropped_j = jax_routing(jcfg, p, x)
    np.testing.assert_array_equal(r.idx.numpy(), idx_j)
    assert port_dropped(r) == dropped_j
    assert int(r.counts.sum()) == t * pcfg.experts_per_token
    if cf < 1:
        assert len(dropped_j) > 0
    if zeros:
        # every logit of a zero row is equal: top_k takes experts 0, 1
        np.testing.assert_array_equal(r.idx.numpy()[:zeros], np.tile(np.arange(2), (zeros, 1)))
        assert (r.gate.numpy()[:zeros] == 0.5).all()


def test_capacity_matches_jax():
    for cf in (0.5, 1.0, 1.25, 2.0):
        jcfg, pcfg = cfg_pair(capacity_factor=cf)
        for t in (1, 2, 4, 7, 80, 512, 8192):
            assert PM._capacity(pcfg, t) == JM._capacity(jcfg, t)
    # full-width granite at a 4 × 2048 prefill: 65,536 pairs over 32 experts
    from repro_torch.configs import get_config

    assert PM._capacity(get_config(GRANITE), 4 * 2048) == 2560


def test_moe_forward_bf16_matches_jax():
    jcfg, pcfg = cfg_pair(dtype="bfloat16")
    p, x = moe_params(3), tokens_x(4, 8)
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    yj, aj = jax.jit(lambda p, x: JM.moe_forward(p, jcfg, x))(pj, jnp.asarray(x, jnp.bfloat16))
    yp, ap = PM.moe_forward(tree_map(lambda a: torch.as_tensor(a).to(torch.bfloat16), p), pcfg,
                            torch.as_tensor(x).to(torch.bfloat16))
    assert yp.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    want = np.asarray(yj, np.float32)
    scale = float(np.abs(want).max())
    assert np.abs(yp.float().numpy() - want).max() <= 2 * BF16_ULP * scale
    np.testing.assert_allclose(float(ap), float(aj), rtol=1e-3)


def test_combine_adds_in_the_jax_scatter_order_in_bf16():
    """On the same expert outputs, the combine equals the JAX package's
    ``out.at[st].add(y[dest] * gate)`` bitwise in bf16 (the updates added
    one at a time in ascending expert id), and differs from the same terms
    summed in fp32 and rounded once."""
    rng = np.random.default_rng(0)
    t, e, k, d, cap = 64, 8, 4, 32, 24
    probs = torch.softmax(torch.as_tensor(rng.standard_normal((t, e)).astype(np.float32)) * 3, -1)
    r = PM.route(probs, k, cap)
    assert int((~r.keep).sum()) > 0
    y = (rng.standard_normal((e * cap, d)) * np.exp2(rng.integers(-8, 8, (e * cap, 1)))).astype(np.float32)
    got = PM.combine(torch.as_tensor(y).to(torch.bfloat16), r).float().numpy()
    st, dest, keep, order = (jnp.asarray(a.numpy()) for a in (r.st, r.dest, r.keep, r.order))
    pair_gate = jnp.where(keep, jnp.asarray(r.gate.numpy()).reshape(-1)[order], 0.0)
    terms = jax.jit(lambda y, g: y[jnp.clip(dest, 0, e * cap - 1)] * g[:, None].astype(y.dtype))(
        jnp.asarray(y, jnp.bfloat16), pair_gate)
    want = np.asarray(jax.jit(lambda terms: jnp.zeros((t, d), terms.dtype).at[st].add(terms))(terms), np.float32)
    np.testing.assert_array_equal(got, want)
    once = np.zeros((t, d), np.float32)
    np.add.at(once, np.asarray(st), np.asarray(terms, np.float32))
    once = np.asarray(jnp.asarray(once).astype(jnp.bfloat16), np.float32)
    assert (once != want).sum() > 0


def test_init_moe_layout_and_fans():
    jcfg, pcfg = cfg_pair(d_model=256, d_ff=512, n_experts=3)
    want = jax.tree_util.tree_map(np.shape, jax.eval_shape(lambda k: JM.init_moe(JInitConfig(), k, jcfg),
                                                           jax.random.PRNGKey(0)))
    gains = torch.tensor([1.0, 3.0])
    p = PM.init_moe(InitConfig("trunc_normal", gains), torch.Generator().manual_seed(0), pcfg, (2,))
    assert tree_map(lambda t: tuple(t.shape[1:]), p) == want
    trunc_std = 0.87962566  # std of N(0, 1) truncated at ±2
    for name, fan_in in (("w_gate", 256), ("w_in", 256), ("w_out", 512)):
        for node, gain in enumerate(gains.tolist()):
            for expert in range(3):
                w = p[name]["w"][node, expert]
                assert abs(float(w.std()) / (trunc_std * gain / math.sqrt(fan_in)) - 1) < 0.03, (name, node, expert)


def _granite_loss_jax(jcfg, p, x, y):
    hidden, aux = JTF.forward(p, jcfg, x)
    return JTF.lm_loss(p, jcfg, hidden, y) + 0.01 * aux


def test_node_loss_and_gradient_match_jax():
    """One node's loss lm + 0.01·aux and its gradient against
    ``jax.value_and_grad``; the per-node loss of a 2-node ensemble (one
    forward a node: capacity from one node's B·S tokens) against
    ``jax.vmap`` of the JAX loss."""
    jcfg, pcfg = cfg_pair()
    rng = np.random.default_rng(7)
    x = rng.integers(0, jcfg.vocab_size, (2, 2, 24)).astype(np.int32)
    y = rng.integers(0, jcfg.vocab_size, (2, 2, 24)).astype(np.int32)
    one = numpy_params(jcfg, seed=4)
    lj, gj = jax.jit(jax.value_and_grad(lambda p: _granite_loss_jax(jcfg, p, jnp.asarray(x[0]), jnp.asarray(y[0]))))(
        jax.tree_util.tree_map(jnp.asarray, one))
    pt = tree_map(lambda t: t.requires_grad_(True), params_from_numpy(one, device="cpu"))
    hidden, aux = PTF.forward(pt, pcfg, torch.as_tensor(x[0]))
    assert float(aux.detach()) > 0
    loss = PTF.lm_loss(pt, pcfg, hidden, torch.as_tensor(y[0])) + PTF.AUX_WEIGHT * aux
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    grads = [t.grad.numpy() for _, t in tree_leaves(pt)]
    want = jax.tree_util.tree_leaves(gj)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30)
    # two nodes, one forward each
    stacked = numpy_params(jcfg, seed=5, n_nodes=2)
    want = jax.jit(jax.vmap(lambda p, a, b: _granite_loss_jax(jcfg, p, a, b)))(
        jax.tree_util.tree_map(jnp.asarray, stacked), jnp.asarray(x), jnp.asarray(y))
    got = PTF.node_loss(pcfg)(params_from_numpy(stacked, device="cpu"), (torch.as_tensor(x), torch.as_tensor(y)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("argv", [
    ["--model", "moe", "--compress", "int8"],
    ["--arch", GRANITE, "--reduced"],
    ["--arch", "stablelm-12b", "--reduced"],
    ["--arch", "qwen1.5-4b", "--reduced"],
])
def test_moe_and_new_arch_cli_paths(argv, tmp_path, capsys):
    """``--model moe`` through the executor (token windows, int8 rounds, a
    run log), as ``--model transformer``; the new configs through ``--arch
    --reduced`` (the host-fed loop)."""
    path = tmp_path / "run.jsonl"
    common = ["--nodes", "2", "--rounds", "2", "--local-batches", "1", "--batch-size", "2", "--device", "cpu",
              "--telemetry", str(path)]
    if argv[0] == "--model":
        common += ["--items-per-node", "8", "--seq-len", "16"]
    hist = p_cli.main([*argv, *common])
    recs = read_run_log(path)
    assert validate_run_log(recs) == []
    out = capsys.readouterr().out
    assert hist["round"] == [0, 1] and np.isfinite(hist["train_loss"]).all()
    if argv[0] == "--model":
        assert [r["kind"] for r in recs] == ["manifest", "round", "round", "summary", "gossip_health"]
        assert "token model granite-moe-1b-a400m: 0.36M params/node, seq 16" in out
        assert hist["wire_messages"] == [2, 2] and np.isfinite(hist["test_loss"]).all()
    else:
        assert "round    1 train" in out and hist["test_loss"] == []
