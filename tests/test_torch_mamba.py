"""The port's mamba block (``repro_torch.models.mamba``) against the JAX
package's ``repro/models/mamba.py`` on the reduced jamba-1.5-large-398b
(d_model 128, d_inner 256, N 8), fp32, on the same numpy-seeded parameters.

The JAX package scans each chunk of 256 tokens with
``jax.lax.associative_scan``, the port with a doubling scan, and its
prefill scans the whole prompt in one: the same products summed in other
orders, so outputs and caches are held to ``TOL`` (rtol 1e-4, atol 1e-5),
on prompts longer than one chunk (the state carried across a chunk
boundary).  The conv taps add in the JAX order, but jitted XLA contracts
them into FMAs: the conv's activations to ``TOL`` too, its carry bitwise.
The initialiser: the tree's names, shapes and dtypes (fp32 ``a_log``,
``dt_bias`` and ``d_skip`` in a bf16 model), ``a_log`` exactly log(1..N)
correctly rounded (one ulp from the JAX array at log 7), the step
softplus(dt_bias) log-uniform on [1e-3, 1e-1], and the structured leaves
the same at any gain (only the four projections are gain-corrected).
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
from repro.models import mamba as JMB  # noqa: E402
from repro_torch.configs import get_reduced_config as preduced  # noqa: E402
from repro_torch.core.initialisation import InitConfig  # noqa: E402
from repro_torch.flat import tree_map  # noqa: E402
from repro_torch.models import mamba as PMB  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
JAMBA = "jamba-1.5-large-398b"
STRUCTURED = ("a_log", "conv_w", "conv_b", "dt_bias", "d_skip")
PROJECTIONS = ("in_proj", "x_proj", "dt_proj", "out_proj")


def setup_module(module):
    torch.set_num_threads(1)


def cfg_pair(**changes):
    return dataclasses.replace(jreduced(JAMBA), **changes), dataclasses.replace(preduced(JAMBA), **changes)


def mamba_numpy_params(jcfg, seed: int = 0, lead: tuple[int, ...] = ()) -> dict:
    """A mamba block's numpy parameters in the JAX layout, with values of
    the init's kind: projections normal / √fan_in, ``a_log`` the S4D-real
    spectrum perturbed, ``dt_bias`` the inverse softplus of a log-uniform
    step, ``conv_w`` uniform, ``conv_b`` small, ``d_skip`` near one."""
    shapes = jax.eval_shape(lambda k: JMB.init_mamba(JInitConfig(), k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(name, s):
        shape = lead + s.shape
        if name == "a_log":
            return (np.log(np.arange(1, s.shape[-1] + 1)) + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), shape))
            return (dt + np.log(-np.expm1(-dt))).astype(np.float32)
        if name == "conv_w":
            return (rng.uniform(-1, 1, shape) / math.sqrt(s.shape[0])).astype(np.float32)
        if name == "conv_b":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "d_skip":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (rng.standard_normal(shape) / math.sqrt(s.shape[-2])).astype(np.float32)

    return {k: ({"w": draw(k, v["w"])} if isinstance(v, dict) else draw(k, v)) for k, v in shapes.items()}


def _both(params):
    return tree_map(torch.as_tensor, params), jax.tree_util.tree_map(jnp.asarray, params)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ init
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_jax(dtype):
    jcfg, pcfg = cfg_pair(dtype=dtype)
    want = jax.eval_shape(lambda k: JMB.init_mamba(JInitConfig(), k, jcfg), jax.random.PRNGKey(0))
    got = PMB.init_mamba(InitConfig("trunc_normal"), torch.Generator().manual_seed(0), pcfg)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]["w"] if isinstance(w, dict) else got[name]
        w = w["w"] if isinstance(w, dict) else w
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
    for name in ("a_log", "dt_bias", "d_skip"):
        assert got[name].dtype == torch.float32
    # a node-stacked, period-stacked draw: every leaf gets the lead axes
    stacked = PMB.init_mamba(InitConfig("trunc_normal", torch.tensor([1.0, 2.0])), torch.Generator().manual_seed(0),
                             pcfg, lead=(2, 3))
    assert all(tuple(t.shape[:2]) == (2, 3) for t in (stacked["a_log"], stacked["conv_w"], stacked["in_proj"]["w"]))


def test_init_structured_leaves():
    """``a_log`` log(1..N) correctly rounded; the step softplus(dt_bias)
    log-uniform on [1e-3, 1e-1] (the JAX draw's law: mean and spread of its
    log within 2%); conv_w uniform(-1, 1)/√dc; conv_b zero, d_skip one; the
    structured leaves the same at gain 1 and gain 5, the projections 5 times
    the gain-1 draw."""
    jcfg, pcfg = cfg_pair(d_model=512)
    p1 = PMB.init_mamba(InitConfig("trunc_normal", 1.0), torch.Generator().manual_seed(3), pcfg)
    p5 = PMB.init_mamba(InitConfig("trunc_normal", 5.0), torch.Generator().manual_seed(3), pcfg)
    want = JMB.init_mamba(JInitConfig("trunc_normal"), jax.random.PRNGKey(0), jcfg)
    # log(1..N) correctly rounded; XLA's CPU log gives log 7 one ulp above
    np.testing.assert_array_equal(p1["a_log"].numpy(), np.broadcast_to(
        np.log(np.arange(1, pcfg.mamba_d_state + 1, dtype=np.float64)).astype(np.float32), p1["a_log"].shape))
    np.testing.assert_array_max_ulp(p1["a_log"].numpy(), np.asarray(want["a_log"]), maxulp=1)
    log_dt = torch.log(torch.nn.functional.softplus(p1["dt_bias"].double()))
    lo, hi = math.log(1e-3), math.log(0.1)
    assert float(log_dt.min()) >= lo - 1e-6 and float(log_dt.max()) <= hi + 1e-6
    assert abs(float(log_dt.mean()) / ((lo + hi) / 2) - 1) < 0.02
    assert abs(float(log_dt.std()) / ((hi - lo) / math.sqrt(12)) - 1) < 0.02
    dc = pcfg.mamba_d_conv
    assert float(p1["conv_w"].abs().max()) <= 1 / math.sqrt(dc)
    assert abs(float(p1["conv_w"].std()) / (1 / math.sqrt(3 * dc)) - 1) < 0.05
    assert float(p1["conv_b"].abs().max()) == 0.0 and float(p1["d_skip"].min()) == float(p1["d_skip"].max()) == 1.0
    for name in STRUCTURED:
        assert torch.equal(p1[name], p5[name]), name
    for name in PROJECTIONS:
        torch.testing.assert_close(p5[name]["w"], 5.0 * p1[name]["w"], rtol=1e-6, atol=0)


# ------------------------------------------------------------------ blocks
def test_conv1d_matches_jax():
    """The carry bitwise; the activations to TOL: the taps add in the JAX
    order, but jitted XLA contracts them into FMAs (4.8e-7 here) and its
    silu rounds differently by an ulp."""
    jcfg, pcfg = cfg_pair()
    pt, pj = _both(mamba_numpy_params(jcfg, seed=1))
    di = jcfg.mamba_expand * jcfg.d_model
    x, carry = _x(2, (2, 37, di)), _x(3, (2, jcfg.mamba_d_conv - 1, di))
    for c in (None, carry):
        out, tail = PMB._conv1d(pt, torch.as_tensor(x), None if c is None else torch.as_tensor(c))
        out_j, tail_j = jax.jit(JMB._conv1d)(pj, jnp.asarray(x), None if c is None else jnp.asarray(c))
        np.testing.assert_array_equal(tail.numpy(), np.asarray(tail_j))
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)


def test_ssm_params_match_jax():
    jcfg, pcfg = cfg_pair()
    pt, pj = _both(mamba_numpy_params(jcfg, seed=4))
    xc = _x(5, (2, 19, jcfg.mamba_expand * jcfg.d_model))
    got = PMB._ssm_params(pt, pcfg, torch.as_tensor(xc))
    want = jax.jit(lambda p, x: JMB._ssm_params(p, jcfg, x))(pj, jnp.asarray(xc))
    assert PMB._dt_rank(pcfg) == JMB._dt_rank(jcfg) == 8
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("seq", [1, 77, 300, 513])
def test_forward_and_prefill_match_jax(seq):
    """Past one chunk (256) and past two: the state carried across chunk
    boundaries; the prefill's cache is the conv tail and the state after the
    last token, as the JAX single-chunk prefill's."""
    jcfg, pcfg = cfg_pair()
    pt, pj = _both(mamba_numpy_params(jcfg, seed=seq))
    x = _x(seq + 1, (2, seq, jcfg.d_model))
    got = PMB.mamba_forward(pt, pcfg, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(lambda p, x: JMB.mamba_forward(p, jcfg, x))(
        pj, jnp.asarray(x))), **TOL)
    out, cache = PMB.mamba_prefill(pt, pcfg, torch.as_tensor(x))
    out_j, cache_j = jax.jit(lambda p, x: JMB.mamba_prefill(p, jcfg, x))(pj, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
    assert sorted(cache) == sorted(cache_j) == ["conv", "ssm"]
    for name in cache:
        assert cache[name].dtype == torch.float32 and tuple(cache[name].shape) == cache_j[name].shape
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(cache_j[name]), **TOL)
    torch.testing.assert_close(out, got, rtol=0, atol=0)


def test_decode_matches_jax_and_continues_the_prefill():
    """Four decode steps from the prefill's cache against the JAX steps
    from the JAX cache (outputs and caches); the cache is written in place
    and returned; steps from a zero cache give the prefill's outputs."""
    jcfg, pcfg = cfg_pair()
    pt, pj = _both(mamba_numpy_params(jcfg, seed=9))
    x = _x(10, (2, 260 + 4, jcfg.d_model))
    _, cache = PMB.mamba_prefill(pt, pcfg, torch.as_tensor(x[:, :260]))
    _, cache_j = jax.jit(lambda p, x: JMB.mamba_prefill(p, jcfg, x))(pj, jnp.asarray(x[:, :260]))
    step = jax.jit(lambda p, x, c: JMB.mamba_decode(p, jcfg, x, c))
    for t in range(260, 264):
        out, same = PMB.mamba_decode(pt, pcfg, torch.as_tensor(x[:, t : t + 1]), cache)
        assert same is cache
        out_j, cache_j = step(pj, jnp.asarray(x[:, t : t + 1]), cache_j)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
        for name in cache:
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(cache_j[name]), **TOL)
    cache0 = PMB.init_mamba_cache(pcfg, (2,))
    full = PMB.mamba_forward(pt, pcfg, torch.as_tensor(x[:, :6]))
    steps = torch.cat([PMB.mamba_decode(pt, pcfg, torch.as_tensor(x[:, t : t + 1]), cache0)[0] for t in range(6)], 1)
    torch.testing.assert_close(steps, full, **TOL)


def test_scan_records_gradients_like_jax():
    """The doubling scan is autograd-safe (no in-place write on a saved
    tensor): the gradient of a loss through ``mamba_forward`` over two
    chunks against ``jax.grad``."""
    jcfg, pcfg = cfg_pair()
    params = mamba_numpy_params(jcfg, seed=11)
    x = _x(12, (1, 270, jcfg.d_model))
    pt = tree_map(lambda t: torch.as_tensor(t).requires_grad_(), params)
    xt = torch.as_tensor(x).requires_grad_()
    (PMB.mamba_forward(pt, pcfg, xt).square().mean()).backward()
    gj = jax.jit(jax.grad(lambda p, x: jnp.mean(jnp.square(JMB.mamba_forward(p, jcfg, x))), argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj[1]), rtol=1e-4, atol=1e-7)
    for name, w in gj[0].items():
        g = pt[name]["w"].grad if isinstance(w, dict) else pt[name].grad
        w = np.asarray(w["w"] if isinstance(w, dict) else w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name
