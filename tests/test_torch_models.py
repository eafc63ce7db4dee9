"""The paper MLP, its loss and gradients, and the optimizers against the JAX
package on injected numpy parameters (fp32 to 1e-5); the port's own
initialiser draws against their distributions (sampling bounds)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import paper_models as JPM  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch.core.initialisation import InitConfig, he_normal, he_uniform, glorot_normal, trunc_normal  # noqa: E402
from repro_torch.flat import FlatLayout  # noqa: E402
from repro_torch.models import paper_models as PPM  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402

DIMS = [784, 32, 16, 10]


def _mlp_np(n, seed=0, dims=DIMS):
    rng = np.random.default_rng(seed)
    return {
        f"fc{i}": {
            "w": (rng.standard_normal((n, dims[i], dims[i + 1])) * math.sqrt(2.0 / dims[i])).astype(np.float32),
            "b": (0.1 * rng.standard_normal((n, dims[i + 1]))).astype(np.float32),
        }
        for i in range(len(dims) - 1)
    }


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _batch(n, b=8, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, b, 28, 28, 1)).astype(np.float32), rng.integers(0, 10, (n, b)).astype(np.int32)


def test_forward_and_loss_match_jax():
    n = 4
    p = _mlp_np(n)
    x, y = _batch(n)
    pt, pj = _map(torch.as_tensor, p), _map(jnp.asarray, p)
    logits_j = jax.vmap(JPM.mlp_forward)(pj, jnp.asarray(x))
    logits_t = PPM.mlp_forward(pt, torch.as_tensor(x))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=1e-5, rtol=1e-5)
    loss_j = jax.vmap(JPM.classifier_loss)(logits_j, jnp.asarray(y))
    loss_t = PPM.classifier_loss(logits_t, torch.as_tensor(y))
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), atol=1e-5, rtol=1e-5)
    acc_j = jax.vmap(JPM.accuracy)(logits_j, jnp.asarray(y))
    np.testing.assert_allclose(PPM.accuracy(logits_t, torch.as_tensor(y)).numpy(), np.asarray(acc_j))
    # one node's params and a flat (B, 784) batch: the JAX package's own call
    one = _map(lambda a: a[0], p)
    xf = x[0].reshape(8, 784)
    np.testing.assert_allclose(
        PPM.mlp_forward(_map(torch.as_tensor, one), torch.as_tensor(xf)).numpy(),
        np.asarray(JPM.mlp_forward(_map(jnp.asarray, one), jnp.asarray(xf))),
        atol=1e-5, rtol=1e-5,
    )
    # a test batch shared by every node broadcasts over the node axis
    shared = PPM.classifier_loss(PPM.mlp_forward(pt, torch.as_tensor(x[0])), torch.as_tensor(y[0]))
    want = jax.vmap(lambda q: JPM.classifier_loss(JPM.mlp_forward(q, jnp.asarray(x[0])), jnp.asarray(y[0])))(pj)
    np.testing.assert_allclose(shared.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_per_node_gradients_match_jax():
    """One backward of the summed per-node losses gives every node exactly
    its own gradient, in the flat buffer."""
    n = 3
    p = _mlp_np(n, 2)
    x, y = _batch(n, seed=3)

    def loss_j(q, xb, yb):
        return JPM.classifier_loss(JPM.mlp_forward(q, xb), yb)

    grads_j = jax.vmap(jax.grad(loss_j))(_map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(y))
    tree = _map(torch.as_tensor, p)
    layout = FlatLayout.of(tree)
    flat = layout.flatten(tree).requires_grad_(True)
    losses = PPM.classifier_loss(PPM.mlp_forward(layout.views(flat), torch.as_tensor(x)), torch.as_tensor(y))
    (g,) = torch.autograd.grad(losses.sum(), flat)
    got = layout.views(g)
    for k in p:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(got[k][leaf].numpy(), np.asarray(grads_j[k][leaf]), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("which", ["sgd", "adamw"])
def test_optimizer_steps_match_jax(which):
    n, d = 4, 257
    rng = np.random.default_rng(7)
    opt_j, opt_t = (jax_sgd(1e-3, 0.5), sgd(1e-3, 0.5)) if which == "sgd" else (jax_adamw(1e-3), adamw(1e-3))
    p = rng.standard_normal((n, d)).astype(np.float32)
    pj, pt = jnp.asarray(p), torch.as_tensor(p)
    sj, st = jax.vmap(opt_j.init)(pj), opt_t.init(pt)
    for step in range(4):
        g = rng.standard_normal((n, d)).astype(np.float32)
        uj, sj = jax.vmap(opt_j.update)(jnp.asarray(g), sj, pj)
        ut, st = opt_t.update(torch.as_tensor(g), st, pt)
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-7, rtol=1e-5)
        pj, pt = pj + uj, pt + ut
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=1e-5)
    if which == "adamw":
        np.testing.assert_array_equal(st.step.numpy(), np.asarray(sj.step))
        np.testing.assert_allclose(st.nu.numpy(), np.asarray(sj.nu), rtol=1e-5, atol=1e-9)
    else:
        np.testing.assert_allclose(st.momentum.numpy(), np.asarray(sj.momentum), rtol=1e-5, atol=1e-7)


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def test_initialiser_distributions():
    shape = (400, 300)
    fan_in = 400
    for gain in (1.0, 3.0):
        x = he_normal(_g(), shape, gain=gain)
        assert abs(float(x.std()) / (math.sqrt(2 / fan_in) * gain) - 1) < 0.02
        assert abs(float(x.mean())) < 5 * math.sqrt(2 / fan_in) * gain / math.sqrt(x.numel())
        u = he_uniform(_g(1), shape, gain=gain)
        limit = math.sqrt(6 / fan_in) * gain
        assert float(u.abs().max()) <= limit and abs(float(u.std()) / (limit / math.sqrt(3)) - 1) < 0.02
    gn = glorot_normal(_g(2), shape)
    assert abs(float(gn.std()) / math.sqrt(2 / 700) - 1) < 0.02
    # truncated at ±2 standard units, then scaled: std of N(0,1) | |z| < 2 is 0.8796
    s = math.sqrt(1 / fan_in) * 2.0
    t = trunc_normal(_g(3), shape, gain=2.0)
    assert float(t.abs().max()) <= 2 * s * (1 + 1e-6)
    assert abs(float(t.std()) / (0.87962566 * s) - 1) < 0.02
    assert float(t.abs().max()) > 1.9 * s


def test_per_node_gains_and_init_mlp():
    gains = torch.tensor([1.0, 2.0, 4.0])
    tree = PPM.init_mlp(InitConfig("he_normal", gains), _g(5))
    layout = FlatLayout.of(tree)
    assert layout.size == 567_434  # the paper MLP: 784→512→256→128→10
    assert tree["fc0"]["w"].shape == (3, 784, 512) and tree["fc3"]["b"].shape == (3, 10)
    assert all(float(tree[k]["b"].abs().max()) == 0 for k in tree)
    stds = tree["fc0"]["w"].reshape(3, -1).std(dim=1)
    np.testing.assert_allclose((stds / stds[0]).numpy(), gains.numpy(), rtol=0.02)
    np.testing.assert_allclose(float(stds[0]), math.sqrt(2 / 784), rtol=0.02)
    # nodes draw independently
    w = tree["fc1"]["w"].reshape(3, -1)
    assert abs(float(torch.corrcoef(w[:2])[0, 1])) < 0.02
    single = PPM.init_mlp(InitConfig("he_normal", 2.0), _g(5), hidden=(8,))
    assert single["fc0"]["w"].shape == (784, 8)
