"""The paper's CNN (cfg B) and VGG16 (cfg C) against the JAX package on
injected numpy parameters: logits, per-node losses and gradients of the
node-stacked grouped-convolution forward against ``jax.vmap`` of the JAX
forwards (logits and losses to rtol 1e-5 / atol 1e-5 · max|want|, gradients
rtol 1e-4 / atol 1e-5 · max|want| of each leaf).  The CNN runs at full width (d
= 198,897), which guards the NHWC flatten order into ``fc0``; VGG16 at
``width_mult=0.125``.  Also: the per-node He draws, the parameter trees'
layout (leaf order, the flat row, the codecs' chunk tables) and the config
registry."""
import math

import jax
import jax.flatten_util  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.core import compress as JCm  # noqa: E402
from repro.core.initialisation import InitConfig as JInitConfig  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy, state_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import compress as PCm  # noqa: E402
from repro_torch.core.initialisation import InitConfig  # noqa: E402
from repro_torch.flat import FlatLayout  # noqa: E402
from repro_torch.kernels.mix import chunk_bounds  # noqa: E402
from repro_torch.models import paper_models as PPM  # noqa: E402

CNN_D = 198_897  # paper cfg B: 32/64/64 ch 3×3 on 32×32×10, FC 128/64/17
VGG16_D = 33_638_218  # paper cfg C at full width on 32×32×3, 10 classes
MODELS = {
    # name: (JAX init at a key, port init, JAX forward, port forward, image shape, classes)
    "cnn": (
        lambda k: JPM.init_cnn(JInitConfig(), k),
        lambda c, g: PPM.init_cnn(c, g),
        JPM.cnn_forward, PPM.cnn_forward, (32, 32, 10), 17,
    ),
    "vgg16": (
        lambda k: JPM.init_vgg16(JInitConfig(), k, width_mult=0.125),
        lambda c, g: PPM.init_vgg16(c, g, width_mult=0.125),
        JPM.vgg16_forward, PPM.vgg16_forward, (32, 32, 3), 10,
    ),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU products run fastest on one thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _flat_items(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _shapes(model):
    """Per-node leaf shapes of the JAX package's tree (no draw)."""
    tree = jax.eval_shape(MODELS[model][0], jax.random.PRNGKey(0))
    return _map(lambda s: tuple(s.shape), tree)


def _params_np(model, n, seed=0):
    """He-scaled numpy draws in the JAX layout, node-stacked, small random biases."""
    rng = np.random.default_rng(seed)

    def leaf(shape):
        if len(shape) == 1:
            return (0.1 * rng.standard_normal((n, *shape))).astype(np.float32)
        fan_in = math.prod(shape[:-1])
        return (rng.standard_normal((n, *shape)) * math.sqrt(2.0 / fan_in)).astype(np.float32)

    return _map(leaf, _shapes(model))


def _batch(model, n, b=4, seed=1):
    rng = np.random.default_rng(seed)
    shape, classes = MODELS[model][4], MODELS[model][5]
    return rng.standard_normal((n, b, *shape)).astype(np.float32), rng.integers(0, classes, (n, b)).astype(np.int32)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_forward_and_loss_match_jax(model):
    n = 3
    _, _, jfwd, pfwd, _, _ = MODELS[model]
    p = _params_np(model, n)
    x, y = _batch(model, n)
    pt, pj = _map(torch.as_tensor, p), _map(jnp.asarray, p)
    logits_j = jax.vmap(jfwd)(pj, jnp.asarray(x))
    logits_t = pfwd(pt, torch.as_tensor(x))
    assert logits_t.shape == logits_j.shape
    _close(logits_t.numpy(), logits_j, 1e-5)
    loss_j = jax.vmap(JPM.classifier_loss)(logits_j, jnp.asarray(y))
    _close(PPM.classifier_loss(logits_t, torch.as_tensor(y)).numpy(), loss_j, 1e-5)
    # the eval batch: one (B, H, W, C) batch shared by every node
    shared_j = jax.vmap(lambda q: jfwd(q, jnp.asarray(x[0])))(pj)
    _close(pfwd(pt, torch.as_tensor(x[0])).numpy(), shared_j, 1e-5)
    # one unstacked parameter set, the JAX package's own call
    one = _map(lambda a: a[1], p)
    _close(pfwd(_map(torch.as_tensor, one), torch.as_tensor(x[1])).numpy(),
           jfwd(_map(jnp.asarray, one), jnp.asarray(x[1])), 1e-5)


def test_cnn_flattens_nhwc():
    """fc0 reads the last 4×4×64 map in (h, w, c) order: a weight that picks
    one (h, w, c) feature must see that feature, not an NCHW neighbour."""
    n = 2
    p = _params_np("cnn", n, seed=4)
    p["fc0"]["w"][:] = 0.0
    p["fc0"]["b"][:] = 0.0
    h, w, c = 1, 2, 5
    p["fc0"]["w"][:, (h * 4 + w) * 64 + c, 0] = 1.0
    x, _ = _batch("cnn", n, seed=5)
    pt = _map(torch.as_tensor, p)
    got = PPM.cnn_forward(pt, torch.as_tensor(x))
    want = jax.vmap(JPM.cnn_forward)(_map(jnp.asarray, p), jnp.asarray(x))
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_per_node_gradients_match_jax(model):
    """One backward of the summed per-node losses through the flat buffer
    gives every node its own gradient (the grouped conv keeps nodes apart)."""
    n = 2
    _, _, jfwd, pfwd, _, _ = MODELS[model]
    p = _params_np(model, n, seed=2)
    x, y = _batch(model, n, seed=3)

    def loss_j(q, xb, yb):
        return JPM.classifier_loss(jfwd(q, xb), yb)

    grads_j = jax.vmap(jax.grad(loss_j))(_map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(y))
    tree = _map(torch.as_tensor, p)
    layout = FlatLayout.of(tree)
    flat = layout.flatten(tree).requires_grad_(True)
    losses = PPM.classifier_loss(pfwd(layout.views(flat), torch.as_tensor(x)), torch.as_tensor(y))
    (g,) = torch.autograd.grad(losses.sum(), flat)
    got = dict(_flat_items(layout.views(g)))
    for path, want in _flat_items(grads_j):
        _close(got[path].numpy(), want, 1e-4)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_he_draws_per_node_gains(model):
    """Every weight leaf of ≥ 10,000 elements a node: std within 2% of He's
    sqrt(2 / fan_in) × the node's gain; biases zero; nodes independent."""
    gains = torch.tensor([1.0, 2.0, 4.0])
    tree = MODELS[model][1](InitConfig("he_normal", gains), torch.Generator().manual_seed(7))
    assert _map(lambda t: tuple(t.shape[1:]), tree) == _shapes(model)
    checked = 0
    for path, leaf in _flat_items(tree):
        if path[-1] == "b":
            assert leaf.shape[0] == 3 and float(leaf.abs().max()) == 0.0
            continue
        per_node = leaf.reshape(3, -1)
        if per_node.shape[1] < 10_000:
            continue
        fan_in = math.prod(leaf.shape[1:-1])
        np.testing.assert_allclose((per_node.std(dim=1) / gains).numpy(), math.sqrt(2.0 / fan_in), rtol=0.02)
        assert abs(float(torch.corrcoef(per_node[:2])[0, 1])) < 0.03
        checked += 1
    assert checked >= 3
    single = MODELS[model][1](InitConfig("he_normal", 1.0), torch.Generator().manual_seed(7))
    assert single["conv0"]["w"].ndim == 4 and single["conv0"]["b"].ndim == 1


def test_layout_row_and_chunk_tables_are_the_jax_packages():
    """Leaf order (``conv10`` before ``conv2``), the flat row of node i as the
    JAX package's ``ravel_pytree`` of node i's tree, state conversion both
    ways bitwise, and the codecs' per-leaf chunk tables at chunk 2048."""
    for model, d_full in (("cnn", CNN_D), ("vgg16", None)):
        p = _params_np(model, 2, seed=6)
        state = state_from_numpy(p, device="cpu")
        paths = state.layout.paths
        assert paths == tuple(path for path, _ in _flat_items(p))
        if model == "vgg16":
            assert paths.index(("conv10", "b")) < paths.index(("conv2", "b"))
        for i in range(2):
            want = jax.flatten_util.ravel_pytree(_map(lambda a: jnp.asarray(a[i]), p))[0]
            np.testing.assert_array_equal(state.params[i].numpy(), np.asarray(want))
        back, _ = to_numpy(state)
        as_tensors = params_from_numpy(p, device="cpu")
        for path, leaf in _flat_items(p):
            np.testing.assert_array_equal(dict(_flat_items(back))[path], leaf)
            np.testing.assert_array_equal(dict(_flat_items(params_to_numpy(as_tensors)))[path], leaf)
        if d_full is not None:
            assert state.layout.size == d_full
        comp = JCm.Compression(codec="int8")
        wire = sum(comp.leaf_row_bytes(s, np.float32) for s in state.layout.sizes)
        n_chunks = chunk_bounds(state.layout.sizes, 2048).numel() - 1
        assert wire == state.layout.size + 4 * n_chunks


def test_vgg16_full_width_tree():
    """cfg C at width_mult 1.0: the JAX package's shapes (no draw), d =
    33,638,218 a node and its chunk table (≈ 16,400 chunks a node)."""
    want = _map(
        lambda s: tuple(s.shape),
        jax.eval_shape(lambda k: JPM.init_vgg16(JInitConfig(), k), jax.random.PRNGKey(0)),
    )
    sizes = [math.prod(s) for _, s in _flat_items(want)]
    assert sum(sizes) == VGG16_D
    n_chunks = chunk_bounds(sizes, 2048).numel() - 1
    assert n_chunks == sum(-(-s // 2048) for s in sizes)
    assert 16_300 < n_chunks < 16_500
    got = PPM.init_vgg16(InitConfig("he_normal", torch.ones(1)), torch.Generator().manual_seed(0))
    assert _map(lambda t: tuple(t.shape[1:]), got) == want


def test_int8_codec_on_a_cnn_tree_is_the_jitted_jax_codec():
    """The CNN's per-leaf chunks through the int8 codec, bitwise the jitted
    JAX codec (the chunk table the quantised round takes)."""
    p = _params_np("cnn", 2, seed=8)
    want = jax.jit(lambda t: JCm.encode_decode(t, JCm.Compression(codec="int8")))(_map(jnp.asarray, p))
    tree = _map(torch.as_tensor, p)
    layout = FlatLayout.of(tree)
    got = layout.views(PCm.encode_decode(layout.flatten(tree), PCm.Compression(codec="int8"), layout))
    got = dict(_flat_items(got))
    for path, w in _flat_items(want):
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(w))


def test_paper_configs_registry():
    assert pbase.list_archs() == jbase.list_archs()
    assert pbase.list_archs(include_paper=True)[-3:] == ["paper_mlp", "paper_cnn", "paper_vgg16"]
    for arch in ("paper_mlp", "paper_cnn", "paper_vgg16", "paper-cnn"):
        p, j = pbase.get_config(arch), jbase.get_config(arch)
        for field in ("name", "family", "source", "n_layers", "d_model", "d_ff", "vocab_size"):
            assert getattr(p, field) == getattr(j, field), (arch, field)
        assert pbase.get_reduced_config(arch) == p


def test_resolve_device_selects_deterministic_convolutions():
    """cuDNN's default weight-gradient convolutions accumulate with atomics;
    the port asks for its deterministic algorithms (and no TF32) wherever it
    resolves a device, so reruns of a CNN / VGG16 round are bit-identical."""
    from repro_torch.device import resolve_device

    before = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = False
        assert resolve_device("cpu") == torch.device("cpu")
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.deterministic = before
