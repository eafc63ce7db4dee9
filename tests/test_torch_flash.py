"""The port's flash attention on the CPU against the JAX package's.

On a CPU tensor ``flash_mha`` runs its plain version ``attention_ref``; both,
and the (B, S, H, hd) wrapper ``flash_attention``, are held against the JAX
Pallas kernel run in interpret mode and against its jnp oracle, on the same
numpy inputs: fp32 to 1e-5 (the two sum QKᵀ and PV in other orders).  The
CUDA kernel itself is held against ``attention_ref`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3); here its
arithmetic on fp32 inputs (``attention_split_ref``: 3×TF32 products, P
split) is held against the JAX package at the same 1e-5, and the rule that
picks its route (``route``) is checked.  hd 160 (stablelm-12b) has an
instance of its own; its route's arithmetic is held at hd 160 below.  Head
dims the kernel has no instance for (hd 30 of reduced qwen1.5-4b, 40 of
reduced stablelm-12b) run on the card zero-padded to the next instantiated
size with the true hd's scale (``with_padded_head_dim``); that rendering,
driven through ``attention_ref``, is held against the JAX package's any-hd
attention, at hd 160 too.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash.flash import flash_mha as jax_flash_mha  # noqa: E402
from repro.kernels.flash.ops import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.flash.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash import ROUTES, attention_ref, flash_attention, flash_mha, route  # noqa: E402
from repro_torch.kernels.flash.flash import padded_head_dim, with_padded_head_dim  # noqa: E402
from repro_torch.kernels.flash.ref import attention_split_ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

# (S, hd, KVH, causal, window) with H = 4: every S in {1, 7, 130}, hd in
# {8, 32}, KVH in {1, 2, 4} (group 4, 2, 1), causal and not, with and
# without a window (130 spans two of the JAX kernel's 128-blocks)
CASES = [
    (1, 8, 1, True, 0),
    (1, 32, 4, False, 0),
    (7, 8, 2, True, 3),
    (7, 32, 4, True, 0),
    (7, 32, 1, False, 4),
    (130, 32, 2, True, 0),
    (130, 8, 4, True, 50),
    (130, 32, 1, False, 0),
    (130, 32, 4, False, 64),
    (130, 8, 2, True, 128),
]


def _qkv(s, hd, kvh, b=2, h=4, seed=0):
    rng = np.random.default_rng(seed + 31 * s + hd + kvh)
    q = rng.standard_normal((b, h, s, hd)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("s,hd,kvh,causal,window", CASES)
def test_flash_matches_jax(s, hd, kvh, causal, window):
    q, k, v = _qkv(s, hd, kvh)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    want_kernel = np.asarray(jax_flash_mha(qj, kj, vj, causal=causal, window=window, interpret=True))
    want_ref = np.asarray(jax_attention_ref(qj, kj, vj, causal=causal, window=window))
    qt, kt, vt = map(torch.as_tensor, (q, k, v))
    before = flash_mha.launches
    got = flash_mha(qt, kt, vt, causal=causal, window=window)
    assert flash_mha.launches == before, "a CPU tensor must not launch the kernel"
    assert got.shape == (2, 4, s, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(attention_ref(qt, kt, vt, causal=causal, window=window).numpy(), want_ref, **TOL)
    # the (B, S, H, hd) wrapper, with a leading node axis folded into B
    sw = lambda a: np.swapaxes(a, 1, 2)  # noqa: E731
    got_bs = flash_attention(*(torch.as_tensor(sw(a)) for a in (q, k, v)), causal=causal, window=window)
    want_bs = np.asarray(
        jax_flash_attention(*(jnp.asarray(sw(a)) for a in (q, k, v)), causal=causal, window=window, interpret=True)
    )
    np.testing.assert_allclose(got_bs.numpy(), want_bs, **TOL)
    nodes = flash_attention(*(torch.as_tensor(sw(a)).reshape(1, *sw(a).shape) for a in (q, k, v)),
                            causal=causal, window=window)
    assert nodes.shape == (1, 2, s, 4, hd)
    np.testing.assert_allclose(nodes[0].numpy(), want_bs, **TOL)


def test_bf16_keeps_dtype():
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in _qkv(33, 32, 2))
    got = flash_mha(q, k, v)
    want = jax_attention_ref(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


def test_rejects_what_the_kernel_cannot_take():
    q, k, v = (torch.as_tensor(a) for a in _qkv(7, 32, 2))
    with pytest.raises(ValueError, match="multiple of KVH"):
        flash_mha(q, k[:, :0], v[:, :0])
    with pytest.raises(ValueError, match="multiple of KVH"):
        flash_mha(q[:, :3], k, v)
    with pytest.raises(TypeError):
        flash_mha(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="window"):
        flash_mha(q, k, v, window=-1)
    # a device that is neither cuda nor cpu is refused, never run on the CPU
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_mha(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("s,hd,kvh,causal,window", CASES)
def test_tf32x3_rendering_matches_jax(s, hd, kvh, causal, window):
    """The fp32 route's arithmetic: S and P·V each as three TF32 products of
    hi + lo parts (P split too), within 1e-5 of the Pallas kernel and the
    oracle on fp32 inputs."""
    q, k, v = _qkv(s, hd, kvh)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    got = attention_split_ref(*map(torch.as_tensor, (q, k, v)), causal=causal, window=window, split="tf32")
    assert got.dtype == torch.float32 and got.shape == (2, 4, s, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_flash_mha(qj, kj, vj, causal=causal, window=window, interpret=True)), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_attention_ref(qj, kj, vj, causal=causal, window=window)),
                               **TOL)


HD160_CASES = [(1, 1, True, 0), (37, 2, True, 0), (70, 4, True, 17), (70, 1, False, 0), (130, 2, True, 64)]


@pytest.mark.parametrize("s,kvh,causal,window", HD160_CASES)
def test_hd160_instance_arithmetic_matches_jax(s, kvh, causal, window):
    """hd 160 runs at its own width on the card, with no padded copy: the
    fp32 route's 3×TF32 arithmetic at hd 160 within 1e-5 of the JAX
    package's attention, and a CPU call counts no launch and no padding."""
    q, k, v = _qkv(s, 160, kvh)
    want = np.asarray(jax_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal, window=window))
    qt, kt, vt = map(torch.as_tensor, (q, k, v))
    got = attention_split_ref(qt, kt, vt, causal=causal, window=window, split="tf32")
    assert got.shape == (2, 4, s, 160)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    before = (flash_mha.launches, flash_mha.padded)
    np.testing.assert_allclose(flash_mha(qt, kt, vt, causal=causal, window=window).numpy(), want, **TOL)
    assert (flash_mha.launches, flash_mha.padded) == before
    assert padded_head_dim(160) == 160 and route(torch.bfloat16, 160) == "wgmma"


def test_bf16_split_misses_the_fp32_bound():
    """The bf16 hi + lo split the bf16 route uses for P leaves ~2^-17 of each
    term, which exp amplifies: on fp32 inputs it misses 1e-5 on some case,
    so the fp32 route splits into TF32 parts."""
    worst = 0.0
    for s, hd, kvh, causal, window in CASES:
        q, k, v = _qkv(s, hd, kvh)
        want = np.asarray(jax_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal, window=window))
        got = attention_split_ref(*map(torch.as_tensor, (q, k, v)), causal=causal, window=window, split="bf16")
        worst = max(worst, float((np.abs(got.numpy() - want) / (TOL["atol"] + TOL["rtol"] * np.abs(want))).max()))
    assert worst > 1.0, worst


# every (dtype, hd) goes to the Hopper kernel: bf16 to its wgmma route with
# bf16 products, fp32 to its 3×TF32 route
@pytest.mark.parametrize(
    "dtype,hd,want",
    [(torch.bfloat16, hd, "wgmma") for hd in (32, 64, 128, 160, 256)]
    + [(torch.float32, hd, "wgmma_tf32x3") for hd in (32, 64, 128, 160, 256)],
)
def test_route_is_picked_by_dtype_and_head_dim(dtype, hd, want):
    assert route(dtype, hd) == want
    assert want in ROUTES and set(flash_mha.launches_by_route) == set(ROUTES)


def test_cpu_calls_count_on_no_route():
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in _qkv(9, 64, 2))
    before = dict(flash_mha.launches_by_route)
    flash_mha(q, k, v)
    assert flash_mha.launches_by_route == before


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
@pytest.mark.parametrize("hd", [30, 40, 160])
def test_padded_head_dims_match_jax(hd, causal, window):
    """Zero-padding q, k and v on the head axis, scaling by 1/√hd and
    slicing the output back gives the unpadded attention: fp32 to 1e-5
    against the JAX package, bf16 to one bf16 rounding of the same."""
    q, k, v = _qkv(37, hd, 2)
    want = np.asarray(jax_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal, window=window))
    qt, kt, vt = map(torch.as_tensor, (q, k, v))
    got = with_padded_head_dim(attention_ref, qt, kt, vt, causal=causal, window=window)
    assert got.shape == (2, 4, 37, hd)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(flash_mha(qt, kt, vt, causal=causal, window=window).numpy(), want, **TOL)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (qt, kt, vt))
    got_b = with_padded_head_dim(attention_ref, qb, kb, vb, causal=causal, window=window)
    assert got_b.dtype == torch.bfloat16
    torch.testing.assert_close(got_b, attention_ref(qb, kb, vb, causal=causal, window=window), rtol=2.0**-7, atol=1e-5)


def test_padded_head_dim_is_the_next_instance():
    assert [padded_head_dim(hd) for hd in (8, 30, 32, 40, 64, 100, 128, 160, 200, 256)] == [
        32, 32, 32, 64, 64, 128, 128, 160, 256, 256]
    with pytest.raises(ValueError, match="head_dim 288 exceeds 256"):
        padded_head_dim(288)
