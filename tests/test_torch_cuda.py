"""The hand-written mixing kernels against their plain versions on a CUDA
device, at shapes and layouts the main path does not reach: row groups and
M chunks past 64 nodes, every vector width, misaligned rows, bf16 through
the block-sparse kernel, tile sizes up to the limit, padding tiles the walk
must skip.  Skipped without a CUDA device; on the card run

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax, which the port's
machine need not have).  fp32 to 1e-5 · max|W| (one FMA chain against
cuBLAS's blocked sum), bf16 elementwise to one bf16 ulp (2^-7 · |ref|) plus
that atol, which a kernel accumulating in bf16 would exceed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import topology as T  # noqa: E402
from repro_torch.core.mixing import receive_matrix  # noqa: E402
from repro_torch.kernels.mix import bsr_from_dense, decavg_mix_ref, mix_bsr, mix_bsr_ref, mix_matmul  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, ref, w):
    assert got.dtype == w.dtype and got.shape == ref.shape
    atol = 1e-5 * max(float(w.float().abs().max()), 1.0)
    if w.dtype == torch.bfloat16:
        # one bf16 ulp: both sides sum in fp32 and round once to bf16
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=2.0**-7)
    else:
        assert float((got - ref).abs().max()) <= atol


def _stochastic(n, dev, seed=0):
    m = np.random.default_rng(seed).random((n, n)).astype(np.float32)
    return torch.as_tensor(m / m.sum(1, keepdims=True), device=dev)


@pytest.mark.parametrize("n", [1, 8, 33, 100, 300])
@pytest.mark.parametrize("d", [1, 6, 7, 1000, 4097])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_kernel_matches_plain(dev, n, d, dtype):
    m = _stochastic(n, dev, n + d)
    w = torch.randn(n, d, device=dev).to(dtype)
    before = mix_matmul.launches
    got = mix_matmul(m, w)
    assert mix_matmul.launches == before + 1
    _close(got, decavg_mix_ref(m, w), w)
    assert torch.equal(got, mix_matmul(m, w))


def test_dense_kernel_misaligned_rows(dev):
    """A W that starts one element into its allocation takes the scalar path."""
    n, d = 16, 1000
    buf = torch.randn(n * d + 1, device=dev)
    w = buf[1:].view(n, d)
    m = _stochastic(n, dev)
    _close(mix_matmul(m, w), decavg_mix_ref(m, w), w)


@pytest.mark.parametrize(
    "graph,bn",
    [(T.ring(200), 8), (T.ring(200), 16), (T.random_k_regular(300, 4, seed=0), 64),
     (T.configuration_heavy_tail(150, 2.2, seed=1), 128), (T.complete(70), 256),
     (T.torus_lattice((8, 9)), 5)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_kernel_matches_plain(dev, graph, bn, dtype):
    m = receive_matrix(graph).astype(np.float32)
    bc, tiles, counts = (torch.as_tensor(a, device=dev) for a in bsr_from_dense(m, bn))
    w = torch.randn(graph.n, 777, device=dev).to(dtype)
    before = mix_bsr.launches
    got = mix_bsr(bc, tiles, counts, w)
    assert mix_bsr.launches == before + 1
    _close(got, mix_bsr_ref(bc, tiles, counts, w), w)
    _close(got, decavg_mix_ref(torch.as_tensor(m, device=dev), w), w)
    assert torch.equal(got, mix_bsr(bc, tiles, counts, w))


def test_bsr_kernel_skips_padding_tiles(dev):
    g = T.configuration_heavy_tail(40, 2.2, seed=0)
    m = receive_matrix(g).astype(np.float32)
    bc, tiles, counts = (torch.as_tensor(a, device=dev) for a in bsr_from_dense(m, 8))
    dirty = tiles.clone()
    for i, c in enumerate(counts.tolist()):
        dirty[i, c:] = float("nan")
    w = torch.randn(40, 100, device=dev)
    assert torch.equal(mix_bsr(bc, dirty, counts, w), mix_bsr(bc, tiles, counts, w))


def test_plan_rounds_launch_once(dev):
    from repro_torch.core.commplan import FailureModel, compile_plan

    g = T.ring(100)
    for backend, kernel in (("dense", mix_matmul), ("sparse", mix_bsr)):
        plan = compile_plan(g, backend, failures=FailureModel(0.7, 0.9), device=dev)
        x = torch.randn(100, 513, device=dev)
        before = kernel.launches
        got = plan.mix(x, torch.Generator().manual_seed(1))
        assert kernel.launches == before + 1
        cpu = compile_plan(g, backend, failures=FailureModel(0.7, 0.9), device="cpu")
        want = cpu.mix(x.cpu(), torch.Generator().manual_seed(1))
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
