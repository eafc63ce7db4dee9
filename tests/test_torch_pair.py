"""An asynchronous event's compressed exchange in the pair kernel's
arithmetic, on the CPU (the kernel itself runs only on the card:
``tests/test_torch_cuda.py -k pair`` holds it bitwise against the dense
round and this plain version there).

* ``ref.pair_round_ref`` (the kernel's FMA order: each output row
  ``fma(M[r, 1], h'_1, fma(M[r, 0], h'_0, 0))``, then ``fma(γ, acc − h'_r,
  x_r)``) bitwise ``quant_mix_ref`` around ``decavg_mix_ref`` on (2, d) rows:
  the scales, H' and X', at γ 1 and 0.5 (where the epilogue's product is
  exact, so the fused and the separate roundings agree), int8 and fp8,
  fp32 and bf16 X, error feedback on and off, at chunk tables whose widest
  chunk the kernel's block holds in one pass or not, and a d that is no
  multiple of 4.
* ``quant.pair_launch``: the block's threads (whole warps, at most
  ``PAIR_MAX_THREADS``), the grid (``PAIR_CHUNKS_PER_BLOCK`` chunks a
  block) and the passes for each table.
* ``quant_mix_pair`` on CPU tensors: its plain version (the JAX pairwise
  form) gives the same scales and H' as ``pair_round_ref`` and X' within
  fp32 rounding; it checks its arguments as on the card.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mix import chunk_bounds, decavg_mix_ref, quant_mix_pair  # noqa: E402
from repro_torch.kernels.mix.quant import PAIR_CHUNKS_PER_BLOCK, PAIR_MAX_THREADS, PAIR_SLOTS, pair_launch  # noqa: E402
from repro_torch.kernels.mix.ref import pair_round_ref, quant_mix_ref, quant_scales_ref  # noqa: E402

MLP_SIZES = (784 * 512, 512, 512 * 256, 256, 256 * 128, 128, 128 * 10, 10)  # the paper MLP's leaves
# (leaf sizes, chunk): narrow chunks of ragged leaves, d no multiple of 4
# with a chunk starting mid-group, the widest chunk one pass holds, chunks
# of 65,536 columns (two passes), one column a chunk
TABLES = {"ragged": ((777, 1, 301), 128), "odd": ((4099, 3, 2050), 2048), "most": ((12_345,), 4000),
          "wide": ((150_001,), 65536), "one": ((67,), 1)}


def _inputs(d, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, d, generator=g) * (0.01 + 5 * torch.rand(2, 1, generator=g))
    x[0, : min(d, 64)] = 0.0  # an all-zero chunk
    h = 0.3 * torch.randn(2, d, generator=g)
    m2 = torch.tensor([[1.0 - 0.37, 0.37], [0.61, 1.0 - 0.61]])
    return x, h, m2


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ef", [True, False])
def test_pair_round_ref_is_the_dense_round_reference(table, codec, dtype, ef):
    sizes, chunk = TABLES[table]
    d = sum(sizes)
    x, h, m2 = _inputs(d, seed=d + int(ef))
    x = x.to(dtype)
    h_in = h if ef else None
    bounds = chunk_bounds(sizes, chunk)
    scales = quant_scales_ref(x, h_in, bounds, codec=codec, error_feedback=ef)
    for gamma in (1.0, 0.5):
        got = pair_round_ref(m2, x, h_in, bounds, scales, codec=codec, gamma=gamma, error_feedback=ef)
        want = quant_mix_ref(lambda hq: decavg_mix_ref(m2, hq), x, h_in, bounds, scales, codec=codec, gamma=gamma,
                             error_feedback=ef)
        assert got[0].dtype == dtype and got[1].dtype == torch.float32
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (table, codec, dtype, ef, gamma)


@pytest.mark.parametrize("table", sorted([*TABLES, "mlp"]))
def test_pair_launch_sizes_the_block(table):
    sizes, chunk = TABLES.get(table, (MLP_SIZES, 2048))
    edges = tuple(chunk_bounds(sizes, chunk).tolist())
    threads, blocks, passes = pair_launch(edges)
    widest = max(b - a for a, b in zip(edges, edges[1:]))
    groups = -(-widest // 4) + 1  # a chunk that starts mid-group needs one more
    assert threads % 32 == 0 and 32 <= threads <= PAIR_MAX_THREADS
    assert blocks == -(-(len(edges) - 1) // PAIR_CHUNKS_PER_BLOCK)
    assert passes == (1 if groups <= PAIR_SLOTS * threads else 2)
    if passes == 1:  # the fewest whole warps that hold it
        assert threads == 32 or groups > PAIR_SLOTS * (threads - 32)
    else:
        assert threads == PAIR_MAX_THREADS
    want = {"mlp": (288, 1), "ragged": (32, 1), "odd": (288, 1), "most": (512, 1), "wide": (512, 2), "one": (32, 1)}
    assert (threads, passes) == want[table]


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("ef", [True, False])
def test_quant_mix_pair_plain_is_the_kernel_order_to_rounding(codec, ef):
    """The CPU path (the JAX pairwise form) against the kernel's order: the
    same scales and H' bit for bit, X' within 1e-6 · max|X|; no launch is
    counted."""
    sizes, chunk = TABLES["odd"]
    d = sum(sizes)
    x, h, m2 = _inputs(d, seed=3)
    h_in = h if ef else None
    edges = tuple(chunk_bounds(sizes, chunk).tolist())
    before = quant_mix_pair.launches
    (xo, ho), scales = quant_mix_pair(m2, x, h_in, edges, codec=codec, gamma=0.5, error_feedback=ef)
    assert quant_mix_pair.launches == before
    xr, hr = pair_round_ref(m2, x, h_in, chunk_bounds(sizes, chunk), scales, codec=codec, gamma=0.5,
                            error_feedback=ef)
    assert torch.equal(scales, quant_scales_ref(x, h_in, chunk_bounds(sizes, chunk), codec=codec,
                                                error_feedback=ef))
    assert torch.equal(ho, hr)
    torch.testing.assert_close(xo, xr, atol=1e-6 * float(x.abs().max()), rtol=0)


def test_quant_mix_pair_checks_its_arguments():
    x, h, m2 = _inputs(10, seed=0)
    with pytest.raises(ValueError, match=r"\(2, d\)"):
        quant_mix_pair(m2, torch.zeros(3, 10), None, (0, 10), codec="int8", gamma=1.0)
    with pytest.raises(ValueError, match="ends at column"):
        quant_mix_pair(m2, x, h, (0, 8), codec="int8", gamma=1.0)
    with pytest.raises(ValueError, match="codec"):
        quant_mix_pair(m2, x, h, (0, 10), codec="int4", gamma=1.0)
    with pytest.raises(ValueError, match="M must have shape"):
        quant_mix_pair(m2[:1], x, h, (0, 10), codec="int8", gamma=1.0)
    with pytest.raises(TypeError, match="H must be"):
        quant_mix_pair(m2, x, h.double(), (0, 10), codec="int8", gamma=1.0)
