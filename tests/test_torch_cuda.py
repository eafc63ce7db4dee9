"""The hand-written kernels against their plain versions on a CUDA device,
at shapes and layouts the main path does not reach.  Mixing: the dense
kernel's thin and wide routes on both sides of D_THIN (each launch on the
route ``dense_route`` names), row groups past 64 nodes, misaligned rows
(the same sums bit for bit), bf16 through the block-sparse kernel, tile sizes up to the limit, padding tiles
the walk must skip; both in the row-block form of the node-sharded round
(a rank's rows, the block-sparse walk over a [local | halo] buffer), and
the sharded plan at one NCCL rank bitwise the unsharded one.  Flash attention: every head dim, ragged S, causal and
windowed masks, GQA groups, strided (B, S, H, hd) views, fp32 at the
full-width prefill shapes, and the decoder's prefill through the kernel;
each case checks which route of the one kernel (``route``: wgmma for bf16,
wgmma_tf32x3 for fp32) launched, and a launch error on either route is
raised, not replaced.  RWKV-6 time-mix: ragged L, every head dim, fp32 and
bf16 r/k/v, zero and given initial states, the full-width serve shapes in
the decoder's layout, strided views, extreme decays, the one-launch path of
an L up to 128 (one device kernel, out bitwise the three launches'), and
the reduced rwkv6-3b served on the card; each case checks which route (tc
for bf16, tc_fp32 for fp32) launched, and unaligned rows are rejected.  Quantised mix: the scales pass and
the dense and block-sparse walks in raw and round mode, fp32 and bf16, int8
and fp8, both scale floors, masked operators, frozen mirrors, leaf chunk
tables, and compressed plan rounds against the CPU (new mirrors bitwise:
the kernel does the plain version's arithmetic element for element); an
asynchronous event's pair kernel bitwise the dense round on the same two
rows and ``ref.pair_round_ref`` (one- and two-pass chunk tables, X off
H's alignment, error feedback on and off).  The
block-sparse walks also at kreg4-1024 (bn 32), with rows walked in pieces
(complete-300 at bn 64) and in a masked round with all-zero tiles;
``mix_bsr`` bitwise its rendering ``mix_bsr_rows_ref``.  The row-list
(HYB) kernel ``mix_hyb``: every family's layout (no hubs, a few, all hub
rows), fp32 and bf16, misaligned rows, a shard's rows over its
[local | halo] buffer with the hubs over the gathered rows, out-of-range
indices read nothing; bitwise its plain version ``mix_hyb_ref`` and a clean
sparse plan round bitwise the CPU's; its slab route (every stageable shape:
K = 4, 2 and 1 sub-strips, one and two slabs, misaligned rows, a shard's
rows with hubs over a second buffer) bitwise its rows route, each call
launched on the route ``hyb_route`` names.  The zoo's last
configs: reduced jamba, llava and musicgen (with frontend embeddings) and
llama4-scout card vs CPU in fp32, a jamba decode step in bf16 replayed as a
CUDA graph, and an RWKV training step (no kernel launch under grad).
Skipped without a CUDA device; on the
card run

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax, which the port's
machine need not have).  fp32 to 1e-5 · max|W| (one FMA chain against
cuBLAS's blocked sum), bf16 elementwise to one bf16 ulp (2^-7 · |ref|) plus
that atol, which a kernel accumulating in bf16 would exceed.  The RWKV
kernel writes fp32 out and state from either input type: both to
5e-5 · max|ref|, the JAX package's kernel-vs-oracle bound.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import topology as T  # noqa: E402
from repro_torch.core.mixing import receive_matrix  # noqa: E402
from repro_torch.kernels.flash import attention_ref, flash_attention, flash_mha, route  # noqa: E402
from repro_torch.kernels.mix import mix as mix_kernel  # noqa: E402
from repro_torch.kernels.mix import (  # noqa: E402
    bsr_from_dense,
    chunk_bounds,
    decavg_mix_ref,
    dense_route,
    hyb_from_tables,
    mix_bsr,
    mix_bsr_ref,
    mix_bsr_rows_ref,
    mix_hyb,
    mix_hyb_ref,
    mix_matmul,
    pallas_bounds,
    quant_mix_bsr,
    quant_mix_dense,
    quant_mix_pair,
    quant_scales,
    quantised_decavg_mix_ref,
    quantised_mix_bsr,
)
from repro_torch.kernels.mix import hyb as hyb_kernel  # noqa: E402
from repro_torch.kernels.mix.hyb import SLAB_MAX_ROWS, hyb_route  # noqa: E402
from repro_torch.kernels.mix.mix import D_THIN, ROUTES  # noqa: E402
from repro_torch.kernels.mix.quant import _lib as quant_lib  # noqa: E402
from repro_torch.kernels.mix.quant import plan_tiles, round_smem_bytes  # noqa: E402
from repro_torch.kernels.mix.ref import quant_mix_ref, quant_scales_ref  # noqa: E402
from repro_torch.kernels.rwkv import rwkv as rwkv_kernels  # noqa: E402
from repro_torch.kernels.rwkv import rwkv6_attention, rwkv6_chunked, rwkv6_chunked_ref  # noqa: E402

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
@pytest.mark.parametrize("d", [1, 4, 6, 7, D_THIN, D_THIN + 1, 1000, 4097, 52_650])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_kernel_matches_plain(dev, n, d, dtype):
    """Both routes of the dense kernel (d on either side of D_THIN), each
    launch counted on the route ``dense_route`` names, two launches bitwise."""
    m = _stochastic(n, dev, n + d)
    w = torch.randn(n, d, device=dev).to(dtype)
    route = dense_route(n, d, dtype)
    before, by_route = mix_matmul.launches, dict(mix_matmul.launches_by_route)
    got = mix_matmul(m, w)
    assert mix_matmul.launches == before + 1
    assert mix_matmul.launches_by_route == {**by_route, route: by_route[route] + 1}
    _close(got, decavg_mix_ref(m, w), w)
    assert torch.equal(got, mix_matmul(m, w))


@pytest.mark.parametrize("d", [3, 1000, 1002, 567_434])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_kernel_misaligned_rows(dev, d, dtype):
    """A W that starts one element into its allocation, at d = 0 and 2
    (mod 4) (every other row off its 16-byte boundary at 2): the same route
    and the same sums as the aligned copy, bit for bit."""
    n = 16
    buf = torch.randn(n * d + 1, device=dev).to(dtype)
    w = buf[1:].view(n, d)
    m = _stochastic(n, dev)
    by_route = dict(mix_matmul.launches_by_route)
    got = mix_matmul(m, w)
    route = dense_route(n, d, dtype)
    assert mix_matmul.launches_by_route == {**by_route, route: by_route[route] + 1}
    _close(got, decavg_mix_ref(m, w), w)
    assert torch.equal(got, mix_matmul(m, w.clone()))


@pytest.mark.parametrize("n,d", [(8, 1), (256, 4), (64, 128), (16, 52_650), (1100, 4097)])
def test_dense_routes_agree_with_plain(dev, n, d):
    """Each route at shapes the other one takes (``mix._launch`` counts
    nothing): both within tolerance of the plain version, each bitwise
    stable across launches.  At n = 1100 the wide route's slice of M needs
    more than the default 48 KB of shared memory."""
    m = _stochastic(n, dev)
    w = torch.randn(n, d, device=dev)
    before = mix_matmul.launches
    for route in ROUTES:
        got = mix_kernel._launch(m, w, route)
        _close(got, decavg_mix_ref(m, w), w)
        assert torch.equal(got, mix_kernel._launch(m, w, route))
    assert mix_matmul.launches == before


@pytest.mark.parametrize(
    "graph,bn",
    [(T.ring(200), 8), (T.ring(200), 16), (T.random_k_regular(300, 4, seed=0), 64),
     (T.configuration_heavy_tail(150, 2.2, seed=1), 128), (T.complete(70), 256),
     (T.torus_lattice((8, 9)), 5), (T.random_k_regular(1024, 4, seed=0), 32), (T.complete(300), 64)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_kernel_matches_plain(dev, graph, bn, dtype):
    """Also bitwise the walk's rendering (mix_bsr_rows_ref): the same FMA
    chains in the same order (complete-300: 300 nonzeros a row, walked in
    pieces)."""
    m = receive_matrix(graph).astype(np.float32)
    bc, tiles, counts = (torch.as_tensor(a, device=dev) for a in bsr_from_dense(m, bn))
    w = torch.randn(graph.n, 777, device=dev).to(dtype)
    before = mix_bsr.launches
    got = mix_bsr(bc, tiles, counts, w)
    assert mix_bsr.launches == before + 1
    _close(got, mix_bsr_ref(bc, tiles, counts, w), w)
    _close(got, decavg_mix_ref(torch.as_tensor(m, device=dev), w), w)
    assert torch.equal(got, mix_bsr_rows_ref(bc, tiles, counts, w))
    assert torch.equal(got, mix_bsr(bc, tiles, counts, w))


@pytest.mark.parametrize("n,rows", [(16, 4), (16, 8), (16, 12), (64, 32), (300, 75)])
@pytest.mark.parametrize("d", [1, 4, D_THIN + 1, 1000, 4097])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_kernel_row_block(dev, n, rows, d, dtype):
    """M as a row block (rows, n) of a larger operator, the sharded round's
    call: on the route ``dense_route(n, d)`` names, the plain version's
    rows, bitwise the square call's rows (each output one FMA chain over k
    in order), two launches bitwise."""
    m = _stochastic(n, dev, n + d + rows)
    w = torch.randn(n, d, device=dev).to(dtype)
    lo = (n - rows) // 2
    block = m[lo : lo + rows].contiguous()
    route = dense_route(n, d, dtype)
    by_route = dict(mix_matmul.launches_by_route)
    got = mix_matmul(block, w)
    assert mix_matmul.launches_by_route == {**by_route, route: by_route[route] + 1}
    assert got.shape == (rows, d)
    _close(got, decavg_mix_ref(block, w), w)
    assert torch.equal(got, mix_matmul(m, w)[lo : lo + rows])
    assert torch.equal(got, mix_matmul(block, w))


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("graph", [T.ring(256), T.random_k_regular(256, 4, seed=0), T.barabasi_albert(256, 3, seed=0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_kernel_halo_row_block(dev, graph, n_shards, dtype):
    """Each shard's rows of the operator over its [local | halo] buffer (the
    sharded round's call, tables from the layout): bitwise the walk's
    rendering ``mix_bsr_rows_ref`` with the same row count, and the plain
    version's rows of the unsharded product on the gathered buffer."""
    from repro_torch.core.commplan import compile_plan
    from repro_torch.core.shardplan import _layouts, _local_op

    plan = compile_plan(graph, "sparse", device=dev)
    recv, _ = _layouts(plan, n_shards)
    x = torch.randn(graph.n, 513, device=dev).to(dtype)
    want = mix_bsr(*plan.bsr, x)
    for rank in range(n_shards):
        op = _local_op(recv, rank, plan.bsr.block_n, dev)
        lo = rank * recv.nps
        halo = recv.send[:, rank, : recv.h_max] + np.arange(n_shards)[:, None] * recv.nps  # rows of each source
        buf = torch.cat([x[lo : lo + recv.nps], x[torch.as_tensor(halo.reshape(-1), dtype=torch.int64)]])
        before = mix_bsr.launches
        got = mix_bsr(*op.bsr, buf, recv.nps)
        assert mix_bsr.launches == before + 1 and got.shape == (recv.nps, 513)
        assert torch.equal(got, mix_bsr_rows_ref(*op.bsr, buf, recv.nps))
        _close(got, want[lo : lo + recv.nps], x)


def test_sharded_round_at_one_nccl_rank(dev, tmp_path):
    """One NCCL rank: the sharded plan's mix / spread / spread_min are the
    unsharded plan's bit for bit, through kernels #1 and #2."""
    import torch.distributed as dist

    from repro_torch.core.commplan import FailureModel, compile_plan

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        for backend, graph in (("dense", T.complete(16)), ("sparse", T.ring(1024))):
            plan = compile_plan(graph, backend, failures=FailureModel(link_p=0.8), device=dev)
            sp = plan.shard(n_shards=1)
            x = torch.randn(graph.n, 1000, device=dev)
            gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
            before = (mix_matmul.launches, mix_bsr.launches)
            assert torch.equal(sp.mix(x, gen()), plan.mix(x, gen()))
            launched = (mix_matmul.launches - before[0], mix_bsr.launches - before[1])
            assert launched == ((2, 0) if backend == "dense" else (0, 2))
            for op in ("spread", "spread_min"):
                assert torch.equal(getattr(sp, op)(x[:, :3], gen()), getattr(plan, op)(x[:, :3], gen()))
    finally:
        dist.destroy_process_group()


HYB_GRAPHS = {
    "ring-200": lambda: T.ring(200),
    "kreg4-300": lambda: T.random_k_regular(300, 4, seed=0),
    "ba-256": lambda: T.barabasi_albert(256, 3, seed=2),
    "heavytail-150": lambda: T.configuration_heavy_tail(150, 2.2, seed=1),
    "complete-70": lambda: T.complete(70),
    "kreg4-16": lambda: T.random_k_regular(16, 4, seed=1),
}


@pytest.mark.parametrize("graph", sorted(HYB_GRAPHS))
@pytest.mark.parametrize("d", [1, 3, 777, 4097])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hyb_kernel_matches_plain(dev, graph, d, dtype):
    """One launch, bitwise the plain version (the same roundings in the same
    order), within the tolerance of M·W, two launches bitwise: ELL rows only
    (ring, kreg4-300), a few hub rows (BA, heavy-tail), all hub rows
    (complete-70, kreg4-16)."""
    from repro_torch.core.commplan import compile_plan

    g = HYB_GRAPHS[graph]()
    op = compile_plan(g, "sparse", device=dev).hyb
    w = torch.randn(g.n, d, device=dev).to(dtype)
    before = mix_hyb.launches
    got = mix_hyb(op, w)
    assert mix_hyb.launches == before + 1
    assert torch.equal(got, mix_hyb_ref(op, w))
    _close(got, decavg_mix_ref(torch.as_tensor(receive_matrix(g), dtype=torch.float32, device=dev), w), w)
    assert torch.equal(got, mix_hyb(op, w))


@pytest.mark.parametrize("d", [3, 1002, 567_434])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hyb_kernel_misaligned_rows(dev, d, dtype):
    """A W one element into its allocation: the same sums as the aligned
    copy, bit for bit."""
    from repro_torch.core.commplan import compile_plan

    op = compile_plan(T.barabasi_albert(128, 3, seed=2), "sparse", device=dev).hyb
    buf = torch.randn(128 * d + 1, device=dev).to(dtype)
    w = buf[1:].view(128, d)
    assert torch.equal(mix_hyb(op, w), mix_hyb(op, w.clone()))


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("graph", ["ba-256", "kreg4-300"])
def test_hyb_kernel_halo_row_block(dev, graph, n_shards):
    """Each shard's rows (the sharded round's call): the slots over its
    [local | halo] buffer, the hubs over the gathered rows; bitwise the
    unsharded call's rows and the plain version."""
    from repro_torch.core.commplan import compile_plan
    from repro_torch.core.shardplan import _build_hyb_tables, _layouts

    g = HYB_GRAPHS[graph]()
    plan = compile_plan(g, "sparse", device=dev)
    recv, _ = _layouts(plan, n_shards)
    tabs = _build_hyb_tables(plan, recv, n_shards)
    x = torch.randn(g.n, 513, device=dev)
    want = mix_hyb(plan.hyb, x)
    for rank in range(n_shards):
        real = tabs["hub_loc"][rank] < recv.nps
        op = hyb_from_tables(tabs["slot_pos"][rank], tabs["slot_w"][rank], tabs["hyb_self"][rank],
                             tabs["hub_loc"][rank][real], tabs["hub_m"][rank][real], dev)
        lo = rank * recv.nps
        halo = recv.send[:, rank, : recv.h_max] + np.arange(n_shards)[:, None] * recv.nps
        buf = torch.cat([x[lo : lo + recv.nps], x[torch.as_tensor(halo.reshape(-1), dtype=torch.int64)]])
        before = mix_hyb.launches
        got = mix_hyb(op, buf, x)
        assert mix_hyb.launches == before + 1 and got.shape == (recv.nps, 513)
        assert torch.equal(got, want[lo : lo + recv.nps])
        assert torch.equal(got, mix_hyb_ref(op, buf, x))


def test_hyb_kernel_reads_nothing_out_of_range(dev):
    """Each route on the tables it reads.  The rows route: slot and hub
    indices outside their buffers add nothing (the result of the same tables
    with those weights zeroed), a hub list past the end of the nonzeros is
    clipped to it, and a hub index past the hubs makes an ELL row (a hub
    row's slots and self weight are 0: a zero row).  The slab route: sources
    in its entry lists outside W add nothing, bit for bit the lists with
    those weights zeroed, and a row's list past the entries is clipped."""
    from repro_torch.core.commplan import compile_plan

    op = compile_plan(T.barabasi_albert(96, 3, seed=2), "sparse", device=dev).hyb
    w = torch.randn(96, 300, device=dev)
    rows = lambda o: hyb_kernel._launch(o, w, None, "rows")  # noqa: E731
    slab = lambda o: hyb_kernel._launch(o, w, None, "slab")  # noqa: E731
    bad_idx = op.slot_idx.clone()
    bad_idx[0, :5] = torch.tensor([96, 10_000, -1, -7, 2**30], dtype=torch.int32, device=dev)
    bad_col = op.hub_col.clone()
    bad_col[:3] = torch.tensor([96, -1, 2**30], dtype=torch.int32, device=dev)
    zero_w, zero_v = op.slot_w.clone(), op.hub_val.clone()
    zero_w[0, :5] = 0.0
    zero_v[:3] = 0.0
    got = rows(op._replace(slot_idx=bad_idx, hub_col=bad_col))
    assert torch.equal(got, rows(op._replace(slot_w=zero_w, hub_val=zero_v)))
    long_ptr = op.hub_ptr.clone()
    long_ptr[-1] += 1000
    assert torch.equal(rows(op._replace(hub_ptr=long_ptr)), rows(op))
    bad_of = op.hub_of.clone()
    row = int(op.hub_rows[0])
    bad_of[row] = op.n_hubs + 5
    got = rows(op._replace(hub_of=bad_of))
    assert bool((got[row] == 0).all())
    keep = torch.arange(96, device=dev) != row
    assert torch.equal(got[keep], rows(op)[keep])
    # the slab route: a hub row's entries (the walk's first) and an ELL
    # row's slots (not its self term) pointed outside W
    walk = op.walk.cpu()
    ell = next(i for i in range(96) if not walk[i, 3] and walk[i, 2] >= 3)
    picks = [int(walk[0, 1]), int(walk[0, 1]) + 1, int(walk[ell, 1]) + 1, int(walk[ell, 1]) + 2]
    assert walk[0, 3] == 1
    bad_ent, zero_ent = op.entries.clone(), op.entries.clone()
    bad_ent[picks, 0] = torch.tensor([96, -1, 2**30, -7], dtype=torch.int32, device=dev)
    zero_ent[picks, 1] = 0
    got = slab(op._replace(entries=bad_ent))
    assert torch.equal(got, slab(op._replace(entries=zero_ent)))
    assert not torch.equal(got, slab(op))
    last = int(walk[:, 1].argmax())
    long_walk = op.walk.clone()
    long_walk[last, 2] += 1000
    assert torch.equal(slab(op._replace(walk=long_walk)), slab(op))


def test_hyb_plan_round_on_the_card_is_the_cpus(dev):
    """A clean sparse plan round launches mix_hyb once and nothing else, and
    equals the CPU's round (the plain version) bit for bit; a masked round
    launches mix_bsr."""
    from repro_torch.core.commplan import compile_plan

    g = T.barabasi_albert(300, 3, seed=1)
    plan = compile_plan(g, "sparse", device=dev)
    x = torch.randn(300, 777, device=dev)
    before = (mix_hyb.launches, mix_bsr.launches)
    got = plan.mix(x)
    assert (mix_hyb.launches - before[0], mix_bsr.launches - before[1]) == (1, 0)
    assert torch.equal(got.cpu(), compile_plan(g, "sparse", device="cpu").mix(x.cpu()))
    plan.mix(x, active=torch.ones(300, dtype=torch.bool, device=dev))
    assert (mix_hyb.launches - before[0], mix_bsr.launches - before[1]) == (1, 1)


def test_sharded_hyb_at_one_nccl_rank(dev, tmp_path):
    """One NCCL rank: the sharded clean mix runs mix_hyb once and is the
    unsharded plan's bit for bit."""
    import torch.distributed as dist

    from repro_torch.core.commplan import compile_plan

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        plan = compile_plan(T.barabasi_albert(1024, 3, seed=2), "sparse", device=dev)
        sp = plan.shard(n_shards=1)
        x = torch.randn(1024, 1000, device=dev)
        before = mix_hyb.launches
        got = sp.mix(x)
        assert mix_hyb.launches == before + 1
        assert torch.equal(got, plan.mix(x))
    finally:
        dist.destroy_process_group()


# the slab route at every shape of its own: K = 4 sub-strips and two slabs
# (16 rows), K = 2 (150 to 300 rows), K = 1 with two slabs (600), one slab
# (the CLI's BA-1024, m 8), and the most rows it stages
SLAB_GRAPHS = {**HYB_GRAPHS, "kreg4-600": lambda: T.random_k_regular(600, 4, seed=3),
               "ba-1024-m8": lambda: T.barabasi_albert(1024, 8, seed=0), "ring-max": lambda: T.ring(SLAB_MAX_ROWS)}


@pytest.mark.parametrize("graph", sorted(SLAB_GRAPHS))
@pytest.mark.parametrize("d", [1, 3, 62, 777, 20_001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hyb_slab_route_is_the_rows_route(dev, graph, d, dtype):
    """The slab route (every operator here stages at most SLAB_MAX_ROWS
    rows) bitwise the plain version and the rows route on the same
    operator and W; mix_hyb launches once on the route ``route_of`` names
    (the rows route for fp32 rings, the slab route for the rest: these
    widths are below FEW_ROWS_MIN_D), two launches bitwise."""
    from repro_torch.core.commplan import compile_plan

    g = SLAB_GRAPHS[graph]()
    op = compile_plan(g, "sparse", device=dev).hyb
    w = torch.randn(g.n, d, device=dev).to(dtype)
    route = hyb_kernel.route_of(op, w)
    few = 4 * g.n <= hyb_kernel.FEW_ROWS * w.element_size() and d >= hyb_kernel.FEW_ROWS_MIN_D
    thin = few or (op.n_hubs == 0 and dtype == torch.float32 and op.slot_idx.shape[0] <= hyb_kernel.THIN_SLOTS)
    assert route == ("rows" if thin else "slab")
    before = dict(mix_hyb.launches_by_route)
    got = mix_hyb(op, w)
    assert mix_hyb.launches_by_route == {**before, route: before[route] + 1}
    assert torch.equal(got, mix_hyb_ref(op, w))
    assert torch.equal(got, hyb_kernel._launch(op, w, None, "rows"))
    assert torch.equal(got, hyb_kernel._launch(op, w, None, "slab"))


@pytest.mark.parametrize("d", [3, 1002, 567_434])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hyb_routes_agree_on_misaligned_rows(dev, d, dtype):
    """A W one element into its allocation (4-byte, 2-byte or plain copies
    into the slab): both routes give the aligned copy's bits."""
    from repro_torch.core.commplan import compile_plan

    op = compile_plan(T.barabasi_albert(128, 3, seed=2), "sparse", device=dev).hyb
    buf = torch.randn(128 * d + 1, device=dev).to(dtype)
    w = buf[1:].view(128, d)
    want = mix_hyb(op, w.clone())
    for route in ("slab", "rows"):
        assert torch.equal(hyb_kernel._launch(op, w, None, route), want)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("graph", ["ba-256", "heavytail-256", "kreg4-300"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hyb_slab_route_halo_row_block(dev, graph, n_shards, dtype):
    """A shard's rows with the hubs over a second buffer: the slab route
    stages [local | halo] and the gathered rows, and gives the rows route's
    bits, the unsharded call's rows and the plain version's."""
    from repro_torch.core.commplan import compile_plan
    from repro_torch.core.shardplan import _build_hyb_tables, _layouts

    g = {**HYB_GRAPHS, "heavytail-256": lambda: T.configuration_heavy_tail(256, 2.2, seed=1)}[graph]()
    plan = compile_plan(g, "sparse", device=dev)
    recv, _ = _layouts(plan, n_shards)
    tabs = _build_hyb_tables(plan, recv, n_shards)
    x = torch.randn(g.n, 1001, device=dev).to(dtype)
    want = mix_hyb(plan.hyb, x)
    for rank in range(n_shards):
        real = tabs["hub_loc"][rank] < recv.nps
        op = hyb_from_tables(tabs["slot_pos"][rank], tabs["slot_w"][rank], tabs["hyb_self"][rank],
                             tabs["hub_loc"][rank][real], tabs["hub_m"][rank][real], dev)
        lo = rank * recv.nps
        halo = recv.send[:, rank, : recv.h_max] + np.arange(n_shards)[:, None] * recv.nps
        buf = torch.cat([x[lo : lo + recv.nps], x[torch.as_tensor(halo.reshape(-1), dtype=torch.int64)]])
        route = hyb_kernel.route_of(op, buf, x)
        assert route == hyb_route(buf.shape[0], g.n if op.n_hubs else 0, False, dtype, n_rows=recv.nps,
                                  n_slots=op.slot_idx.shape[0], n_hubs=op.n_hubs, d=1001)
        before = dict(mix_hyb.launches_by_route)
        got = mix_hyb(op, buf, x)
        assert mix_hyb.launches_by_route == {**before, route: before[route] + 1}
        assert torch.equal(got, want[lo : lo + recv.nps])
        assert torch.equal(got, mix_hyb_ref(op, buf, x))
        assert torch.equal(got, hyb_kernel._launch(op, buf, x, "rows"))
        assert torch.equal(got, hyb_kernel._launch(op, buf, x, "slab"))


def test_hyb_rows_route_beyond_the_slab(dev):
    """An operator over more rows than the slab stages runs the rows route:
    counted on it, bitwise the plain version."""
    from repro_torch.core.commplan import compile_plan

    g = T.barabasi_albert(4096, 3, seed=1)
    op = compile_plan(g, "sparse", device=dev).hyb
    w = torch.randn(4096, 333, device=dev)
    before = dict(mix_hyb.launches_by_route)
    got = mix_hyb(op, w)
    assert mix_hyb.launches_by_route == {**before, "rows": before["rows"] + 1}
    assert torch.equal(got, mix_hyb_ref(op, w))


def test_slab_max_rows_is_the_kernels(dev):
    """The host's SLAB_MAX_ROWS is the library's kSlabMaxRows, and the C
    entry refuses one row more (no route is picked there from a pointer)."""
    from repro_torch.core.commplan import compile_plan

    assert hyb_kernel._lib().mix_hyb_slab_max_rows() == SLAB_MAX_ROWS
    op = compile_plan(T.ring(SLAB_MAX_ROWS + 1), "sparse", device=dev).hyb
    with pytest.raises(RuntimeError, match="slab"):
        hyb_kernel._launch(op, torch.randn(SLAB_MAX_ROWS + 1, 8, device=dev), None, "slab")


def test_bsr_kernel_skips_padding_tiles(dev):
    g = T.configuration_heavy_tail(40, 2.2, seed=0)
    m = receive_matrix(g).astype(np.float32)
    bc, tiles, counts = (torch.as_tensor(a, device=dev) for a in bsr_from_dense(m, 8))
    dirty = tiles.clone()
    for i, c in enumerate(counts.tolist()):
        dirty[i, c:] = float("nan")
    w = torch.randn(40, 100, device=dev)
    assert torch.equal(mix_bsr(bc, dirty, counts, w), mix_bsr(bc, tiles, counts, w))


@pytest.mark.parametrize("codec", [None, "int8", "fp8"])
def test_bsr_kernels_masked_round_with_zero_tiles(dev, codec):
    """A masked ring-1024 round in which two row blocks keep only their self
    weights, so whole real tiles are zero: the walks skip them (mix_bsr
    bitwise its rendering; quantised H' bitwise, X' within 1e-5 · max|X|)."""
    from repro_torch.core.commplan import compile_plan

    rng = np.random.default_rng(3)
    active = torch.as_tensor(rng.random(1024) < 0.8, device=dev)
    active[64:128] = False
    plan = compile_plan(T.ring(1024), "sparse", device=dev)
    kw = dict(active=active, edge_live=torch.as_tensor(rng.random(plan.n_edges) < 0.7, device=dev))
    op = plan.round_operator(**kw)
    real = torch.arange(op.tiles.shape[1], device=dev)[None, :] < op.counts[:, None]
    assert bool((real & (op.tiles.abs().sum((2, 3)) == 0)).any())
    m = compile_plan(T.ring(1024), "dense", device=dev).round_operator(**kw)
    if codec is None:
        w = torch.randn(1024, 777, device=dev)
        got = mix_bsr(*op, w)
        _close(got, decavg_mix_ref(m, w), w)
        assert torch.equal(got, mix_bsr_rows_ref(*op, w))
        return
    x, h = _quant_inputs(dev, 1024, 777, torch.float32, seed=5)
    _quant_case(dev, _counting(lambda *a, **k: quant_mix_bsr(*op, *a, **k), quant_mix_bsr),
                lambda hq: mix_bsr_rows_ref(*op, hq), x, h, chunk_bounds((777,), 128, dev), codec=codec, gamma=1.0)


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


# ------------------------------------------------------------------ flash
def _attn_inputs(dev, b, h, kvh, s, hd, dtype, seed=0, layout="bhsd"):
    """(B, H, S, hd) tensors, or (B, S, H, hd) ones passed as transposed views."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "bshd":
        return tuple(torch.randn(b, s, n, hd, generator=g, device=dev).to(dtype).transpose(1, 2)
                     for n in (h, kvh, kvh))
    return tuple(torch.randn(b, n, s, hd, generator=g, device=dev).to(dtype) for n in (h, kvh, kvh))


def _launch_once(q, k, v, **mask):
    """flash_mha, checking it launched exactly once on the route its dtype and hd pick."""
    want = route(q.dtype, q.shape[-1])
    before, by_route = flash_mha.launches, dict(flash_mha.launches_by_route)
    got = flash_mha(q, k, v, **mask)
    assert flash_mha.launches == before + 1
    assert flash_mha.launches_by_route == {**by_route, want: by_route[want] + 1}
    return got


@pytest.mark.parametrize("hd", [32, 64, 128, 160, 256])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 17), (False, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(dev, hd, s, causal, window, dtype):
    assert route(dtype, hd) == ("wgmma" if dtype == torch.bfloat16 else "wgmma_tf32x3")
    q, k, v = _attn_inputs(dev, 2, 8, 2, s, hd, dtype, seed=s + hd)
    got = _launch_once(q, k, v, causal=causal, window=window)
    _close(got, attention_ref(q, k, v, causal=causal, window=window), v)
    assert torch.equal(got, flash_mha(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("hd", [64, 128, 160, 256])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 129, 300, 2047])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("window", [0, 17, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_wgmma_kernel_ragged(dev, hd, s, group, window, causal, layout):
    """The wgmma kernel (bf16, hd 64 / 128 / 160 / 256) at ragged S around
    its 64-row tiles, GQA groups, windows inside and past S, both layouts."""
    q, k, v = _attn_inputs(dev, 2, 2 * group, 2, s, hd, torch.bfloat16, seed=s + hd + group, layout=layout)
    assert route(q.dtype, hd) == "wgmma"
    got = _launch_once(q, k, v, causal=causal, window=window)
    _close(got, attention_ref(q, k, v, causal=causal, window=window), v)
    assert torch.equal(got, flash_mha(q, k, v, causal=causal, window=window))


def _launch_error_is_raised(monkeypatch, q, k, v, name):
    from repro_torch.kernels.flash import flash as flash_module

    monkeypatch.setattr(flash_module, "_fn", lambda: lambda *args: 10001)
    before, by_route = flash_mha.launches, dict(flash_mha.launches_by_route)
    with pytest.raises(RuntimeError, match=name):
        flash_mha(q, k, v)
    assert flash_mha.launches == before and flash_mha.launches_by_route == by_route


def test_flash_wgmma_launch_error_is_raised(dev, monkeypatch):
    """No fallback: a bf16 hd-128 call whose kernel cannot launch raises,
    and nothing is counted."""
    _launch_error_is_raised(monkeypatch, *_attn_inputs(dev, 1, 2, 2, 64, 128, torch.bfloat16), "wgmma")


def test_flash_tf32x3_launch_error_is_raised(dev, monkeypatch):
    """The same on the fp32 route (hd 32, phase 8's reduced decoders)."""
    _launch_error_is_raised(monkeypatch, *_attn_inputs(dev, 1, 2, 2, 40, 32, torch.float32), "wgmma_tf32x3")


@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 1), (12, 3), (16, 2)])
def test_flash_kernel_gqa_groups(dev, h, kvh):
    q, k, v = _attn_inputs(dev, 3, h, kvh, 150, 64, torch.float32, seed=h)
    _close(_launch_once(q, k, v), attention_ref(q, k, v), v)


def test_flash_strided_views_need_no_copy(dev):
    """(B, S, H, hd) activations go in as transposed views, with leading
    axes folded into B; the output comes back contiguous in that layout."""
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(2, 3, 96, 8, 128, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(2, 3, 96, 2, 128, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(2, 3, 96, 2, 128, generator=g, device=dev).to(torch.bfloat16)
    out = flash_attention(q, k, v, causal=True, window=40)
    assert out.shape == q.shape and out.is_contiguous()
    ref = attention_ref(*(t.reshape(6, 96, -1, 128).transpose(1, 2) for t in (q, k, v)), causal=True, window=40)
    _close(out, ref.transpose(1, 2).reshape(q.shape), v)


@pytest.mark.parametrize(
    "arch,b,s,swa",
    [("qwen2.5-3b", 4, 2048, False), ("qwen2.5-3b", 1, 512, False), ("gemma3-4b", 2, 2048, False),
     ("gemma3-4b", 2, 2048, True), ("stablelm-12b", 4, 2048, False)],
)
def test_flash_kernel_at_full_width_prefill_shapes(dev, arch, b, s, swa):
    """The full-width configs' prefill launches, in the decoder's (B, S, H, hd)
    layout passed as transposed views, bf16."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    window = cfg.sliding_window if swa else 0
    g = torch.Generator(device=dev).manual_seed(s + hd)
    q, k, v = (torch.randn(b, s, n, hd, generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
               for n in (h, kvh, kvh))
    got = _launch_once(q, k, v, causal=True, window=window)
    _close(got, attention_ref(q, k, v, causal=True, window=window), v)
    assert torch.equal(got, flash_mha(q, k, v, causal=True, window=window))


@pytest.mark.parametrize(
    "arch,b,s,swa",
    [("qwen2.5-3b", 4, 2048, False), ("gemma3-4b", 2, 2048, False), ("gemma3-4b", 2, 2048, True)],
)
def test_flash_fp32_at_full_width_shapes(dev, arch, b, s, swa):
    """fp32 q, k, v (ArchConfig.dtype fp32) at the full-width prefill
    shapes, hd 128 and 256, in the decoder's layout: the 3×TF32 route."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    window = cfg.sliding_window if swa else 0
    g = torch.Generator(device=dev).manual_seed(s + hd + window)
    q, k, v = (torch.randn(b, s, n, hd, generator=g, device=dev).transpose(1, 2) for n in (h, kvh, kvh))
    assert route(q.dtype, hd) == "wgmma_tf32x3"
    got = _launch_once(q, k, v, causal=True, window=window)
    _close(got, attention_ref(q, k, v, causal=True, window=window), v)
    assert torch.equal(got, flash_mha(q, k, v, causal=True, window=window))


def test_flash_rejects_unaligned_rows(dev):
    """Rows off a 16-byte boundary and head dims the kernel is not
    instantiated for go through zero-padded copies (one launch at the next
    instantiated hd, the true hd's scale); above hd 256 the call is refused."""
    q, k, v = _attn_inputs(dev, 1, 2, 2, 16, 32, torch.float32)
    buf = torch.randn(q.numel() + 1, device=dev)
    q_off = buf[1:].view(q.shape)
    _close(_launch_once(q_off, k, v), attention_ref(q_off, k, v), v)
    q16, k16, v16 = (t[..., :16].contiguous() for t in (q, k, v))
    _close(_launch_once(q16, k16, v16), attention_ref(q16, k16, v16), v16)
    q_big, k_big, v_big = _attn_inputs(dev, 1, 2, 2, 16, 288, torch.float32)
    with pytest.raises(ValueError, match="head_dim 288 exceeds 256"):
        flash_mha(q_big, k_big, v_big)


@pytest.mark.parametrize("hd,dtype", [(30, torch.float32), (40, torch.bfloat16), (160, torch.bfloat16)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 17), (False, 0)])
def test_flash_pads_head_dims_it_has_no_instance_for(dev, hd, dtype, causal, window):
    """hd 30 (reduced qwen1.5-4b) and 40 (reduced stablelm-12b) in the
    decoder's (B, S, H, hd) view layout: one launch through zero-padded
    copies; hd 160 (stablelm-12b) has its own instance and pads nothing."""
    q, k, v = _attn_inputs(dev, 2, 4, 2, 70, hd, dtype, layout="bshd")
    padded = flash_mha.padded
    got = _launch_once(q, k, v, causal=causal, window=window)
    assert flash_mha.padded == padded + (hd != 160)
    assert got.shape == q.shape
    _close(got, attention_ref(q, k, v, causal=causal, window=window), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,kvh", [(2048, 32, 8), (300, 8, 1), (129, 4, 4)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100), (False, 0), (False, 64)])
def test_flash_hd160_instance(dev, dtype, s, h, kvh, causal, window):
    """hd 160 at its own instance in both dtypes (bf16: 64-byte swizzled
    boxes, 5 a row, P·V as m64n160k16; fp32: W = 1, m64n160k8), causal,
    windowed and GQA, in the decoder's view layout: one launch, no padded
    copy, within the tolerance of every flash case, bitwise on a rerun."""
    q, k, v = _attn_inputs(dev, 2 if s < 2048 else 1, h, kvh, s, 160, dtype, seed=s + h, layout="bshd")
    padded = flash_mha.padded
    got = _launch_once(q, k, v, causal=causal, window=window)
    assert flash_mha.padded == padded
    _close(got, attention_ref(q, k, v, causal=causal, window=window), v)
    assert torch.equal(got, flash_mha(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma3-4b"])
def test_decoder_prefill_on_the_card_matches_the_cpu(dev, arch):
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.fed import generate
    from repro_torch.models import transformer as TF

    cfg = get_reduced_config(arch)
    p_np = params_to_numpy(TF.init_params(torch.Generator().manual_seed(0), cfg, InitConfig("trunc_normal"),
                                          device="cpu"))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 50)).astype(np.int32)
    before = flash_mha.launches
    toks = generate(params_from_numpy(p_np, device=dev), cfg, prompt, 6, 64, device=dev)
    assert flash_mha.launches == before + cfg.n_layers
    want = generate(params_from_numpy(p_np, device="cpu"), cfg, prompt, 6, 64, device="cpu")
    np.testing.assert_array_equal(toks.cpu().numpy(), want.numpy())


# ------------------------------------------------------------------ rwkv
def _rwkv_inputs(dev, b, l, h, m, dtype, with_state=False, seed=0):
    """r, k, v in the decoder's layout ((B, L, H·M) viewed as (B, L, H, M)),
    w fp32 over the clamp's range, u (H, M), and an optional state."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(b, l, h * m, generator=g, device=dev).to(dtype).view(b, l, h, m) for _ in range(3))
    z = -6.0 + 7.0 * torch.rand(b, l, h * m, generator=g, device=dev)
    w = torch.exp(-torch.exp(z)).view(b, l, h, m)
    u = 0.5 * torch.rand(h, m, generator=g, device=dev)
    state = 0.3 * torch.randn(b, h, m, m, generator=g, device=dev) if with_state else None
    return r, k, v, w, u, state


def _rwkv_close(args):
    """One launch on the route r's dtype and head dim pick, within 5e-5 ·
    max|ref| of the plain version (out and state), bitwise repeatable."""
    want = rwkv_kernels.route(args[0].dtype, args[0].shape[-1])
    before, by_route = rwkv6_chunked.launches, dict(rwkv6_chunked.launches_by_route)
    out, state = rwkv6_chunked(*args)
    assert rwkv6_chunked.launches == before + 1
    assert rwkv6_chunked.launches_by_route == {**by_route, want: by_route[want] + 1}
    assert out.dtype == torch.float32 and state.dtype == torch.float32
    ref_out, ref_state = rwkv6_chunked_ref(*args)
    for got, ref in ((out, ref_out), (state, ref_state)):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 5e-5 * float(ref.abs().max())
    again = rwkv6_chunked(*args)
    assert torch.equal(out, again[0]) and torch.equal(state, again[1])


@pytest.mark.parametrize("l", [1, 31, 32, 33, 77, 300])
@pytest.mark.parametrize("m", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_kernel_matches_plain(dev, l, m, dtype, with_state):
    _rwkv_close(_rwkv_inputs(dev, 2, l, 3, m, dtype, with_state, seed=l + m))


@pytest.mark.parametrize("b,l", [(4, 2048), (1, 512), (1, 16384)])
def test_rwkv_kernel_at_full_width_serve_shapes(dev, b, l):
    """rwkv6-3b's prefill launches: 40 heads of 64, bf16 r/k/v, fp32 w."""
    from repro_torch.configs import get_config

    cfg = get_config("rwkv6-3b")
    h, m = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    _rwkv_close(_rwkv_inputs(dev, b, l, h, m, torch.bfloat16, seed=l))


def test_rwkv_kernel_reads_strided_views(dev):
    """r, k, v, w as slices of wider rows (non-dense (b, l, h) strides) and a
    folded leading axis: no copy, the same result as contiguous inputs."""
    r, k, v, w, u, state = _rwkv_inputs(dev, 2, 70, 4, 64, torch.bfloat16, True, seed=3)
    wide = [torch.cat([t, torch.full_like(t, float("nan"))], dim=-1)[..., :64] for t in (r, k, v, w)]
    assert wide[0].stride() == (70 * 4 * 128, 4 * 128, 128, 1)
    got = rwkv6_chunked(*wide, u, state)
    want = rwkv6_chunked(r, k, v, w, u, state)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    out, st = rwkv6_attention(*(t.view(1, 2, 70, 4, 64) for t in (r, k, v, w)), u, state.view(1, 2, 4, 64, 64))
    assert torch.equal(out.view(2, 70, 4, 64), want[0]) and torch.equal(st.view(2, 4, 64, 64), want[1])


def test_rwkv_kernel_extreme_decay(dev):
    ones = torch.ones(2, 128, 1, 32, device=dev)
    alt = torch.where(torch.arange(128, device=dev) % 2 == 0, 0.066, 0.9997)
    w = alt[None, :, None, None].expand(2, 128, 1, 32).contiguous()
    args = (ones, ones, ones, w, torch.zeros(1, 32, device=dev), None)
    out, state = rwkv6_chunked(*args)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(state).all())
    _rwkv_close(args)


@pytest.mark.parametrize("dtype,m,want", [(torch.bfloat16, 64, "tc"), (torch.float32, 64, "tc_fp32"),
                                            (torch.bfloat16, 32, "tc"), (torch.bfloat16, 128, "tc")])
def test_rwkv_route_and_launches_by_route(dev, dtype, m, want):
    assert rwkv_kernels.route(dtype, m) == want
    _rwkv_close(_rwkv_inputs(dev, 1, 40, 2, m, dtype, seed=m))


@pytest.mark.parametrize("l", [1, 33, 77, 300, 2049])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_tc_route_ragged(dev, l, with_state):
    """bf16 at M 64: the tensor-core kernel, spans of 128 cut anywhere."""
    _rwkv_close(_rwkv_inputs(dev, 2, l, 3, 64, torch.bfloat16, with_state, seed=l))


def test_rwkv_tc_route_extreme_decay(dev):
    """Decays alternating at the clamp's two ends over 300 tokens, bf16 ones."""
    ones = torch.ones(2, 300, 1, 64, device=dev, dtype=torch.bfloat16)
    alt = torch.where(torch.arange(300, device=dev) % 2 == 0, 0.066, 0.9997)
    w = alt[None, :, None, None].expand(2, 300, 1, 64).contiguous()
    args = (ones, ones, ones, w, torch.zeros(1, 64, device=dev), None)
    out, state = rwkv6_chunked(*args)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(state).all())
    _rwkv_close(args)


@pytest.mark.parametrize("l", [1, 33, 128, 129, 300, 2049])
@pytest.mark.parametrize("m", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_head_dims_and_types(dev, l, m, dtype, with_state):
    """M 32 and 128 (two value blocks of 64 a head) in bf16 and fp32, one
    span, its edge and several spans."""
    _rwkv_close(_rwkv_inputs(dev, 2, l, 3, m, dtype, with_state, seed=l + m + 1))


def _device_kernels(fn):
    """fn's result and the names of the rwkv kernels it ran on the card, one
    entry a launch (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() for _ in range(e.count) if "rwkv_span" in e.key]
    return out, names


@pytest.mark.parametrize("l", [1, 40, 128])
@pytest.mark.parametrize("m", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_one_launch_path(dev, l, m, dtype, with_state):
    """L ≤ 128 runs the span outputs alone: one device kernel, no scratch,
    out bitwise the three-launch path's (the kernel given a span's scratch:
    the same state in, the same arithmetic), the final state (summed in
    another order) within 5e-5 · max|ref|."""
    args = _rwkv_inputs(dev, 2, l, 3, m, dtype, with_state, seed=l + m + 2)
    before = rwkv6_chunked.one_launch
    (out1, state1), names1 = _device_kernels(lambda: rwkv6_chunked(*args))
    assert rwkv6_chunked.one_launch == before + 1
    assert len(names1) == 1 and "rwkv_span_out" in names1[0], names1
    (out3, state3), names3 = _device_kernels(
        lambda: rwkv_kernels._launch(*args, rwkv_kernels.span_scratch_floats(2, l, 3, m)))
    assert rwkv6_chunked.one_launch == before + 1 and len(names3) == 3, names3
    assert torch.equal(out1, out3)
    ref_out, ref_state = rwkv6_chunked_ref(*args)
    assert float((out1 - ref_out).abs().max()) <= 5e-5 * float(ref_out.abs().max())
    assert float((state1 - ref_state).abs().max()) <= 5e-5 * float(ref_state.abs().max())
    assert float((state1 - state3).abs().max()) <= 5e-5 * float(ref_state.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rwkv_tc_route_rejects_unaligned_rows(dev, dtype):
    r, k, v, w, u, _ = _rwkv_inputs(dev, 1, 20, 2, 64, dtype, seed=5)
    shifted = torch.empty(r.numel() + 1, dtype=r.dtype, device=dev)[1:].view(r.shape)
    shifted.copy_(r)
    before = dict(rwkv6_chunked.launches_by_route)
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_chunked(shifted, k, v, w, u)
    assert rwkv6_chunked.launches_by_route == before


def test_rwkv_decoder_on_the_card_matches_the_cpu(dev):
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.fed import generate
    from repro_torch.models import transformer as TF

    cfg = get_reduced_config("rwkv6-3b")
    p_np = params_to_numpy(TF.init_params(torch.Generator().manual_seed(0), cfg, InitConfig("trunc_normal"),
                                          device="cpu"))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 50)).astype(np.int32)
    before = rwkv6_chunked.launches
    toks = generate(params_from_numpy(p_np, device=dev), cfg, prompt, 6, 64, device=dev)
    assert rwkv6_chunked.launches == before + cfg.n_layers
    want = generate(params_from_numpy(p_np, device="cpu"), cfg, prompt, 6, 64, device="cpu")
    np.testing.assert_array_equal(toks.cpu().numpy(), want.numpy())


# ------------------------------------------------------------ quantised mix
def _quant_inputs(dev, n, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n, d, generator=g, device=dev) * (0.01 + 5 * torch.rand(n, 1, generator=g, device=dev)))
    x[0, : min(d, 64)] = 0.0  # an all-zero chunk
    if n > 1:
        x[1, : min(d, 64)] *= 1e-29 / float(x[1, : min(d, 64)].abs().max())  # the floors differ here
    h = 0.3 * torch.randn(n, d, generator=g, device=dev)
    return x.to(dtype), h


def _quant_case(dev, kernel, mix_plain, x, h, bounds, *, codec, gamma, ef=True, keep=None, floor="codec",
                route=None):
    """Scales bitwise; H' bitwise; X' or Y within 1e-5 · max|X| (bf16: one
    ulp more); launches counted; two launches bitwise equal.  With ``route``
    the kernel is the dense round: one launch, on that route, that returns
    its scales (no scales pass); without, a BSR walk given quant_scales'."""
    want_scales = quant_scales_ref(x, h, bounds, codec=codec, error_feedback=ef and h is not None, floor=floor)
    s_before, k_before = quant_scales.launches, kernel.launches
    kw = dict(codec=codec, gamma=gamma, error_feedback=ef, keep=keep)
    if route is None:
        scales = quant_scales(x, h, bounds, codec=codec, error_feedback=ef, floor=floor)
        assert quant_scales.launches == s_before + 1

        def run():
            return kernel(x, h, bounds, scales, **kw), scales
    else:
        by_route = dict(quant_mix_dense.launches_by_route)
        edges = tuple(bounds.tolist())

        def run():
            return kernel(x, h, edges, floor=floor, **kw)
    got, scales = run()
    assert kernel.launches == k_before + 1
    if route is not None:
        assert quant_scales.launches == s_before
        assert quant_mix_dense.launches_by_route == {**by_route, route: by_route[route] + 1}
    assert torch.equal(scales, want_scales)
    want = quant_mix_ref(mix_plain, x, h, bounds, scales, codec=codec, gamma=gamma,
                         error_feedback=ef and h is not None, keep=keep)
    again, scales_again = run()
    assert torch.equal(scales, scales_again)
    if gamma is None:
        _close(got, want, x)
        assert torch.equal(got, again)
        return
    (xo, ho), (xw, hw) = got, want
    assert ho.dtype == torch.float32 and xo.dtype == x.dtype
    assert torch.equal(ho, hw)
    _close(xo, xw, x)
    assert torch.equal(xo, again[0]) and torch.equal(ho, again[1])


QUANT_MODES = [  # (gamma, with h, error feedback, keep rows)
    (1.0, True, True, False), (0.5, True, True, True), (0.5, False, False, False), (1.0, True, False, True),
    (None, False, True, False),
]


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,sizes,chunk", [(8, (1000,), 128), (33, (500, 1, 300, 201), 64), (16, (4097,), 2048),
                                           (70, (6,), 4), (100, (777,), 1000)])
@pytest.mark.parametrize("mode", QUANT_MODES, ids=lambda m: f"g{m[0]}-h{int(m[1])}-ef{int(m[2])}-k{int(m[3])}")
def test_quant_dense_kernel_matches_plain(dev, codec, dtype, n, sizes, chunk, mode):
    """The dense round: one launch (no scales pass), on the staged route."""
    gamma, with_h, ef, with_keep = mode
    d = sum(sizes)
    x, h = _quant_inputs(dev, n, d, dtype, seed=n + d)
    m = _stochastic(n, dev, n)
    keep = (torch.arange(n, device=dev) % 3 != 1) if with_keep else None
    bounds = chunk_bounds(sizes, chunk, dev)

    before = quant_mix_dense.launches
    _quant_case(dev, _counting(lambda *a, **kw: quant_mix_dense(m, *a, **kw), quant_mix_dense), lambda hq: decavg_mix_ref(m, hq), x,
                h if with_h else None, bounds, codec=codec, gamma=gamma, ef=ef, keep=keep, route="staged")
    assert quant_mix_dense.launches == before + 2


MLP_SIZES = (784 * 512, 512, 512 * 256, 256, 256 * 128, 128, 128 * 10, 10)  # the paper MLP's leaves


@pytest.mark.parametrize(
    "n,sizes,chunk,dtype,mode,floor,route",
    [
        (1, MLP_SIZES, 2048, torch.float32, QUANT_MODES[0], "codec", "staged"),
        (64, MLP_SIZES, 2048, torch.float32, QUANT_MODES[0], "codec", "staged"),
        (64, MLP_SIZES, 2048, torch.float32, QUANT_MODES[1], "codec", "staged"),
        (16, (65536 + 1000, 10), 65536, torch.float32, QUANT_MODES[0], "codec", "wide"),
        (16, (65536 + 1000, 10), 65536, torch.bfloat16, QUANT_MODES[1], "codec", "wide"),
        (16, (65536 + 1000, 10), 65536, torch.float32, QUANT_MODES[4], "pallas", "wide"),
        (64, (3 * 65536 + 7,), 65536, torch.float32, QUANT_MODES[2], "codec", "wide"),
        (16, (20_001,), 2048, torch.float32, QUANT_MODES[0], "codec", "staged"),
        (16, (20_001,), 2048, torch.bfloat16, QUANT_MODES[3], "codec", "staged"),
        (16, (sum(MLP_SIZES),), 512, torch.float32, QUANT_MODES[4], "pallas", "staged"),
        (16, (sum(MLP_SIZES),), 512, torch.bfloat16, QUANT_MODES[4], "pallas", "staged"),
        (200, (3000,), 256, torch.float32, QUANT_MODES[1], "codec", "staged"),
        (200, (5000,), 4096, torch.bfloat16, QUANT_MODES[0], "codec", "wide"),
    ],
    ids=["n1-mlp", "n64-mlp", "n64-mlp-keep", "wide-65536", "wide-bf16-keep", "wide-raw-pallas", "wide-n64-no-ef",
         "odd-d", "odd-d-bf16-keep-no-ef", "raw-pallas-chunks", "raw-pallas-chunks-bf16", "n200-m-from-memory",
         "n200-wide-bf16"],
)
def test_quant_dense_round_routes(dev, n, sizes, chunk, dtype, mode, floor, route):
    """The dense round at the main path's chunk table (n 1 and 64), chunks
    of 65,536 columns (the wide route), odd d (rows one element aligned),
    bf16 X, a keep mask, no error feedback, raw mode at the Pallas chunking
    and past the rows M can be held in shared memory; each case asserts the
    route it took."""
    gamma, with_h, ef, with_keep = mode
    d = sum(sizes)
    bounds = chunk_bounds(sizes, chunk, dev) if floor == "codec" else pallas_bounds(d, chunk, dev)
    assert plan_tiles(bounds.tolist(), n, x_itemsize=dtype.itemsize).route == route
    x, h = _quant_inputs(dev, n, d, dtype, seed=n + d)
    m = _stochastic(n, dev, n)
    keep = (torch.arange(n, device=dev) % 3 != 1) if with_keep else None
    _quant_case(dev, _counting(lambda *a, **kw: quant_mix_dense(m, *a, **kw), quant_mix_dense),
                lambda hq: decavg_mix_ref(m, hq), x, h if with_h else None, bounds, codec="int8", gamma=gamma,
                ef=ef, keep=keep, floor=floor, route=route)


@pytest.mark.parametrize("n", [1, 8, 9, 16, 32, 33, 64, 128, 129, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_smem_bytes_is_the_kernels(dev, n, dtype):
    """The host's count of the round kernel's shared memory, which sizes the
    tile plan, is the kernel's own (``quant_round_smem_bytes``) at the plans
    of the MLP table, Pallas chunking and one wide chunk, and at one column."""
    lib = quant_lib()
    d = sum(MLP_SIZES)
    for edges in (chunk_bounds(MLP_SIZES, 2048), pallas_bounds(d, 512), chunk_bounds((65536 + 1000, 10), 65536)):
        plan = plan_tiles(edges.tolist(), n, x_itemsize=dtype.itemsize)
        for cols in (1, plan.cols):
            want = lib.quant_round_smem_bytes(n, cols, plan.tile_chunks, dtype.itemsize)
            assert round_smem_bytes(n, cols, plan.tile_chunks, dtype.itemsize) == want


def _counting(fn, wrapper):
    """fn with the launch count of the wrapper it calls."""
    class Counted:
        def __call__(self, *args, **kw):
            return fn(*args, **kw)

        @property
        def launches(self):
            return wrapper.launches

    return Counted()


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "graph,bn",
    [(T.ring(200), 8), (T.random_k_regular(300, 4, seed=0), 64), (T.configuration_heavy_tail(150, 2.2, seed=1), 16),
     (T.complete(70), 256), (T.torus_lattice((8, 9)), 5), (T.ring(1024), 32),
     (T.random_k_regular(1024, 4, seed=0), 32), (T.complete(300), 64)],
)
@pytest.mark.parametrize("mode", QUANT_MODES, ids=lambda m: f"g{m[0]}-h{int(m[1])}-ef{int(m[2])}-k{int(m[3])}")
def test_quant_bsr_kernel_matches_plain(dev, codec, dtype, graph, bn, mode):
    gamma, with_h, ef, with_keep = mode
    m = receive_matrix(graph).astype(np.float32)
    bc, tiles, counts = (torch.as_tensor(a, device=dev) for a in bsr_from_dense(m, bn))
    sizes = (300, 10, 1, 466)
    x, h = _quant_inputs(dev, graph.n, sum(sizes), dtype, seed=graph.n + bn)
    keep = (torch.arange(graph.n, device=dev) % 4 != 2) if with_keep else None
    before = quant_mix_bsr.launches
    _quant_case(dev, _counting(lambda *a, **kw: quant_mix_bsr(bc, tiles, counts, *a, **kw), quant_mix_bsr),
                lambda hq: mix_bsr_ref(bc, tiles, counts, hq), x, h if with_h else None,
                chunk_bounds(sizes, 128, dev), codec=codec, gamma=gamma, ef=ef, keep=keep)
    assert quant_mix_bsr.launches == before + 2


@pytest.mark.parametrize("floor", ["codec", "pallas"])
@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_quant_raw_mode_both_floors(dev, floor, codec):
    g = T.random_k_regular(64, 4, seed=2)
    m = receive_matrix(g).astype(np.float32)
    bc, tiles, counts = (torch.as_tensor(a, device=dev) for a in bsr_from_dense(m, 16))
    x, _ = _quant_inputs(dev, 64, 1300, torch.float32, seed=7)
    bounds = pallas_bounds(1300, 512, dev)
    _quant_case(dev, _counting(lambda *a, **kw: quant_mix_bsr(bc, tiles, counts, *a, **kw), quant_mix_bsr),
                lambda hq: mix_bsr_ref(bc, tiles, counts, hq), x, None, bounds, codec=codec, gamma=None,
                floor=floor)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_quantised_mix_bsr_is_the_pallas_function(dev, dtype, codec):
    g = T.barabasi_albert(40, 3, seed=0)
    m = receive_matrix(g).astype(np.float32)
    bc, tiles, counts = (torch.as_tensor(a, device=dev) for a in bsr_from_dense(m, 8))
    w, _ = _quant_inputs(dev, 40, 190, dtype, seed=1)
    before = quant_mix_bsr.launches
    got = quantised_mix_bsr(bc, tiles, counts, w, codec=codec, block_d=64)
    assert quant_mix_bsr.launches == before + 1 and got.dtype == dtype
    _close(got, quantised_decavg_mix_ref(torch.as_tensor(m, device=dev), w, codec=codec, block_d=64), w)
    cpu = quantised_mix_bsr(*(t.cpu() for t in (bc, tiles, counts, w)), codec=codec, block_d=64)
    _close(got.cpu(), cpu, w.cpu())


def test_quant_kernel_misaligned_rows(dev):
    """X and H starting one element into their allocations take VEC 1."""
    n, d = 16, 1000
    buf = torch.randn(2, n * d + 1, device=dev)
    x, h = buf[0, 1:].view(n, d), buf[1, 1:].view(n, d)
    m = _stochastic(n, dev)
    bounds = chunk_bounds((d,), 256, dev)
    _quant_case(dev, _counting(lambda *a, **kw: quant_mix_dense(m, *a, **kw), quant_mix_dense),
                lambda hq: decavg_mix_ref(m, hq), x, h, bounds, codec="int8", gamma=1.0, route="staged")


@pytest.mark.parametrize("codec", ["int8", "fp8", "topk", "qtopk"])
@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_compressed_plan_round_on_the_card_matches_the_cpu(dev, codec, backend):
    """One compressed round under a failure model: int8 / fp8 launch one
    dense round, or the scales pass and one block-sparse walk; topk / qtopk
    one DecAvg kernel; the new mirrors equal the CPU's bit for bit."""
    from repro_torch.core.commplan import FailureModel, compile_plan
    from repro_torch.core.compress import Compression

    g = T.ring(100)
    comp = Compression(codec=codec, chunk=128, topk_frac=0.3, gamma=0.5)
    x = torch.randn(100, 777, device=dev)
    h = 0.5 * torch.randn(100, 777, device=dev)
    plan = compile_plan(g, backend, failures=FailureModel(0.7, 0.9), device=dev)
    quant = quant_mix_dense if backend == "dense" else quant_mix_bsr
    plain = mix_matmul if backend == "dense" else mix_bsr
    counts0 = (quant_scales.launches, quant.launches, plain.launches)
    xg, hg = plan.mix(x, torch.Generator().manual_seed(1), compression=comp, residual=h)
    counts1 = (quant_scales.launches, quant.launches, plain.launches)
    want = ((0 if backend == "dense" else 1), 1, 0) if codec in ("int8", "fp8") else (0, 0, 1)
    assert tuple(b - a for a, b in zip(counts0, counts1)) == want
    cpu = compile_plan(g, backend, failures=FailureModel(0.7, 0.9), device="cpu")
    xc, hc = cpu.mix(x.cpu(), torch.Generator().manual_seed(1), compression=comp, residual=h.cpu())
    assert torch.equal(hg.cpu(), hc)
    torch.testing.assert_close(xg.cpu(), xc, atol=1e-5 * float(x.abs().max()), rtol=0)


PAIR_SHAPES = {"ragged": ((777, 1, 301), 128), "mlp": (MLP_SIZES, 2048)}


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("gamma", [1.0, 0.5])
@pytest.mark.parametrize("shape", sorted(PAIR_SHAPES))
def test_quant_pair_exchange_matches_plain(dev, codec, gamma, shape):
    """An event's compressed exchange on the card: one launch of the pair
    kernel (route ``pair``, no dense-round launch) with the pair's 2 × 2
    operator, against the plain version on the CPU (the JAX form h'_u +
    w_uv·(h'_v − h'_u)): scales and H' bitwise, X' within 1e-5 · max|X| (the
    kernel sums (1 − w)·h'_u + w·h'_v), two launches bitwise equal."""
    from repro_torch.core.commplan import compile_plan

    sizes, chunk = PAIR_SHAPES[shape]
    d = sum(sizes)
    plan = compile_plan(T.barabasi_albert(16, 3, seed=0), "dense", data_sizes=np.linspace(1, 2, 16), device=dev)
    x, h = _quant_inputs(dev, 2, d, torch.float32, seed=d)
    edges = tuple(chunk_bounds(sizes, chunk).tolist())
    for e in (0, plan.n_edges - 1):
        m2 = plan.event_m2[e]
        before, dense_before = quant_mix_pair.launches, quant_mix_dense.launches
        (xo, ho), sc = quant_mix_pair(m2, x, h, edges, codec=codec, gamma=gamma)
        assert (quant_mix_pair.launches, quant_mix_dense.launches) == (before + 1, dense_before)
        (xc, hc), sc_c = quant_mix_pair(m2.cpu(), x.cpu(), h.cpu(), edges, codec=codec, gamma=gamma)
        assert torch.equal(sc.cpu(), sc_c) and torch.equal(ho.cpu(), hc)
        torch.testing.assert_close(xo.cpu(), xc, atol=1e-5 * max(float(x.abs().max()), 1.0), rtol=0)
        (xa, ha), _ = quant_mix_pair(m2, x, h, edges, codec=codec, gamma=gamma)
        assert torch.equal(xa, xo) and torch.equal(ha, ho)


# chunk tables of the pair kernel: the MLP's (2,048-column chunks, one pass
# of 288 threads), ragged leaves of narrow chunks, a d that is no multiple
# of 4, chunks of 65,536 columns (two passes) and of 4,000 (one pass of the
# most threads a block takes), and one column a chunk
PAIR_TABLES = {"mlp": (MLP_SIZES, 2048), "ragged": ((777, 1, 301), 128), "odd": ((4099, 3, 2050), 2048),
               "wide": ((150_001,), 65536), "most": ((12_345,), 4000), "one": ((67,), 1)}


@pytest.mark.parametrize("table", sorted(PAIR_TABLES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("codec,gamma,ef", [("int8", 1.0, True), ("fp8", 0.5, True), ("int8", 0.5, False)])
@pytest.mark.parametrize("offset", [0, 1])
def test_quant_pair_route_is_the_staged_route(dev, table, dtype, codec, gamma, ef, offset):
    """The pair kernel against the dense round on the staged (or wide)
    route with the same 2 × 2 operator: scales, H' and X' bitwise, and
    bitwise its plain version in the kernel's arithmetic
    (``ref.pair_round_ref``); X one element into its allocation (``offset``)
    so that the rows' alignments differ from H's; a one-pass and a
    two-pass table as ``pair_launch`` names them."""
    from repro_torch.core.commplan import compile_plan
    from repro_torch.kernels.mix.quant import PAIR_MAX_THREADS, PAIR_SLOTS, pair_launch
    from repro_torch.kernels.mix.ref import pair_round_ref

    sizes, chunk = PAIR_TABLES[table]
    d = sum(sizes)
    edges = tuple(chunk_bounds(sizes, chunk).tolist())
    threads, _, passes = pair_launch(edges)
    widest = max(b - a for a, b in zip(edges, edges[1:]))
    assert threads % 32 == 0 and threads <= PAIR_MAX_THREADS
    assert passes == (1 if -(-widest // 4) + 1 <= PAIR_SLOTS * threads else 2)
    assert passes == (2 if table == "wide" else 1)
    plan = compile_plan(T.barabasi_albert(16, 3, seed=0), "dense", data_sizes=np.linspace(1, 2, 16), device=dev)
    m2 = plan.event_m2[plan.n_edges - 1]
    x0, h = _quant_inputs(dev, 2, d, dtype, seed=d + offset)
    x = torch.empty(2 * d + offset, dtype=dtype, device=dev)[offset:].view(2, d)
    x.copy_(x0)
    h_in = h if ef else None
    (xo, ho), sc = quant_mix_pair(m2, x, h_in, edges, codec=codec, gamma=gamma, error_feedback=ef)
    (xs, hs), sc_s = quant_mix_dense(m2, x, h_in, edges, codec=codec, gamma=gamma, error_feedback=ef)
    assert torch.equal(sc, sc_s) and torch.equal(ho, hs) and torch.equal(xo, xs)
    xr, hr = pair_round_ref(m2, x, h_in, chunk_bounds(sizes, chunk, dev), sc, codec=codec, gamma=gamma,
                            error_feedback=ef)
    assert torch.equal(ho, hr) and torch.equal(xo, xr)


@pytest.mark.parametrize("delivered", [True, False])
def test_event_step_quantised_exchange_on_the_card(dev, delivered):
    """The event executor's step with int8 on the card: a delivered draw is
    one launch of the pair kernel, a failed one launches nothing and leaves the
    pair's rows as the local phase left them (the uncompressed step's,
    bitwise) and their mirrors as they were; the card's rows match the
    CPU's (H' bitwise, X' to fp32 rounding).  The loss is scaled by 0, so
    the local phase leaves the rows bitwise equal on both devices and the
    exchange alone is compared."""
    from repro_torch.core.commplan import compile_plan
    from repro_torch.core.compress import Compression
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.fed import executor as PX
    from repro_torch.fed import init_fl_state
    from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
    from repro_torch.optim import sgd

    def loss(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1]) * 0.0

    rng = np.random.default_rng(0)
    xs = rng.standard_normal((8, 16, 784)).astype(np.float32)
    ys = rng.integers(0, 10, (8, 16)).astype(np.int32)
    sched = torch.as_tensor(rng.integers(0, 16, (2, 8, 2, 4)), dtype=torch.int64)
    opt = sgd(1e-3, 0.5)
    outs = {}
    for where in ("cpu", "cuda"):
        state = init_fl_state(0, 8, lambda g, gn: init_mlp(InitConfig("he_normal", gn), g.manual_seed(3), hidden=(16,)),
                              opt, device="cpu")
        plan = compile_plan(T.ring(8), "dense", device=where)
        for comp in (None, Compression("int8", chunk=512)):
            p = state.params.to(where, copy=True)
            o = type(state.opt_state)(*(f.to(where, copy=True) for f in state.opt_state))
            mirror = 0.01 * torch.ones_like(p)
            step = PX._make_event_step(loss, opt, plan, sched.to(where), 2, torch.as_tensor(xs, device=where),
                                       torch.as_tensor(ys, device=where), layout=state.layout, reinit_opt=True,
                                       comp=comp)
            before = quant_mix_pair.launches
            step(p, o, mirror, np.zeros(8, np.int32), np.zeros(8, np.float32), 3, np.float32(0.5), delivered)
            if where == "cuda":
                assert quant_mix_pair.launches - before == int(delivered and comp is not None)
            outs[where, comp is None] = (p.cpu(), mirror.cpu())
    u, v = plan.event_uv[3].tolist()
    if not delivered:
        for where in ("cpu", "cuda"):
            assert torch.equal(outs[where, False][0], outs[where, True][0])
            assert float((outs[where, False][1] - 0.01).abs().max()) == 0.0
    x_c, h_c = outs["cpu", False]
    x_g, h_g = outs["cuda", False]
    assert torch.equal(h_g, h_c)
    torch.testing.assert_close(x_g, x_c, atol=1e-5 * max(float(x_c.abs().max()), 1.0), rtol=1e-5)
    assert torch.equal(x_g[[i for i in range(8) if i not in (u, v)]], x_c[[i for i in range(8) if i not in (u, v)]])


def test_a_grad_recording_kernel_call_raises(dev):
    """No kernel has a backward: a CUDA call autograd would record raises in
    both wrappers (nothing is launched), and the same call under
    ``torch.no_grad()`` launches."""
    q = torch.randn(1, 4, 40, 32, device=dev, requires_grad=True)
    k, v = torch.randn(1, 2, 40, 32, device=dev), torch.randn(1, 2, 40, 32, device=dev)
    before = flash_mha.launches
    with pytest.raises(RuntimeError, match="no backward"):
        flash_mha(q, k, v)
    assert flash_mha.launches == before
    with torch.no_grad():
        flash_mha(q, k, v)
    assert flash_mha.launches == before + 1
    r = torch.randn(1, 40, 2, 32, device=dev)
    w = torch.rand(1, 40, 2, 32, device=dev) * 0.5 + 0.5
    u = torch.randn(2, 32, device=dev, requires_grad=True)
    before = rwkv6_chunked.launches
    with pytest.raises(RuntimeError, match="no backward"):
        rwkv6_chunked(r, r, r, w, u)
    assert rwkv6_chunked.launches == before
    with torch.no_grad():
        rwkv6_chunked(r, r, r, w, u)
    assert rwkv6_chunked.launches == before + 1


def test_decoder_training_step_on_the_card_matches_the_cpu(dev):
    """One decoder loss and gradient (the reduced qwen2.5-3b, fp32) on the
    card against the CPU: no flash launch under grad, the loss to 1e-5 and
    the gradient to 1e-4 of its largest element (the card's fp32 products
    in another order)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.flat import tree_leaves, tree_map
    from repro_torch.models import transformer as TF

    cfg = get_reduced_config("qwen2.5-3b")
    base = TF.init_params(0, cfg, InitConfig("trunc_normal"), device="cpu")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32))
    y = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32))
    out = {}
    for where in ("cpu", "cuda"):
        p = tree_map(lambda t: t.detach().to(where, copy=True).requires_grad_(True), base)
        before = flash_mha.launches
        hidden, _ = TF.forward(p, cfg, x.to(where))
        loss = TF.lm_loss(p, cfg, hidden, y.to(where))
        loss.backward()
        assert flash_mha.launches == before
        out[where] = (float(loss.detach()), [t.grad.cpu() for _, t in tree_leaves(p)])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for g, c in zip(out["cuda"][1], out["cpu"][1]):
        assert float((g - c).abs().max()) <= 1e-4 * max(float(c.abs().max()), 1e-30)


def test_serve_trajectory_on_the_card_matches_the_cpu(dev):
    """A ring-6 serving run (link_p 0.8, consensus router with a budget,
    answers) on the card and on the CPU from one numpy init and the same
    host draws: routing arrays and answers equal, clocks and integer
    channels equal, losses to rtol 1e-4 (the trainer's bound)."""
    from repro_torch import fed
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.commplan import FailureModel, compile_plan
    from repro_torch.data import batch_index_schedule, mnist_like, node_datasets
    from repro_torch.models.paper_models import classifier_loss, mlp_forward
    from repro_torch.optim import sgd

    n, per = 6, 32
    ds = mnist_like(n * per + 64, seed=0)
    xs, ys = node_datasets(ds, [np.arange(i * per, (i + 1) * per) for i in range(n)])
    rng = np.random.default_rng(0)
    params = {f"fc{i}": {"w": (rng.standard_normal((n, a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
                         "b": np.zeros((n, b), np.float32)} for i, (a, b) in enumerate(((784, 16), (16, 10)))}

    def loss(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    g = T.ring(6)
    stream = T.poisson_event_stream(g, 8.0, 1.0, seed=1)
    queries = fed.poisson_query_stream(6, 8.0, 5.0, seed=3, pool=64)
    runs = {}
    for where in ("cpu", "cuda"):
        opt = sgd(1e-3, 0.5)
        runs[where] = fed.run_serve_trajectory(
            state_from_numpy(params, optimizer=opt, device=where), loss, opt,
            compile_plan(g, "dense", failures=FailureModel(link_p=0.8), device=where), stream, queries,
            fed.make_router(g, "consensus", staleness_budget=0.5), xs, ys, batch_index_schedule(per, n, 8, 16, seed=0),
            b_local=2, n_bins=4, eval_fn=fed.make_eval_fn(loss), eval_batch=(ds.x[-64:], ds.y[-64:]),
            serve_fn=lambda p, x: torch.argmax(mlp_forward(p, x[None]), dim=-1)[0], query_xs=ds.x[-64:],
            device=where,
        )
    (_, h_c, s_c, a_c), (f_g, h_g, s_g, a_g) = runs["cpu"], runs["cuda"]
    for k in ("node", "latency", "staleness", "hops", "answer"):
        assert np.array_equal(s_g[k], s_c[k]), k
    for k in ("events", "messages", "staleness", "queries", "serve_latency", "serve_staleness"):
        assert h_g[k] == h_c[k], k
    assert np.array_equal(a_g["node_clock"], a_c["node_clock"]) and np.array_equal(a_g["node_busy"], a_c["node_busy"])
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(h_g[k], h_c[k], rtol=1e-4, atol=1e-5)
    assert f_g.params.is_cuda


def _elastic_setup():
    from repro_torch.data import batch_index_schedule, mnist_like, node_datasets

    n, per = 6, 32
    ds = mnist_like(n * per + 64, seed=0)
    xs, ys = node_datasets(ds, [np.arange(i * per, (i + 1) * per) for i in range(n)])
    rng = np.random.default_rng(0)
    params = {f"fc{i}": {"w": (rng.standard_normal((n, a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
                         "b": np.zeros((n, b), np.float32)} for i, (a, b) in enumerate(((784, 16), (16, 10)))}
    return xs, ys, params, (ds.x[-64:], ds.y[-64:]), batch_index_schedule(per, n, 8, 24, seed=0)


def _elastic_run(where, checkpoint=None, resume_from=None, codec=None):
    """Ring-6 at link_p 0.8: a joiner at round 1 (warmup 3), a crash burst
    of 2 nodes over rounds 5–7, 12 rounds in chunks of 4."""
    from repro_torch import fed
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.commplan import FailureModel, compile_plan
    from repro_torch.core.compress import Compression
    from repro_torch.core.faults import crash_burst
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.core.membership import membership_schedule
    from repro_torch.models.paper_models import classifier_loss, init_mlp, mlp_forward
    from repro_torch.optim import sgd

    xs, ys, params, test, sched = _elastic_setup()

    def loss(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    opt = sgd(1e-3, 0.5)
    g = T.ring(6)
    return fed.run_elastic_trajectory(
        state_from_numpy(params, optimizer=opt, device=where), loss, opt,
        compile_plan(g, "dense", failures=FailureModel(link_p=0.8), device=where),
        membership_schedule(6, 12, initial=5, arrivals={1: [5]}, join_warmup=3), xs, ys, sched, n_rounds=12,
        eval_every=3, eval_fn=fed.make_eval_fn(loss), eval_batch=test, chunk_size=4,
        init_one=lambda gen, gains: init_mlp(InitConfig("he_normal", gains), gen, hidden=(16,)),
        faults=crash_burst(g, 12, at=5, size=2, duration=3, seed=1), checkpoint=checkpoint, resume_from=resume_from,
        compression=None if codec is None else Compression(codec, chunk=256), device=where,
    )


def test_elastic_trajectory_on_the_card_matches_the_cpu(dev, monkeypatch):
    """The elastic executor on the card and on the CPU from one numpy init
    and the same host draws (the forked draws made on the CPU and moved):
    n_active and the wire counts equal, n̂ equal, losses and params to the
    trainer's bounds."""
    from repro_torch.fed import executor

    real = executor.elastic_draws

    def on_cpu(kind, seed, r, *, n, device, **kw):
        out = real(kind, seed, r, n=n, device="cpu", **{k: (v.cpu() if k == "gains" else v) for k, v in kw.items()})
        return out.to(device) if kind == "sketches" else {k: {j: t.to(device) for j, t in v.items()}
                                                          for k, v in out.items()}

    monkeypatch.setattr(executor, "elastic_draws", on_cpu)
    (f_c, h_c, a_c), (f_g, h_g, a_g) = _elastic_run("cpu"), _elastic_run("cuda")
    for k in ("round", "n_active", "wire_messages", "wire_bytes"):
        assert h_g[k] == h_c[k], k
    assert np.array_equal(a_g["n_hat"], a_c["n_hat"])
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(h_g[k], h_c[k], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(f_g.params.cpu(), f_c.params, rtol=1e-4, atol=1e-5)
    assert f_g.params.is_cuda and torch.equal(f_g.generator.get_state(), f_c.generator.get_state())


@pytest.mark.parametrize("codec", [None, "int8"])
def test_elastic_resume_on_the_card_is_bitwise(dev, tmp_path, codec):
    """On the card: checkpoint every chunk, LATEST cut back to chunk 0, then
    a resume: params, optimizer state, mirror and history bitwise the
    uninterrupted run's."""
    import json

    from repro_torch.fed import CheckpointPolicy

    f_ref, h_ref, a_ref = _elastic_run("cuda", codec=codec)
    d = str(tmp_path / "ck")
    _elastic_run("cuda", checkpoint=CheckpointPolicy(d, every=1, keep_last=5), codec=codec)
    (tmp_path / "ck" / "LATEST").write_text(json.dumps({"step": 0, "path": f"{d}/step_00000000.ckpt"}))
    f_res, h_res, a_res = _elastic_run("cuda", resume_from=d, codec=codec)
    assert h_res == h_ref and np.array_equal(a_res["n_hat"], a_ref["n_hat"])
    assert torch.equal(f_res.params, f_ref.params) and f_res.params.is_cuda
    assert all(torch.equal(a, b) for a, b in zip(f_res.opt_state, f_ref.opt_state))
    assert (f_ref.residual is None) == (codec is None)
    if codec is not None:
        assert torch.equal(f_res.residual, f_ref.residual)


def test_moe_forward_on_the_card_matches_the_cpu(dev):
    """The MoE FFN of the reduced granite-moe (fp32, capacity 0.5 so pairs
    drop) on the card against the CPU: the same experts and dropped pairs,
    y to 1e-5 of its largest element, the aux loss to 1e-6; two card runs
    bitwise (no atomic add in the combine)."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.flat import tree_map
    from repro_torch.models import moe as M

    cfg = dataclasses.replace(get_reduced_config("granite-moe-1b-a400m"), capacity_factor=0.5)
    p = M.init_moe(InitConfig("trunc_normal"), torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y_cpu, aux_cpu = M.moe_forward(p, cfg, x)
    p_dev = tree_map(lambda t: t.to(dev), p)
    y_dev, aux_dev = M.moe_forward(p_dev, cfg, x.to(dev))
    again, _ = M.moe_forward(p_dev, cfg, x.to(dev))
    assert torch.equal(y_dev, again)
    assert float((y_dev.cpu() - y_cpu).abs().max()) <= 1e-5 * float(y_cpu.abs().max())
    assert abs(float(aux_dev) - float(aux_cpu)) <= 1e-6
    xt = x.reshape(-1, cfg.d_model)
    cap = M._capacity(cfg, xt.shape[0])
    r_cpu = M.route(torch.softmax(xt @ p["router"]["w"], -1), cfg.experts_per_token, cap)
    r_dev = M.route(torch.softmax(xt.to(dev) @ p_dev["router"]["w"], -1), cfg.experts_per_token, cap)
    assert torch.equal(r_dev.idx.cpu(), r_cpu.idx) and torch.equal(r_dev.keep.cpu(), r_cpu.keep)
    assert int((~r_cpu.keep).sum()) > 0


def test_moe_decode_step_replays_as_a_cuda_graph(dev):
    """One decode step of the reduced granite-moe in bf16, captured as a
    CUDA graph (no host read in the routing) and replayed: the eager step's
    logits bit for bit."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.models import transformer as TF

    cfg = dataclasses.replace(get_reduced_config("granite-moe-1b-a400m"), dtype="bfloat16")
    params = TF.init_params(0, cfg, InitConfig("trunc_normal"), device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(2)).to(dev)
    logits, cache = TF.prefill_cache(params, cfg, prompt, 32)
    tok = logits.argmax(-1)[:, None].to(prompt.dtype)
    snapshot = {k: [{n: t.clone() for n, t in c.items()} for c in v] for k, v in cache.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = TF.decode_step(params, cfg, cache, tok, 16)[0].clone()
    torch.cuda.current_stream().wait_stream(side)
    for k, v in snapshot.items():
        for c, s in zip(cache[k], v):
            for n in c:
                c[n].copy_(s[n])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = TF.decode_step(params, cfg, cache, tok, 16)[0]
    for k, v in snapshot.items():
        for c, s in zip(cache[k], v):
            for n in c:
                c[n].copy_(s[n])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)


# ------------------------------------------------ mamba, frontends, RWKV training
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "llava-next-mistral-7b", "musicgen-large",
                                  "llama4-scout-17b-a16e"])
def test_new_configs_on_the_card_match_the_cpu(dev, arch):
    """The reduced configs in fp32 from one CPU init, with 8 frontend
    embeddings for llava and musicgen: the prefill logits (frontend first)
    to rtol 1e-4 and the greedy decode's tokens equal card vs CPU; one flash
    launch a prefill attention layer, on wgmma_tf32x3."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.models import transformer as TF

    cfg = get_reduced_config(arch)
    p_np = params_to_numpy(TF.init_params(torch.Generator().manual_seed(3), cfg, InitConfig("trunc_normal"),
                                          device="cpu"))
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    emb = (np.random.default_rng(4).standard_normal((2, cfg.n_frontend_tokens, cfg.frontend_embed_dim))
           .astype(np.float32) if cfg.n_frontend_tokens else None)
    n_attn = sum(k == "attn" for k in TF.layer_kinds(cfg))
    out = {}
    for where in ("cuda", "cpu"):
        p = params_from_numpy(p_np, device=where)
        e = None if emb is None else torch.as_tensor(emb, device=where)
        before = dict(flash_mha.launches_by_route)
        logits, cache = TF.prefill_cache(p, cfg, torch.as_tensor(prompt, device=where), 64, frontend_embeds=e)
        if where == "cuda":
            assert flash_mha.launches_by_route == {**before, "wgmma_tf32x3": before["wgmma_tf32x3"] + n_attn}
        pos, toks = 40 + (0 if emb is None else emb.shape[1]), [logits.argmax(-1)]
        for i in range(6):
            step, cache = TF.decode_step(p, cfg, cache, toks[-1][:, None], pos + i)
            toks.append(step[:, -1].argmax(-1))
        out[where] = logits.cpu().numpy(), torch.stack(toks, 1).cpu().numpy()
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])


def test_mamba_decode_step_replays_as_a_cuda_graph(dev):
    """A decode step of the reduced jamba in bf16 (mamba blocks, the MoE
    FFN) captured as a CUDA graph and replayed from the same cache: the
    eager step's logits and cache bit for bit."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.flat import tree_leaves
    from repro_torch.models import transformer as TF

    cfg = dataclasses.replace(get_reduced_config("jamba-1.5-large-398b"), dtype="bfloat16")
    params = TF.init_params(0, cfg, InitConfig("trunc_normal"), device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (2, 300), generator=torch.Generator().manual_seed(2)).to(dev)
    logits, cache = TF.prefill_cache(params, cfg, prompt, 320)
    tok = logits.argmax(-1)[:, None].to(prompt.dtype)
    leaves = [t for _, t in tree_leaves(cache)]
    snapshot = [t.clone() for t in leaves]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = TF.decode_step(params, cfg, cache, tok, 300)[0].clone()
    torch.cuda.current_stream().wait_stream(side)
    eager_cache = [t.clone() for t in leaves]
    for t, s in zip(leaves, snapshot):
        t.copy_(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = TF.decode_step(params, cfg, cache, tok, 300)[0]
    for t, s in zip(leaves, snapshot):
        t.copy_(s)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    assert all(torch.equal(t, e) for t, e in zip(leaves, eager_cache))


def test_rwkv_training_step_on_the_card_matches_the_cpu(dev):
    """The reduced rwkv6-3b's loss and gradient on the card against the CPU:
    no rwkv kernel launch while autograd records (the plain chunked
    time-mix), the loss to 1e-5 and the gradient to 1e-4 of its largest
    element; the same forward under no_grad launches the kernel a layer."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.flat import tree_leaves, tree_map
    from repro_torch.models import transformer as TF

    cfg = get_reduced_config("rwkv6-3b")
    base = TF.init_params(0, cfg, InitConfig("trunc_normal"), device="cpu")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 45)).astype(np.int32))
    y = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 45)).astype(np.int32))
    out = {}
    for where in ("cpu", "cuda"):
        p = tree_map(lambda t: t.detach().to(where, copy=True).requires_grad_(True), base)
        before = rwkv6_chunked.launches
        hidden, _ = TF.forward(p, cfg, x.to(where))
        loss = TF.lm_loss(p, cfg, hidden, y.to(where))
        loss.backward()
        assert rwkv6_chunked.launches == before
        out[where] = (float(loss.detach()), [t.grad.cpu() for _, t in tree_leaves(p)])
        if where == "cuda":
            with torch.no_grad():
                TF.forward(p, cfg, x.to(where))
            assert rwkv6_chunked.launches == before + cfg.n_layers
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for g, c in zip(out["cuda"][1], out["cpu"][1]):
        assert float((g - c).abs().max()) <= 1e-4 * max(float(c.abs().max()), 1e-30)
