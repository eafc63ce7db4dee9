"""The sparse backend's static HYB rendering (ELL slots + dense hub rows)
against the JAX package, on the CPU.

* ``compile_plan``'s HYB tables (``slot_idx``, ``slot_w``, ``hyb_self_w``,
  ``hub_rows``, ``hub_m``) bitwise the JAX ones, dtypes included, and the
  sharded tables (``shardplan._build_hyb_tables``) bitwise the JAX ones.
* ``decavg.mix_pytree_hyb``, the clean sparse ``CommPlan.mix`` and a
  schedule mixing hub-heavy and hub-free plans against the JAX versions at
  ``test_torch_commplan``'s bound (1e-5 absolute and relative; a bf16 leaf
  to 1e-2), the JAX schedule's stacked envelope included.
* The plain version ``mix_hyb_ref`` (the wrapper's CPU path): its ELL rows
  bitwise an independent numpy loop of the same roundings, its hub rows
  and the whole product within 1e-6 · max|x| of the dense operator.
* Which rounds take HYB: every unmasked sparse round; masked rounds,
  ``spread`` and the codecs keep the BSR tiles.  The kernel's route
  (``hyb_route``) at the card's shapes and its crossings.
* The sharded HYB on spawned gloo ranks (S = 2, 4; S = 1 in this process)
  at BA-64 and kreg4-64: the unsharded round bit for bit (the slot order is
  kept), the op each rank ran, and a masked round still through the tiles.
"""
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import commplan as JC  # noqa: E402
from repro.core import decavg as JD  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import decavg as PD  # noqa: E402
from repro_torch.core import shardplan as PS  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core.compress import Compression  # noqa: E402
from repro_torch.core.mixing import receive_matrix  # noqa: E402
from repro_torch.kernels.mix import BSR, HYB, hyb_from_tables, hyb_route, mix_flat, mix_hyb, mix_hyb_ref  # noqa: E402
from repro_torch.kernels.mix.hyb import ROUTES as HYB_ROUTES  # noqa: E402
from repro_torch.kernels.mix.hyb import FEW_ROWS, FEW_ROWS_MIN_D, SLAB_MAX_ROWS, THIN_SLOTS, route_of  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402

FAMILIES = {
    "complete": lambda T, n: T.complete(n),
    "ring": lambda T, n: T.ring(n),
    "kreg": lambda T, n: T.random_k_regular(n, 4, seed=2),
    "ba": lambda T, n: T.barabasi_albert(n, 3, seed=1),
    "heavy_tail": lambda T, n: T.configuration_heavy_tail(n, 2.2, seed=0),
    "torus": lambda T, n: T.torus_lattice((4, n // 4)),
}
TABLES = ("slot_idx", "slot_w", "hyb_self_w", "hub_rows", "hub_m")
TOL = dict(atol=1e-5, rtol=1e-5)
SHARD_GRAPHS = {"ba-64": lambda T: T.barabasi_albert(64, 3, seed=2), "kreg4-64": lambda T: T.random_k_regular(64, 4,
                                                                                                               seed=1)}
SPAWN_TIMEOUT = 240.0


def _params_np(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n, 6, 3)).astype(np.float32), "b": {"v": rng.standard_normal((n, 5))
                                                                              .astype(np.float32)},
            "h": rng.standard_normal((n, 17)).astype(np.float32)}


def _to_jax(p):
    return {"w": jnp.asarray(p["w"]), "b": {"v": jnp.asarray(p["b"]["v"])}, "h": jnp.asarray(p["h"]).astype(jnp.bfloat16)}


def _to_torch(p):
    return {"w": torch.as_tensor(p["w"]), "b": {"v": torch.as_tensor(p["b"]["v"])},
            "h": torch.as_tensor(p["h"]).to(torch.bfloat16)}


def _assert_tree_close(got, want):
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), **TOL)
    np.testing.assert_allclose(got["b"]["v"].numpy(), np.asarray(want["b"]["v"]), **TOL)
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_allclose(got["h"].float().numpy(), np.asarray(want["h"], np.float32), atol=1e-2, rtol=1e-2)


@functools.cache
def _plans(family: str, n: int):
    return (JC.compile_plan(FAMILIES[family](JT, n), "sparse"),
            PC.compile_plan(FAMILIES[family](PT, n), "sparse", device="cpu"))


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("family,n", [(f, n) for f in FAMILIES for n in (16, 64)]
                         + [("ba", 256), ("heavy_tail", 256)])
def test_tables_equal_jax(family, n):
    """compile_plan's HYB tables are the JAX package's bit for bit, and the
    kernel's operator holds them: each hub's nonzeros of ``hub_m`` in
    ascending column, ``hub_of`` the inverse of ``hub_rows``."""
    pj, pp = _plans(family, n)
    for name in TABLES:
        want, got = np.asarray(getattr(pj, name)), getattr(pp, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    op = pp.hyb
    hub_m = pp.hub_m.numpy()
    assert op.n_rows == n and op.n_hubs == hub_m.shape[0]
    for h, row in enumerate(op.hub_rows.tolist()):
        lo, hi = op.hub_ptr[h].item(), op.hub_ptr[h + 1].item()
        np.testing.assert_array_equal(op.hub_col[lo:hi].numpy(), np.nonzero(hub_m[h])[0])
        np.testing.assert_array_equal(op.hub_val[lo:hi].numpy(), hub_m[h][np.nonzero(hub_m[h])[0]])
        assert op.hub_of[row].item() == h
    assert int((op.hub_of >= 0).sum()) == op.n_hubs


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("graph", sorted(SHARD_GRAPHS))
def test_sharded_tables_equal_jax(graph, n_shards):
    """The sharded HYB tables (slots re-pointed into [local | halo], the
    hubs each shard owns) are the JAX ``_build_hyb_tables`` ones."""
    from repro.core.shardplan import _build_hyb_tables, _build_layout

    jp = JC.compile_plan(SHARD_GRAPHS[graph](JT), "sparse")
    pp = PC.compile_plan(SHARD_GRAPHS[graph](PT), "sparse", device="cpu")
    src, dst = np.asarray(jp.src), np.asarray(jp.dst)
    recv_j = _build_layout(pp.n, n_shards, dst, src, np.asarray(jp.edge_uid), np.asarray(jp.edge_w),
                           np.asarray(jp.raw_edge_w), np.arange(len(src), dtype=np.int32), np.asarray(jp.self_w),
                           np.asarray(jp.raw_self_w))
    want = _build_hyb_tables(jp, recv_j, n_shards)
    got = PS._build_hyb_tables(pp, PS._layouts(pp, n_shards)[0], n_shards)
    assert sorted(got) == sorted(want)
    for name, table in got.items():
        assert table.dtype == np.asarray(want[name]).dtype, name
        np.testing.assert_array_equal(table, np.asarray(want[name]), err_msg=name)


# ---------------------------------------------------------------- mixing
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_mix_pytree_hyb_matches_jax(family):
    """``mix_pytree_hyb`` on the port's tables against the JAX function on
    the JAX tables, a tree with a bf16 leaf and a flat buffer."""
    pj, pp = _plans(family, 64)
    p = _params_np(64)
    jtabs = [getattr(pj, k) for k in TABLES]
    ptabs = [getattr(pp, k) for k in TABLES]
    _assert_tree_close(PD.mix_pytree_hyb(_to_torch(p), *ptabs), JD.mix_pytree_hyb(_to_jax(p), *jtabs))
    flat = np.random.default_rng(1).standard_normal((64, 3, 50)).astype(np.float32)
    got = PD.mix_pytree_hyb(torch.as_tensor(flat), *ptabs)
    assert got.shape == flat.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(JD.mix_pytree_hyb(jnp.asarray(flat), *jtabs)), **TOL)


@pytest.mark.parametrize("family,n", [(f, 64) for f in ("ba", "heavy_tail", "kreg", "ring")]
                         + [("ba", 256), ("heavy_tail", 256)])
def test_clean_sparse_mix_matches_jax(family, n):
    """The clean sparse ``CommPlan.mix`` runs the HYB operator and meets the
    JAX plan's mix (which takes ``mix_pytree_hyb``), tree and flat."""
    pj, pp = _plans(family, n)
    assert isinstance(pp.mix_operator(), HYB) and pp.mix_operator() is pp.hyb
    p = _params_np(n, seed=2)
    _assert_tree_close(pp.mix(_to_torch(p)), pj.mix(_to_jax(p)))
    flat = np.random.default_rng(3).standard_normal((n, 300)).astype(np.float32)
    np.testing.assert_allclose(pp.mix(torch.as_tensor(flat)).numpy(),
                               np.asarray(pj.mix({"x": jnp.asarray(flat)})["x"]), **TOL)


def test_masked_rounds_spread_and_codecs_keep_the_tiles(monkeypatch):
    """Masked rounds (a failure model, ``active``, ``edge_live``), the send
    form and the codecs run the BSR tiles; only the unmasked mix takes HYB."""
    graph = PT.barabasi_albert(96, 3, seed=1)
    clean = PC.compile_plan(graph, "sparse", device="cpu")
    failing = PC.compile_plan(graph, "sparse", failures=PC.FailureModel(link_p=0.8), device="cpu")
    active = torch.ones(96, dtype=torch.bool)
    assert isinstance(clean.mix_operator(active=active), BSR)
    assert isinstance(clean.mix_operator(edge_live=torch.ones(clean.n_edges, dtype=torch.bool)), BSR)
    assert isinstance(failing.mix_operator(torch.Generator().manual_seed(0)), BSR)
    assert isinstance(clean.round_operator(), BSR)  # the operator matrix stays the tiles
    seen = []
    real = PC.mix_flat

    def recording(op, w, *a, **k):
        seen.append(type(op).__name__)
        return real(op, w, *a, **k)

    monkeypatch.setattr(PC, "mix_flat", recording)
    x = torch.randn(96, 40)
    clean.mix(x)
    clean.mix(x, active=active)
    failing.mix(x, torch.Generator().manual_seed(0))
    clean.spread(x[:, :3])
    assert seen == ["HYB", "BSR", "BSR", "BSR"]
    # an all-true mask is the clean operator: the two renderings agree
    np.testing.assert_allclose(clean.mix(x, active=active).numpy(), clean.mix(x).numpy(), atol=1e-6, rtol=0)
    # the int8 codec takes the quantised BSR round, never the HYB operator
    import repro_torch.core.compress as PCOMP

    ops = []
    real_q = PCOMP.quant_mix_flat
    monkeypatch.setattr(PCOMP, "quant_mix_flat", lambda op, *a, **k: ops.append(type(op).__name__) or real_q(op, *a,
                                                                                                            **k))
    clean.mix(x, compression=Compression("int8", chunk=16), residual=torch.zeros_like(x))
    assert ops == ["BSR"]


def test_schedule_of_hub_and_hub_free_plans_matches_jax():
    """A schedule of heavy-tail-64 (hub rows) and kreg6-64 (none), round for
    round, against the JAX schedule's stacked envelope (its hub-free plan
    fabricates a dense row 0 there) and the JAX plans alone."""
    gj = [JT.configuration_heavy_tail(64, 2.2, seed=0), JT.random_k_regular(64, 6, seed=0)]
    gp = [PT.configuration_heavy_tail(64, 2.2, seed=0), PT.random_k_regular(64, 6, seed=0)]
    sj = JC.compile_schedule(gj, "sparse", round_map=JC.cyclic_map(1))
    sp = PC.compile_schedule(gp, "sparse", round_map=PC.cyclic_map(1), device="cpu")
    assert int(sj.stacked["hub_rows"].shape[1]) > 0
    assert [p.hub_rows.shape[0] > 0 for p in sp.plans] == [True, False]
    p = _params_np(64, seed=4)
    for r in range(4):
        assert sp.select(r).mix_operator() is sp.plans[r % 2].hyb
        got = sp.mix(_to_torch(p), r)
        _assert_tree_close(got, jax.jit(lambda q, r=r: sj.mix(q, r))(_to_jax(p)))
        _assert_tree_close(got, JC.compile_plan(gj[r % 2], "sparse").mix(_to_jax(p)))


# ------------------------------------------------------- the plain version
def _numpy_ell(op: HYB, x: np.ndarray) -> np.ndarray:
    """The ELL rows as a loop of separately rounded fp32 products and sums."""
    idx, wt, sw = op.slot_idx.numpy(), op.slot_w.numpy(), op.self_w.numpy()
    out = np.empty((op.n_rows, x.shape[1]), np.float32)
    for i in range(op.n_rows):
        acc = (sw[i] * x[i]).astype(np.float32)
        for s in range(idx.shape[0]):
            if wt[s, i] != 0:
                acc = (acc + (wt[s, i] * x[idx[s, i]]).astype(np.float32)).astype(np.float32)
        out[i] = acc
    return out


@pytest.mark.parametrize("family", ["ba", "heavy_tail", "ring", "complete"])
def test_plain_version_is_the_operator(family):
    """``mix_hyb_ref``: ELL rows bitwise the separately rounded chain; every
    row within 1e-6 · max|x| of the dense receive operator; bf16 in, bf16
    out, the fp32 result rounded once."""
    _, pp = _plans(family, 64)
    x = torch.randn(64, 129, generator=torch.Generator().manual_seed(5))
    got = mix_hyb_ref(pp.hyb, x)
    ell = (pp.hyb.hub_of < 0).numpy()
    np.testing.assert_array_equal(got.numpy()[ell], _numpy_ell(pp.hyb, x.numpy())[ell])
    m = receive_matrix(FAMILIES[family](PT, 64)).astype(np.float64)
    want = m @ x.numpy().astype(np.float64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * float(x.abs().max()), rtol=0)
    xb = x.to(torch.bfloat16)
    got_b = mix_hyb_ref(pp.hyb, xb)
    assert got_b.dtype == torch.bfloat16
    assert torch.equal(got_b, mix_hyb_ref(pp.hyb, xb.float()).to(torch.bfloat16))


def test_row_block_and_hub_buffer():
    """A row block over a longer buffer, hubs read from a second one: the
    rows of the square product when the buffers hold the same rows."""
    _, pp = _plans("ba", 64)
    x = torch.randn(64, 33, generator=torch.Generator().manual_seed(6))
    full = mix_hyb(pp.hyb, x)
    extra = torch.cat([x, torch.randn(7, 33)])  # rows no slot reads
    assert torch.equal(mix_hyb(pp.hyb, extra, x), full)
    assert torch.equal(mix_flat(pp.hyb, x, 64, w_hub=x), full)


def test_wrapper_checks_and_counts_nothing_on_the_cpu():
    _, pp = _plans("ba", 64)
    op = pp.hyb
    x = torch.randn(64, 8)
    before = mix_hyb.launches
    mix_hyb(op, x)
    assert mix_hyb.launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="output rows"):
        mix_hyb(op, x[:32])
    with pytest.raises(TypeError, match="slot_w"):
        mix_hyb(op._replace(slot_w=op.slot_w.double()), x)
    with pytest.raises(ValueError, match="hub_ptr"):
        mix_hyb(op._replace(hub_ptr=op.hub_ptr[:-1]), x)
    with pytest.raises(ValueError, match="w_hub"):
        mix_hyb(op, x, x.to(torch.bfloat16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mix_hyb(op, x.double())
    with pytest.raises(ValueError, match="asked for"):
        mix_flat(op, x, 32)
    # an operator built from tensors equals the one from numpy arrays
    again = hyb_from_tables(pp.slot_idx, pp.slot_w, pp.hyb_self_w, pp.hub_rows, pp.hub_m, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, op))


# hyb_route's cases: (label, n_src, n_hub_src, same buffer, dtype, the
# operator's output rows, ELL slots and hub rows, the row's width d, the
# route).  The staged rows a call makes: W's n rows (the unsharded call
# passes W for the hub lists too), or a rank's [local | halo] rows at S = 4
# plus the n gathered rows its hub lists read, or at S = 1 its n rows plus
# the n gathered ones; the slab route while they fit in SLAB_MAX_ROWS, for
# an operator with hub rows (these cases: 8 slots, 4 hubs) at d = 4096
F32, BF16 = torch.float32, torch.bfloat16
D_MAIN, D_LAUNCH = 567_434, 361_600  # the paper MLP's row; the launch layer's reduced qwen2.5-3b
STAGED_CASES = [
    (16, 16, True, 16, "slab"), (256, 256, True, 256, "slab"), (1024, 1024, True, 1024, "slab"),
    (4096, 4096, True, 4096, "rows"), (6, 16, False, 4, "slab"), (66, 256, False, 64, "slab"),
    (258, 1024, False, 256, "slab"), (1026, 4096, False, 1024, "rows"), (1024, 1024, False, 1024, "rows"),
    (SLAB_MAX_ROWS, SLAB_MAX_ROWS, True, SLAB_MAX_ROWS, "slab"),
    (SLAB_MAX_ROWS + 1, SLAB_MAX_ROWS + 1, True, SLAB_MAX_ROWS + 1, "rows"),
]
ROUTE_CASES = [
    *((f"staged {n_src} + {n_hub} ({'same' if same else 'two'} buffers) {str(dt)[6:]}", n_src, n_hub, same, dt,
       n_rows, 8, 4, 4096, want)
      for n_src, n_hub, same, n_rows, want in STAGED_CASES for dt in (F32, BF16)),
    # chip_smoke.py phase 3's ten shapes of row 2y (the operators' own
    # features), the winner in turns on the card (PERF.md, row 2y)
    ("ring-1024", 1024, 0, True, F32, 1024, 2, 0, D_MAIN, "rows"),
    ("ring-1024 bf16", 1024, 0, True, BF16, 1024, 2, 0, D_MAIN, "slab"),
    ("kreg4-1024", 1024, 0, True, F32, 1024, 4, 0, D_MAIN, "slab"),
    ("ba-1024 (m 3)", 1024, 1024, True, F32, 1024, 13, 61, D_MAIN, "slab"),
    ("heavytail-1024", 1024, 1024, True, F32, 1024, 12, 52, D_MAIN, "slab"),
    ("ba-1024 (m 8)", 1024, 1024, True, F32, 1024, 27, 86, D_MAIN, "slab"),
    ("kreg4-256", 256, 0, True, F32, 256, 4, 0, D_MAIN, "slab"),
    ("circulant-16 (1, 2): 16 hub rows", 16, 16, True, F32, 16, 0, 16, D_LAUNCH, "rows"),
    ("kreg4-256 S=4 rank 0", 256, 0, False, F32, 64, 4, 0, 256, "slab"),
    ("ba-256 S=4 rank 0", 320, 256, False, F32, 64, 8, 31, 256, "slab"),
    # the crossings: FEW_ROWS rows in fp32 (FEW_ROWS / 2 in bf16) with and
    # without hub rows, at FEW_ROWS_MIN_D columns and one fewer; the thin
    # ELL rows (fp32, no hub rows, at most 1 + THIN_SLOTS entries)
    ("few rows with hubs", 128, 128, True, F32, FEW_ROWS, 4, FEW_ROWS, FEW_ROWS_MIN_D, "rows"),
    ("one row more with hubs", 128, 128, True, F32, FEW_ROWS + 1, 4, FEW_ROWS + 1, FEW_ROWS_MIN_D, "slab"),
    ("few rows, one column short", 128, 128, True, F32, FEW_ROWS, 4, FEW_ROWS, FEW_ROWS_MIN_D - 1, "slab"),
    ("few rows bf16", 128, 0, True, BF16, FEW_ROWS // 2, 4, 0, D_LAUNCH, "rows"),
    ("one row more bf16", 128, 0, True, BF16, FEW_ROWS // 2 + 1, 4, 0, D_LAUNCH, "slab"),
    ("thin ELL rows", 512, 0, True, F32, 512, THIN_SLOTS, 0, D_LAUNCH, "rows"),
    ("one slot more", 512, 0, True, F32, 512, THIN_SLOTS + 1, 0, D_LAUNCH, "slab"),
    ("thin ELL rows and a hub", 512, 512, True, F32, 512, THIN_SLOTS, 1, D_LAUNCH, "slab"),
    ("thin ELL rows in bf16", 512, 0, True, BF16, 512, THIN_SLOTS, 0, D_LAUNCH, "slab"),
    ("thin ELL rows past the slab", SLAB_MAX_ROWS + 1, 0, True, BF16, SLAB_MAX_ROWS + 1, THIN_SLOTS, 0, D_LAUNCH,
     "rows"),
]


@pytest.mark.parametrize("label,n_src,n_hub_src,same,dtype,n_rows,n_slots,n_hubs,d,want", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_hyb_route_is_picked_by_staged_rows(label, n_src, n_hub_src, same, dtype, n_rows, n_slots, n_hubs, d, want):
    """The route from the staged rows and the operator's shape: the rows
    route past SLAB_MAX_ROWS staged rows, at up to FEW_ROWS fp32 (FEW_ROWS / 2
    bf16) output rows of at least FEW_ROWS_MIN_D columns, and for fp32
    hub-free ELL rows of at most 1 + THIN_SLOTS entries; else the slab
    route."""
    assert hyb_route(n_src, n_hub_src, same, dtype, n_rows=n_rows, n_slots=n_slots, n_hubs=n_hubs, d=d) == want
    assert set(mix_hyb.launches_by_route) == set(HYB_ROUTES) == {"slab", "rows"}


@pytest.mark.parametrize("family", ["ring", "kreg", "ba"])
@pytest.mark.parametrize("n", [16, 128])
def test_route_of_reads_the_operator(family, n):
    """``route_of`` passes the call's staged rows and the operator's own
    rows, ELL width and hub rows to ``hyb_route``, for W alone and for a
    second hub buffer."""
    op = PC.compile_plan(FAMILIES[family](PT, n), "sparse", device="cpu").hyb
    for dtype in (F32, BF16):
        w = torch.zeros(n, 3, dtype=dtype)
        for w_hub, n_hub, same in ((None, n if op.n_hubs else 0, True), (torch.zeros(2 * n, 3, dtype=dtype),
                                                                          2 * n if op.n_hubs else 0, False)):
            assert route_of(op, w, w_hub) == hyb_route(n, n_hub, same, dtype, n_rows=op.n_rows,
                                                       n_slots=op.slot_idx.shape[0], n_hubs=op.n_hubs, d=3)


def test_hyb_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        hyb_route(16, 16, True, torch.float64, n_rows=16, n_slots=4, n_hubs=0, d=8)


@pytest.mark.parametrize("family", ["ba", "heavy_tail", "ring", "complete"])
def test_cpu_calls_count_on_no_route(family):
    """A call on CPU tensors runs the plain version: no launch on any route,
    in either form (W for the hubs, or a second buffer)."""
    _, pp = _plans(family, 64)
    x = torch.randn(64, 9, generator=torch.Generator().manual_seed(2))
    before = (mix_hyb.launches, dict(mix_hyb.launches_by_route))
    mix_hyb(pp.hyb, x)
    mix_hyb(pp.hyb, x, x.clone())
    assert (mix_hyb.launches, mix_hyb.launches_by_route) == before


@pytest.mark.parametrize("family,n", [("ba", 64), ("ba", 256), ("heavy_tail", 256), ("ring", 64), ("kreg", 64)])
def test_walk_deals_the_heaviest_rows_first(family, n):
    """The operator's walk is a permutation of its rows by their entries (a
    hub row's nonzeros, an ELL row's self term and live slots), most first,
    ties in row order: the slab route deals it to warps in that order.  The
    entries it points at are M's nonzeros, an ELL row's self term first,
    then its slots in slot order; a hub row's in ascending column."""
    _, pp = _plans(family, n)
    op = pp.hyb
    assert op.walk.dtype == op.entries.dtype == torch.int32 and op.walk.shape == (n, 4)
    walk, first, count, is_hub = op.walk.numpy().T
    assert sorted(walk.tolist()) == list(range(n))
    cost = (op.slot_w.numpy() != 0).sum(0) + 1
    hub_len = np.diff(op.hub_ptr.numpy())
    cost[op.hub_rows.numpy()] = hub_len
    assert np.array_equal(count, cost[walk])
    assert np.array_equal(is_hub, np.isin(walk, op.hub_rows.numpy()))
    assert np.all(np.diff(cost[walk]) <= 0)
    ties = np.diff(cost[walk]) == 0
    assert np.all(np.diff(walk)[ties] > 0)
    if op.n_hubs:  # the hub rows of a hub graph lead the walk
        assert set(walk[: op.n_hubs].tolist()) >= set(op.hub_rows.numpy()[hub_len > cost.max() // 2].tolist())
    m = receive_matrix(FAMILIES[family](PT, n))
    assert int(cost.sum()) == int((m != 0).sum())
    # the lists lie one after another in the walk's order
    assert np.array_equal(first, np.r_[0, np.cumsum(count)[:-1]]) and op.entries.shape[0] == int(count.sum())
    src, wbits = op.entries.numpy().T
    wt = wbits.view(np.float32)
    slot_idx, slot_w, self_w = op.slot_idx.numpy(), op.slot_w.numpy(), op.self_w.numpy()
    for row, f, c, hub in op.walk.numpy():
        got = (src[f : f + c], wt[f : f + c])
        if hub:
            h = int(np.flatnonzero(op.hub_rows.numpy() == row)[0])
            lo, hi = op.hub_ptr.numpy()[h : h + 2]
            want = (op.hub_col.numpy()[lo:hi], op.hub_val.numpy()[lo:hi])
        else:
            live = slot_w[:, row] != 0
            want = (np.r_[row, slot_idx[live, row]], np.r_[self_w[row], slot_w[live, row]].astype(np.float32))
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        dense = np.zeros(n, np.float64)
        np.add.at(dense, got[0], got[1])
        np.testing.assert_allclose(dense, m[row], rtol=1e-6, atol=1e-7)


# -------------------------------------------------------- sharded, spawned
def _sharded_rank(rank: int, n_shards: int) -> dict:
    seen = []
    real = PS.mix_flat

    def recording(op, w, *a, **k):
        seen.append(type(op).__name__)
        return real(op, w, *a, **k)

    PS.mix_flat = recording
    out = {}
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.standard_normal((64, 21)).astype(np.float32))
    tree = {"a": torch.as_tensor(rng.standard_normal((64, 4, 3)).astype(np.float32)),
            "b": torch.as_tensor(rng.standard_normal((64, 5)).astype(np.float32)).to(torch.bfloat16)}
    try:
        for gname, build in SHARD_GRAPHS.items():
            plan = PC.compile_plan(build(PT), "sparse", device="cpu")
            sp = plan.shard(n_shards=n_shards)
            seen.clear()
            flat, mixed = sp.mix(x), sp.mix(tree)
            local = sp.local_mix(x[sp.rows].contiguous())
            ops_clean = list(seen)
            seen.clear()
            active = torch.as_tensor(rng.random(64) < 0.8)
            masked = sp.mix(x, active=active)
            out[gname] = dict(
                flat=(flat.numpy(), plan.mix(x).numpy()), local=(local.numpy(), plan.mix(x)[sp.rows].numpy()),
                tree={k: (mixed[k].float().numpy(), plan.mix(tree)[k].float().numpy()) for k in tree},
                masked=(masked.numpy(), plan.mix(x, active=active).numpy()), ops_clean=ops_clean,
                ops_masked=list(seen), hub_gather=sp.hub_gather,
                counts=(sp.cross_shard_rows_per_round(), sp.collectives_per_round()),
            )
    finally:
        PS.mix_flat = real
    return out


@functools.cache
def _sharded_results(n_shards: int) -> list[dict]:
    if n_shards > 1:
        return spawn_ranks(_sharded_rank, n_shards, n_shards, timeout=SPAWN_TIMEOUT)
    threads = torch.get_num_threads()
    with tempfile.TemporaryDirectory() as tmp:
        torch.distributed.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        torch.set_num_threads(1)
        try:
            return [_sharded_rank(0, 1)]
        finally:
            torch.distributed.destroy_process_group()
            torch.set_num_threads(threads)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_hyb_is_the_unsharded_round(n_shards):
    """The sharded clean mix (flat, tree, a rank's local block) over S gloo
    ranks runs the HYB operator, once a buffer, and is the unsharded round
    bit for bit; the hub all-gather is made iff some shard owns a hub (BA
    has hubs, kreg4 none) and counted; a masked round takes the tiles and
    is the unsharded masked round to fp32 rounding (bitwise at S = 1)."""
    for res in _sharded_results(n_shards):
        for gname, r in res.items():
            for key in ("flat", "local"):
                np.testing.assert_array_equal(*r[key], err_msg=f"{gname} {key}")
            for leaf, (got, want) in r["tree"].items():
                np.testing.assert_array_equal(got, want, err_msg=f"{gname} tree {leaf}")
            # flat, then one buffer a dtype of the tree, then the local block
            assert r["ops_clean"] == ["HYB"] * 4 and r["ops_masked"] == ["BSR"], (gname, r["ops_clean"])
            assert r["hub_gather"] == (gname == "ba-64")
            rows, coll = r["counts"]
            if n_shards == 1:
                np.testing.assert_array_equal(*r["masked"], err_msg=gname)
                assert (rows, coll) == (0, 0)
            else:
                got, want = r["masked"]
                np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-20 * float(np.abs(want).max()))
                assert coll == 1 + int(gname == "ba-64"), (gname, coll)
