"""The port's roofline layer and dry run (``repro_torch/launch/roofline.py``,
``repro_torch/launch/dryrun.py``) against the JAX package's.

* The roofline functions on the inputs of ``tests/test_roofline.py``:
  ``extrapolate_depth``, ``extrapolate_depth_and_seq``,
  ``_nonneg_poly_extrapolate`` and ``model_flops`` equal to the JAX ones;
  ``RooflineTerms`` the same terms at the H100's data-sheet peaks;
  ``terms_from_costs`` on the JAX HLO parse's per-kind bytes.
* ``StepCounter``: FLOPs and bytes of a matmul on fake tensors, the operand
  bytes of a known all-gather (DTensor's and a plain c10d one) on a fake
  group of 4 ranks, the peak of live bytes.
* ``run_one`` on a reduced config in a fake world torn down after, and the
  CLI's records read back by ``benchmarks.run roofline``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.launch import roofline as JRL  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.dtensor import DTensor, FakeTensorMode, Replicate, Shard, fake_world  # noqa: E402
from repro_torch.launch import dryrun as PD  # noqa: E402
from repro_torch.launch import roofline as PRL  # noqa: E402
from repro_torch.launch import steps as PS  # noqa: E402

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
SYNTH_HLO = """
ENTRY %main (a: f32[8,128], b: bf16[4,256]) -> f32[8,128] {
  %a = f32[8,128]{1,0} parameter(0)
  %b = bf16[4,256]{1,0} parameter(1)
  %ag = bf16[64,256]{1,0} all-gather(%b), channel_id=1, dimensions={0}
  %ar = f32[8,128]{1,0} all-reduce(%a), channel_id=2, to_apply=%sum
  %cp = f32[8,128]{1,0} collective-permute(%ar), channel_id=3, source_target_pairs={{0,1}}
  %a2a = (f32[2,128]{1,0}, f32[2,128]{1,0}) all-to-all(%a, %a), channel_id=4
  ROOT %out = f32[8,128]{1,0} add(%cp, %cp)
}
"""


def _both(cls_j, cls_p, *args):
    return cls_j(*args), cls_p(*args)


def test_peaks_are_the_h100_data_sheet():
    assert (PRL.PEAK_FLOPS, PRL.HBM_BW, PRL.LINK_BW, PRL.ICI_BW) == (989e12, 3.35e12, 450e9, 450e9)


def test_terms_and_dominant():
    j, p = _both(JRL.RooflineTerms, PRL.RooflineTerms, 197e12, 819e9 * 2, 50e9 * 0.5)
    assert (p.flops, p.hbm_bytes, p.coll_bytes) == (j.flops, j.hbm_bytes, j.coll_bytes)
    assert np.isclose(p.compute_s, 197e12 / 989e12) and np.isclose(p.memory_s, 819e9 * 2 / 3.35e12)
    assert np.isclose(p.collective_s, 25e9 / 450e9)
    assert p.dominant == "memory" and set(p.as_dict()) == set(j.as_dict())
    t = PRL.RooflineTerms(flops=989e12 * 3, hbm_bytes=3.35e12, coll_bytes=450e9)
    assert (t.compute_s, t.memory_s, t.collective_s, t.dominant) == (3.0, 1.0, 1.0, "compute")


def test_terms_from_costs_on_the_jax_parse():
    cost = {"flops": 123.0, "bytes accessed": 456.0}
    j = JRL.terms_from_costs(cost, SYNTH_HLO)
    p = PRL.terms_from_costs(cost, JRL.collective_bytes(SYNTH_HLO))
    assert (p.flops, p.hbm_bytes, p.coll_bytes, p.coll_breakdown) == (j.flops, j.hbm_bytes, j.coll_bytes,
                                                                      j.coll_breakdown)


def test_depth_extrapolation_matches_jax():
    cb = lambda v: {k: (v if k == "all-reduce" else 0) for k in KINDS}  # noqa: E731
    ja, jb = JRL.RooflineTerms(10.0, 100.0, 5.0, cb(5)), JRL.RooflineTerms(16.0, 160.0, 8.0, cb(8))
    pa, pb = PRL.RooflineTerms(10.0, 100.0, 5.0, cb(5)), PRL.RooflineTerms(16.0, 160.0, 8.0, cb(8))
    for periods in (1, 2, 10, 36):
        j, p = JRL.extrapolate_depth(ja, jb, periods), PRL.extrapolate_depth(pa, pb, periods)
        assert (p.flops, p.hbm_bytes, p.coll_bytes, p.coll_breakdown) == (j.flops, j.hbm_bytes, j.coll_bytes,
                                                                          j.coll_breakdown)
    assert np.isclose(PRL.extrapolate_depth(pa, pb, 10).flops, 64.0)


def test_seq_extrapolation_matches_jax():
    cb0 = dict.fromkeys(KINDS, 0)

    def cost(mod, p, s):
        alpha, beta = 3 + 2 * s, 7 + s + 0.001 * s * s
        return mod.RooflineTerms(alpha + p * beta, 2 * (alpha + p * beta), 0.0, dict(cb0))

    pts = lambda mod: {(p, s): cost(mod, p, s) for p in (1, 2) for s in (256, 512, 1024, 2048)}  # noqa: E731
    j = JRL.extrapolate_depth_and_seq(pts(JRL), n_periods=12, seq_target=32768)
    p = PRL.extrapolate_depth_and_seq(pts(PRL), n_periods=12, seq_target=32768)
    assert (p.flops, p.hbm_bytes, p.coll_breakdown) == (j.flops, j.hbm_bytes, j.coll_breakdown)
    rng = np.random.default_rng(0)
    seqs = [256, 512, 1024, 2048]
    vals = [1000.0 * s * (1 + rng.uniform(-0.02, 0.02)) for s in seqs]
    assert PRL._nonneg_poly_extrapolate(seqs, vals, 32768) == JRL._nonneg_poly_extrapolate(seqs, vals, 32768)


def test_model_flops_matches_jax():
    for kind in ("train", "prefill", "decode"):
        assert PRL.model_flops(1_000_000, 100, kind) == JRL.model_flops(1_000_000, 100, kind)


# ------------------------------------------------------------- StepCounter
def test_counter_flops_bytes_and_peak():
    fm = FakeTensorMode()
    with fm:
        a, b = torch.empty(64, 128), torch.empty(128, 32)
    c = PRL.StepCounter(fm)
    with c:
        y = a @ b
        z = y.t()  # a view: no bytes, no storage
        del z
        w = y + 1.0
    assert c.flops == 2 * 64 * 128 * 32
    assert c.hbm_bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32) + 4 * 2 * 64 * 32
    assert c.peak == 2 * 4 * 64 * 32 and c.live == 2 * 4 * 64 * 32
    del y, w
    assert c.live == 0
    real = PRL.StepCounter(fm)
    with real:
        torch.ones(4) + 1  # a real tensor: not counted
    assert real.hbm_bytes == 0 and real.flops == 0


def test_counter_collective_operand_bytes_on_a_fake_group():
    """A DTensor all-gather of a (4·8, 128) fp32 tensor sharded 4 ways: one
    all-gather, its operand the local (8, 128) shard; a plain c10d
    all-gather and all-reduce on fake tensors: their operands."""
    from torch.distributed.device_mesh import init_device_mesh

    with fake_world(4):
        mesh = init_device_mesh("cpu", (4,))
        fm = FakeTensorMode(allow_non_fake_inputs=True)
        with fm:
            local = torch.empty(8, 128)
            out = torch.empty(32, 128)
            red = torch.empty(16)
        x = DTensor.from_local(local, mesh, [Shard(0)], run_check=False)
        c = PRL.StepCounter(fm)
        with c:
            full = x.redistribute(mesh, [Replicate()])
            dist.all_gather_into_tensor(out, local)
            dist.all_reduce(red)
        assert tuple(full.to_local().shape) == (32, 128)
    assert not dist.is_initialized()
    assert c.coll["all-gather"] == 2 * 8 * 128 * 4 and c.n_collectives["all-gather"] == 2
    assert c.coll["all-reduce"] == 16 * 4 and c.n_collectives["all-reduce"] == 1
    assert c.terms().coll_bytes == 2 * 8 * 128 * 4 + 16 * 4


# ------------------------------------------------------------------ dryrun
@pytest.fixture
def small(monkeypatch):
    sh = dict(PS.SHAPES)
    for name, seq in (("train_4k", 64), ("prefill_32k", 64), ("decode_32k", 64)):
        sh[name] = dataclasses.replace(sh[name], seq_len=seq)
    monkeypatch.setattr(PS, "SHAPES", sh)
    return get_reduced_config("qwen2p5_3b")


def test_long_context_archs_match_jax():
    """The JAX dry run sets XLA_FLAGS when imported, so its set is read
    from the source."""
    import ast
    import pathlib

    src = pathlib.Path(JRL.__file__).with_name("dryrun.py").read_text()
    node = next(n for n in ast.parse(src).body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "LONG_CONTEXT_ARCHS")
    assert PD.LONG_CONTEXT_ARCHS == ast.literal_eval(node.value)
    assert PD.shape_applicable("rwkv6-3b", "long_500k") and not PD.shape_applicable("qwen2.5-3b", "long_500k")
    assert PD.shape_applicable("qwen2.5-3b", "train_4k")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_one_reduced_in_a_torn_down_world(small, shape):
    rec = PD.run_one("qwen2.5-3b", shape, cfg_override=small)
    assert not dist.is_initialized()
    assert rec["status"] == "ok", rec.get("traceback")
    assert {"arch", "shape", "mesh", "mixing", "variant", "status", "memory_analysis", "terms", "model_flops",
            "hlo_flops_total", "useful_flops_ratio", "wall_s"} <= set(rec)
    assert rec["mesh"] == "pod16x16" and rec["mixing"] == ("dense" if shape == "train_4k" else None)
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0 and mem["fits_h100_80gb"]
    t = rec["terms"]
    assert t["flops_per_chip"] > 0 and t["hbm_bytes_per_chip"] > 0 and set(t["collective_breakdown"]) == set(KINDS)
    assert rec["hlo_flops_total"] == t["flops_per_chip"] * 256
    if shape == "train_4k":  # the dense mix's all-gather over the node axis, at least
        assert t["collective_breakdown"]["all-gather"] > 0


@pytest.mark.parametrize("knob, value", [("attn_impl", "chunked"), ("swa_impl", "blocked")])
def test_unrendered_impls_are_refused(small, monkeypatch, tmp_path, knob, value):
    """The port renders only the full program: another impl is refused and
    no record is written under its name."""
    with pytest.raises(ValueError, match=knob):
        PD.run_one("qwen2.5-3b", "prefill_32k", cfg_override=small, variant={knob: value})
    monkeypatch.setattr(PD, "get_config", lambda arch: small)
    out = tmp_path / "dryrun"
    with pytest.raises(SystemExit):
        PD.main(["--arch", "qwen2.5-3b", "--shape", "prefill_32k", "--" + knob.replace("_", "-"), value,
                 "--out", str(out)])
    assert not out.exists()


def test_cli_writes_records_the_report_reads(small, monkeypatch, tmp_path, capsys):
    from repro_torch.benchmarks import roofline_report
    from repro_torch.benchmarks import run as prun

    monkeypatch.setattr(PD, "get_config", lambda arch: small)
    out = tmp_path / "dryrun"
    PD.main(["--arch", "qwen2.5-3b", "--shape", "prefill_32k", "--both-meshes", "--out", str(out)])
    files = sorted(p.name for p in out.iterdir())
    assert files == ["qwen2p5_3b__prefill_32k__pod16x16.json", "qwen2p5_3b__prefill_32k__pod2x16x16.json"]
    assert all(json.loads((out / f).read_text())["status"] == "ok" for f in files)
    monkeypatch.setattr(roofline_report, "RESULTS_DIR", str(out))
    capsys.readouterr()
    prun.main(["roofline", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "roofline.qwen2.5-3b.prefill_32k.pod2x16x16," in text and "roofline.summary,0.0,ok=2;errors=0" in text
