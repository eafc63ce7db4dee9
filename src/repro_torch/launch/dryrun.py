"""Dry run of the production meshes (counterpart of ``repro/launch/dryrun.py``).

For every (architecture × input shape × mesh) combination: build the step
(``launch/steps.py``) on the production ``DeviceMesh`` over a fake world
of 256 or 512 ranks, run it once on fake tensors as rank 0, and record
the local shards' argument and output bytes, the peak of live bytes the
step makes (its outputs among them) and whether the arguments and that
peak fit one 80 GB H100, and the roofline
terms one rank's program issues (``launch/roofline.py``: FLOPs, pre-fusion
HBM bytes, collective operand bytes by kind, at the H100's data-sheet
peaks).

A host computation, as the JAX dry run is on forced host devices: the
fake world (a ``"fake"`` process group, ``repro_torch.dtensor.fake_world``)
is made inside ``run_one`` and torn down before it returns, never at
import, and its tensors are fake CPU tensors, so the count is of the plain
program (attention through the flash kernel's plain version, as XLA's CPU
lowering counts the ``attn_impl="full"`` program).  An eager run sees
every layer, so no depth or sequence extrapolation is needed
(``launch/roofline.py``), and the JAX CLI's ``--skip-extrapolation`` is not
taken.  Nor does the port render the JAX package's chunked attention or
blocked sliding window: ``--attn-impl`` / ``--swa-impl`` (and ``run_one``'s
``variant``) take only ``full``, and any other value is refused before a
record is written, so no record carries one program's terms under another's
name.

Meshes keep the JAX names, ``pod16x16`` and ``pod2x16x16``, so the two
packages' records join.  On HGX H100 machines an NVLink domain is 8 cards:
a 16-wide ``model`` axis spans two of them and its collectives cross the
slower inter-node fabric, so the collective term at NVLink's rate is a
lower bound there.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape prefill_32k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--mixing circulant]
    python -m repro_torch.launch.dryrun --all --both-meshes --out build/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

from repro_torch.configs.base import get_config, list_archs
from repro_torch.dtensor import FakeTensorMode, fake_world, local_shape
from repro_torch.flat import tree_leaves

from . import roofline as rl
from . import steps as steps_mod
from .mesh import N_CHIPS, make_production_mesh

OUT = os.path.join("build", "dryrun")
HBM_CAPACITY = 80 * 10**9  # bytes, one H100 SXM (80 GB)

# config knobs of the JAX package's §Perf variants the port does not render:
# only their "full" value is taken
RENDERED_IMPLS = ("attn_impl", "swa_impl")

# long_500k requires sub-quadratic state: native runners only
LONG_CONTEXT_ARCHS = {"gemma3_4b", "jamba_1p5_large_398b", "rwkv6_3b"}


def shape_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return _norm(arch) in LONG_CONTEXT_ARCHS
    return True


def _norm(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "p")


def _shard_bytes(tree, shardings) -> int:
    """Bytes of this rank's shards of a tree of global tensors."""
    total = 0
    for (_, t), (_, sh) in zip(tree_leaves(tree), tree_leaves(shardings)):
        shape, _ = local_shape(t.shape, sh.mesh, sh.placements)
        total += math.prod(shape) * t.element_size()
    return total


def _flat(x) -> list:
    return [t for _, t in tree_leaves(x)]


def run_one(
    arch: str,
    shape: str,
    *,
    multi_pod: bool = False,
    mixing: str = "dense",
    cfg_override=None,
    variant: dict | None = None,
) -> dict:
    """Build and run one combination on fake tensors; return its record.

    ``variant``: config overrides, e.g. {"attn_weight_sharding":
    "replicate"}.  Raises ``ValueError`` for a config whose ``attn_impl``
    or ``swa_impl`` is not ``"full"``: the port renders neither.
    """
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    if variant:
        cfg = dataclasses.replace(cfg, **variant)
    for knob in RENDERED_IMPLS:
        if getattr(cfg, knob) != "full":
            raise ValueError(f"{knob}={getattr(cfg, knob)!r}: the port renders only the full program, "
                             "so its terms would be those of another program")
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = N_CHIPS["multi" if multi_pod else "single"]
    rec: dict = {
        "arch": cfg.name,
        "shape": shape,
        "mesh": mesh_name,
        "mixing": mixing if shape == "train_4k" else None,
        "variant": variant or {},
        "status": "unknown",
    }
    t0 = time.time()
    try:
        with fake_world(chips):
            mesh = make_production_mesh(multi_pod=multi_pod)
            fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
            step, args, in_sh, out_sh = steps_mod.build(cfg, shape, mesh, multi_pod=multi_pod, mixing=mixing,
                                                        fake_mode=fake_mode)
            sharded = steps_mod.shard_args(args, in_sh)
            rec["build_s"] = round(time.time() - t0, 1)
            counter = rl.StepCounter(fake_mode)
            with counter:
                out = step(*sharded)
            rec["run_s"] = round(time.time() - t0 - rec["build_s"], 1)
            out_bytes = sum(t.to_local().numel() * t.to_local().element_size() for t in _flat(out))
            arg_bytes = _shard_bytes(args, in_sh)
            rec["memory_analysis"] = {
                "argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": out_bytes,
                "temp_size_in_bytes": counter.peak,
                "fits_h100_80gb": arg_bytes + counter.peak <= HBM_CAPACITY,
            }
            terms = counter.terms()
            rec["terms"] = terms.as_dict()
            rec["collective_counts"] = dict(counter.n_collectives)

            sh = steps_mod.SHAPES[shape]
            tokens = sh.global_batch * sh.seq_len if sh.kind in ("train", "prefill") else sh.global_batch
            mf = rl.model_flops(cfg.n_active_params(), tokens, sh.kind)
            rec["model_flops"] = mf
            rec["hlo_flops_total"] = terms.flops * chips
            rec["useful_flops_ratio"] = mf / max(terms.flops * chips, 1.0)
            rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--shape", type=str, default=None, choices=[*steps_mod.SHAPES, None])
    p.add_argument("--all", action="store_true", help="sweep all (arch × applicable shape)")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--mixing", type=str, default="dense", choices=["dense", "circulant"])
    p.add_argument("--out", type=str, default=OUT)
    p.add_argument("--attn-impl", type=str, default=None, choices=["full"],
                   help="only full: the port does not render the JAX package's chunked attention")
    p.add_argument("--swa-impl", type=str, default=None, choices=["full"],
                   help="only full: the port does not render the JAX package's blocked sliding window")
    p.add_argument("--attn-sharding", type=str, default=None, choices=["auto", "replicate", "qkv_split"])
    p.add_argument("--tag", type=str, default=None, help="suffix for result filenames")
    p.add_argument(
        "--sliding-window", type=int, default=None,
        help="force all layers to sliding-window attention of this size (enables long_500k for dense archs)",
    )
    args = p.parse_args(argv)

    variant = {}
    if args.attn_impl:
        variant["attn_impl"] = args.attn_impl
    if args.swa_impl:
        variant["swa_impl"] = args.swa_impl
    if args.attn_sharding:
        variant["attn_weight_sharding"] = args.attn_sharding
    if args.sliding_window:
        variant["block_pattern"] = ("swa",)
        variant["sliding_window"] = args.sliding_window
        variant["max_seq_len"] = 524288

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(steps_mod.SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            if not shape_applicable(arch, shape) and "sliding_window" not in variant:
                print(f"SKIP  {arch:28s} {shape:12s} (long-context inapplicable)")
                continue
            for mp in meshes:
                rec = run_one(arch, shape, multi_pod=mp, mixing=args.mixing, variant=variant or None)
                mesh_name = rec["mesh"]
                tag = f"{_norm(arch)}__{shape}__{mesh_name}" + (
                    f"__{args.mixing}" if shape == "train_4k" and args.mixing != "dense" else ""
                ) + (f"__{args.tag}" if args.tag else "")
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                if status == "ok":
                    t = rec["terms"]
                    extra = (
                        f"dom={t['dominant']:10s} comp={t['compute_s']:.2e}s "
                        f"mem={t['memory_s']:.2e}s coll={t['collective_s']:.2e}s "
                        f"useful={rec['useful_flops_ratio']:.2f}"
                    )
                else:
                    extra = rec["error"][:120]
                print(f"{status.upper():5s} {arch:28s} {shape:12s} {mesh_name:10s} "
                      f"{rec['wall_s']:6.1f}s {extra}", flush=True)


if __name__ == "__main__":
    main()
