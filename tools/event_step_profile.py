"""Where does the host time of one event step go?

Builds the event step of ``chip_smoke.py`` phase 4g (kreg4-16, the paper
MLP at full width, d = 567,434, 8 local batches an endpoint, SGD with
momentum, uncompressed and int8) and, beside it, one synchronous round of
the same plan and model over all 16 nodes, and prints for each:

* its eager wall time (host clock, the card finished; min / median / max
  of ``--reps``), before any profiler session in the process and again
  after the profiles below;
* the number of device operations in one call, their summed device time
  and the kernels that take most of it (``torch.profiler``);
* the host side of the same profile: the step's parts (the local steps,
  the exchange, the optimizer re-init), each timed through a
  ``record_function`` range around the executor's own callables (the rest
  is the pair's gathers, the scatter back and Python), and the operators
  with the most self CPU time, with their call counts;
* the host cost of one trivial CUDA operator (an in-place add on a
  1-element tensor, 2000 times): the machine's dispatch floor.

Needs one GPU, about 1 min:

    python tools/event_step_profile.py [--reps 20] [--top 25]

``--device cpu --dims 784,16,10`` runs it on the CPU at a small width (its
numbers then are the CPU's own work, not dispatch).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dims", default="784,512,256,128,10")
    ap.add_argument("--local-batches", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.convert import state_from_numpy
    from repro_torch.core import topology as T
    from repro_torch.core.commplan import compile_plan
    from repro_torch.core.compress import Compression
    from repro_torch.data import batch_index_schedule, mnist_like, node_datasets
    from repro_torch.device import resolve_device
    from repro_torch.fed import executor as ex
    from repro_torch.fed.trainer import make_round_fn
    from repro_torch.models.paper_models import classifier_loss, mlp_forward
    from repro_torch.optim import sgd

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    print("torch", torch.__version__, "device", dev)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    n, b_local = 16, args.local_batches
    dims = [int(x) for x in args.dims.split(",")]
    rng = np.random.default_rng(7)
    params_np = {f"fc{i}": {"w": (rng.standard_normal((n, dims[i], dims[i + 1])) * math.sqrt(2.0 / dims[i]))
                            .astype(np.float32), "b": np.zeros((n, dims[i + 1]), np.float32)}
                 for i in range(len(dims) - 1)}
    ds = mnist_like(n * 64 + 256, seed=2)
    xs, ys = node_datasets(ds, [np.arange(i * 64, (i + 1) * 64) for i in range(n)])
    opt = sgd(1e-3, 0.5)

    def loss_fn(p, b):
        return classifier_loss(mlp_forward(p, b[0]), b[1])

    graph = T.random_k_regular(n, 4, seed=0)
    plan = compile_plan(graph, "dense", device=dev)
    st = state_from_numpy(params_np, optimizer=opt, device=dev)
    print(f"d = {st.params.shape[1]:,}, {b_local} local batches of 16")
    sched_np = batch_index_schedule(64, n, 16, 4 * b_local, seed=0)
    sched = torch.as_tensor(ex._as_round_schedule(sched_np, 4, b_local), dtype=torch.int64, device=dev)
    xs_d, ys_d = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)

    def dispatch_floor():
        """Host µs of one trivial operator on the card: an in-place add on a
        1-element tensor, 2000 times."""
        one = torch.zeros(1, device=dev)
        for _ in range(100):
            one.add_(1.0)
        sync()
        t0 = time.perf_counter()
        for _ in range(2000):
            one.add_(1.0)
        us = (time.perf_counter() - t0) / 2000 * 1e6
        sync()
        return us

    # record_function ranges around the executor's own callables: the parts
    real = {name: getattr(ex, name) for name in ("_local_steps", "pair_mix_ref", "quant_mix_pair")}

    def ranged(label, fn):
        def wrapper(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapper

    real_init = opt.init

    def timed(call):
        """(min, median, max) eager wall in ms, the card finished each time."""
        for _ in range(3):
            call()
        sync()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            call()
            sync()
            walls.append(time.perf_counter() - t0)
        walls.sort()
        return walls[0] * 1e3, walls[len(walls) // 2] * 1e3, walls[-1] * 1e3

    def report(label, call, ms):
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        for name, fn in real.items():
            setattr(ex, name, ranged(f"part:{name}", fn))
        object.__setattr__(opt, "init", ranged("part:optimizer.init", real_init))
        try:
            with profile(activities=acts) as prof:
                time.sleep(0.1)
                t0 = time.perf_counter()
                call()
                sync()
                prof_ms = (time.perf_counter() - t0) * 1e3
                time.sleep(0.1)
        finally:
            for name, fn in real.items():
                setattr(ex, name, fn)
            object.__setattr__(opt, "init", real_init)
        dev_ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        cpu_ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
        top_level = [e for e in cpu_ops if e.cpu_parent is None and not e.name.startswith("part:")]
        print(f"\n== {label}: {ms:.3f} ms eager (median, before any profiler session); {prof_ms:.3f} ms under the "
              f"profiler; "
              f"{len(dev_ops)} device operations, {sum(e.time_range.elapsed_us() for e in dev_ops) / 1e3:.3f} ms "
              f"of device time summed; {len(cpu_ops)} host events, {len(top_level)} of them top-level "
              f"({ms * 1e3 / max(len(dev_ops), 1):.1f} µs of eager wall a device operation)")
        parts = {}
        for e in cpu_ops:
            if e.name.startswith("part:"):
                parts.setdefault(e.name[5:], []).append(e.time_range.elapsed_us())
        for name, us in parts.items():
            print(f"  part {name:22s} {len(us):3d} calls, {sum(us) / 1e3:8.3f} ms of host time (profiled)")
        by_kernel = {}
        for e in dev_ops:
            k = by_kernel.setdefault(e.name[:70], [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
        print(f"  device operations by kernel, top {args.top // 2}:")
        for name, (cnt, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[: args.top // 2]:
            print(f"    {name:70s} {cnt:4d} launches {us / 1e3:8.3f} ms ({us / cnt:7.1f} µs each)")
        ka = prof.key_averages()
        rows = sorted((e for e in ka if not e.key.startswith("part:")), key=lambda e: e.self_cpu_time_total,
                      reverse=True)
        total_self = sum(e.self_cpu_time_total for e in ka if not e.key.startswith("part:"))
        print(f"  host self time summed over operators: {total_self / 1e3:.3f} ms; top {args.top}:")
        for e in rows[: args.top]:
            print(f"    {e.key[:48]:48s} {e.count:5d} calls {e.self_cpu_time_total / 1e3:8.3f} ms self "
                  f"({e.self_cpu_time_total / max(e.count, 1):7.1f} µs a call)")

    calls = {}
    for comp_label, comp in (("uncompressed", None), ("int8", Compression("int8"))):
        mirror = torch.zeros_like(st.params) if comp is not None else None
        step = ex._make_event_step(loss_fn, opt, plan, sched, 4, xs_d, ys_d, layout=st.layout, reinit_opt=True,
                                   comp=comp)
        counts, clocks = np.zeros(n, np.int32), np.zeros(n, np.float32)
        calls[f"one {comp_label} event step (kreg4-16, edge 5)"] = (
            lambda step=step, mirror=mirror, counts=counts, clocks=clocks:
            step(st.params, st.opt_state, mirror, counts, clocks, 5, np.float32(1.0), True))

    rf = make_round_fn(loss_fn, opt, plan)
    idx = sched[0]
    batch = (torch.stack([xs_d[i][idx[i]] for i in range(n)]), torch.stack([ys_d[i][idx[i]] for i in range(n)]))
    state = [dataclasses.replace(st, params=st.params.clone())]

    def one_round():
        state[0], _ = rf(state[0], batch)

    calls["one synchronous round (kreg4-16, all 16 nodes, batches pre-gathered)"] = one_round

    # eager walls before any profiler session in this process, then the
    # profiles, then the same walls again: a profiler session leaves every
    # later launch with more host time
    before = {"floor": dispatch_floor(), **{label: timed(call) for label, call in calls.items()}}
    for label, call in calls.items():
        report(label, call, before[label][1])
    after = {"floor": dispatch_floor(), **{label: timed(call) for label, call in calls.items()}}
    print(f"\n== eager walls (ms: min / median / max of {args.reps}), before and after the profiler sessions")
    print(f"  dispatch floor: {before['floor']:.2f} µs an operator before, {after['floor']:.2f} µs after")
    for label in calls:
        b, a = before[label], after[label]
        print(f"  {label:72s} before {b[0]:.3f} / {b[1]:.3f} / {b[2]:.3f}   after {a[0]:.3f} / {a[1]:.3f} / "
              f"{a[2]:.3f} ({a[1] / b[1]:.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
