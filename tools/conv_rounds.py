#!/usr/bin/env python3
"""One DecAvg round of the paper's CNN (cfg B) and VGG16 (cfg C, full width)
on the card, with cuDNN's deterministic algorithms on and off, in turns.

    python3 tools/conv_rounds.py [--model cnn|vgg16|both] [--turns 3]

For each model: a 16-node He-initialised ensemble (CNN on BA(m=8)-16,
So2Sat-like data; VGG16 on random 4-regular-16, CIFAR-10-like data), one
round of 2 local steps of 16 images a node and the dense mix, run three
times from copies of one state in each setting.  Prints, per setting and
turn, the round's host-clock times after a sync and whether the three runs
agree bit for bit; then the medians.  ``repro_torch.device.resolve_device``
selects the deterministic algorithms; "off" is cuDNN's default.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=["cnn", "vgg16", "both"], default="both")
    p.add_argument("--turns", type=int, default=3)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("conv_rounds: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import topology as T
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.data import batch_index_schedule, cifar10_like, node_datasets, partition_iid, so2sat_like
    from repro_torch.device import resolve_device
    from repro_torch.fed import init_fl_state, make_round_fn
    from repro_torch.fed.trainer import copy_state
    from repro_torch.models.paper_models import classifier_loss, cnn_forward, init_cnn, init_vgg16, vgg16_forward
    from repro_torch.optim import sgd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = resolve_device("cuda")
    n, items, b_local = 16, 64, 2
    models = {
        "cnn": (init_cnn, cnn_forward, so2sat_like, T.barabasi_albert(n, 8, seed=0)),
        "vgg16": (init_vgg16, vgg16_forward, cifar10_like, T.random_k_regular(n, 4, seed=0)),
    }
    for name in ("cnn", "vgg16") if args.model == "both" else (args.model,):
        init, forward, data, graph = models[name]
        ds = data(n * items, seed=0)
        xs, ys = node_datasets(ds, partition_iid(n * items, n, seed=0))
        opt = sgd(1e-3, 0.5)

        def loss_fn(params, batch, forward=forward):
            return classifier_loss(forward(params, batch[0]), batch[1])

        state = init_fl_state(0, n, lambda g, gains, init=init: init(InitConfig("he_normal", gains), g), opt,
                              device=dev)
        round_fn = make_round_fn(loss_fn, opt, graph, device=dev)
        idx = torch.as_tensor(batch_index_schedule(items, n, 16, b_local, seed=0), device=dev).long().permute(1, 0, 2)
        node = torch.arange(n, device=dev)[:, None, None]
        xs_d, ys_d = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
        batch = (xs_d[node, idx], ys_d[node, idx])
        round_fn(copy_state(state), batch)  # warm-up: cuDNN's plans, the kernels' first load
        times: dict[bool, list[float]] = {True: [], False: []}
        for turn in range(args.turns):
            for det in ((True, False) if turn % 2 == 0 else (False, True)):
                torch.backends.cudnn.deterministic = det
                outs, ts = [], []
                for _ in range(3):
                    s = copy_state(state)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out, _ = round_fn(s, batch)
                    torch.cuda.synchronize()
                    ts.append((time.perf_counter() - t0) * 1e3)
                    outs.append(out.params)
                    del s, out
                same = all(torch.equal(outs[0], o) for o in outs[1:])
                del outs
                times[det] += ts
                print(f"{name} d={state.layout.size} deterministic {'on ' if det else 'off'} turn {turn}: "
                      f"round {', '.join(f'{t:.2f}' for t in ts)} ms; three runs bitwise equal: {same}", flush=True)
        torch.backends.cudnn.deterministic = True
        on, off = statistics.median(times[True]), statistics.median(times[False])
        print(f"{name}: median round {on:.2f} ms deterministic, {off:.2f} ms default ({on / off - 1:+.1%}); {smi}",
              flush=True)
        del state, batch, xs_d, ys_d
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
