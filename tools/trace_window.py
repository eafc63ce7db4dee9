"""Does torch.profiler lose device kernels at the edges of a trace window?

Traces the rwkv6-3b 4 × 2048 prefill of ``chip_smoke.py`` phase 7b (random
weights, seed 0) again and again, in turns without and with idle margins
inside the window (sleep, call, synchronize, sleep), and prints for each
trace the device events, the launch calls and the count of the rwkv kernels
(32 each when nothing is lost), with the first and last kernels in time
order.  Needs one GPU, ~1.5 min:

    python tools/trace_window.py [--traces 16] [--margin-s 0.05]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

KINDS = ("rwkv_span_out", "rwkv_span_delta", "rwkv_span_scan", "nvjet")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traces", type=int, default=16)
    ap.add_argument("--margin-s", type=float, default=0.05)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.data import make_token_stream
    from repro_torch.device import resolve_device
    from repro_torch.fed import prefill
    from repro_torch.models import transformer as TF

    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print("torch", torch.__version__)
    cfg = get_config("rwkv6-3b")
    params = TF.init_params(torch.Generator(device=dev).manual_seed(0), cfg, InitConfig("trunc_normal", 1.0),
                            device=dev)
    prompts = torch.as_tensor(make_token_stream(4 * 2048, cfg.vocab_size, seed=3).reshape(4, 2048), device=dev)
    prefill(params, cfg, prompts)
    torch.cuda.synchronize()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    for i in range(args.traces):
        margin = args.margin_s if i % 2 else 0.0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            prefill(params, cfg, prompts)
            torch.cuda.synchronize()
            time.sleep(margin)
        events = prof.events()
        kernels = sorted((e for e in events if e.device_type == cuda), key=lambda e: e.time_range.start)
        counts = Counter(kind for e in kernels for kind in KINDS if kind in e.name)
        launches = sum(1 for e in events if e.device_type == cpu and e.name in LAUNCHES)
        print(f"trace {i} margin {margin} s: {len(kernels)} device events, {launches} launch calls, "
              f"{dict(counts)}; first {[e.name[:40] for e in kernels[:2]]} last {[e.name[:40] for e in kernels[-3:]]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
