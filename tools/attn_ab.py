#!/usr/bin/env python3
"""Time this checkout's attention and RWKV kernels against another
checkout's, in turns, on one NVIDIA GPU.

    python3 tools/attn_ab.py --other DIR [--pairs 3] [-k TEXT]

DIR is an unpacked checkout of another commit (``git archive``).  Each side
runs in a process of its own and calls ``flash_mha`` and ``rwkv6_chunked``
through its own wrappers, so each side's routing picks its own kernels
(``tools/ab.py`` says how).  The cases are phase 8's reduced fp32 launches
(device time, the unheld time a caller pays, and the call's host time) and
its two fp32 prefills' wall clock; the full-width fp32 prefills (qwen2.5-3b 4 × 2048 at
hd 128, gemma3-4b 2 × 2048 at hd 256, rwkv6-3b 4 × 2048 at M 64, and M 128
at 20 heads); the bf16 shapes of the full-width serve path (flash at hd 64 /
128 / 256, rwkv at M 64); and last, phase 8's flash launch timed unheld,
and its host time, again after a ``torch.profiler`` session in the same
process.  Each side's
output is held against the plain version: flash fp32 to 1e-5 · max|v|,
bf16 to that plus one bf16 ulp; rwkv out and state to 5e-5 · max|ref|.
"""
from __future__ import annotations

import sys

import ab


def _flash(b, h, kvh, s, hd, dtype, window=0, profiled=False):
    import torch

    from chip_smoke import BF16_RTOL
    from repro_torch.kernels import flash as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, s, n, hd, generator=gen, device="cuda").to(dtype).transpose(1, 2)
               for n in (h, kvh, kvh))
    before = dict(F.flash_mha.launches_by_route)
    out = F.flash_mha(q, k, v, causal=True, window=window)
    routes = [r for r, n in F.flash_mha.launches_by_route.items() if n != before[r]]
    ref = F.attention_ref(q, k, v, causal=True, window=window).float()
    atol = 1e-5 * max(float(v.float().abs().max()), 1.0)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    worst = float(((out.float() - ref).abs() / (atol + rtol * ref.abs())).max())
    if profiled:  # one call under the profiler: the process keeps its hooks
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            F.flash_mha(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
    return lambda: F.flash_mha(q, k, v, causal=True, window=window), {"worst": worst, "note": f"route {routes}"}


def _rwkv(b, l, h, m, dtype):
    import torch

    from repro_torch.kernels import rwkv as R

    gen = torch.Generator(device="cuda").manual_seed(0)
    r, k, v = (torch.randn(b, l, h * m, generator=gen, device="cuda").to(dtype).view(b, l, h, m) for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + 7.0 * torch.rand(b, l, h * m, generator=gen, device="cuda"))).view(b, l, h, m)
    u = 0.5 * torch.rand(h, m, generator=gen, device="cuda")
    before = dict(R.rwkv6_chunked.launches_by_route)
    got = R.rwkv6_chunked(r, k, v, w, u)
    routes = [r_ for r_, n in R.rwkv6_chunked.launches_by_route.items() if n != before[r_]]
    ref = R.rwkv6_chunked_ref(r, k, v, w, u)
    worst = max(float((g - e).abs().max()) / (5e-5 * float(e.abs().max())) for g, e in zip(got, ref))
    return lambda: R.rwkv6_chunked(r, k, v, w, u), {"worst": worst, "note": f"route {routes}"}


def _prefill(arch):
    """A reduced fp32 decoder's prefill of 2 prompts of 40 tokens, as phase 8
    runs it; held against the same prefill on the CPU (rtol 1e-4, atol 1e-5)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core.initialisation import InitConfig
    from repro_torch.data import make_token_stream
    from repro_torch.fed import prefill
    from repro_torch.models import transformer as TF

    cfg = get_reduced_config(arch)
    p_np = params_to_numpy(TF.init_params(torch.Generator().manual_seed(3), cfg, InitConfig("trunc_normal", 1.0),
                                          device="cpu"))
    prompt = make_token_stream(2 * 40, cfg.vocab_size, seed=3).reshape(2, 40)
    p, tokens = params_from_numpy(p_np, device="cuda"), torch.as_tensor(prompt, device="cuda")
    got = prefill(p, cfg, tokens).cpu().numpy()
    want = prefill(params_from_numpy(p_np, device="cpu"), cfg, torch.as_tensor(prompt)).numpy()
    worst = float((np.abs(got - want) / (1e-5 + 1e-4 * np.abs(want))).max())
    return lambda: prefill(p, cfg, tokens), {"worst": worst, "note": "logits against the CPU's"}


def cases() -> dict:
    """name -> (timing modes, build), as tools/ab.py takes them."""
    import torch

    from repro_torch.configs import get_config, get_reduced_config

    qwen, gemma, rwkv3b = get_config("qwen2.5-3b"), get_config("gemma3-4b"), get_config("rwkv6-3b")
    rq, rr = get_reduced_config("qwen2.5-3b"), get_reduced_config("rwkv6-3b")
    fp32, bf16 = torch.float32, torch.bfloat16
    p8_flash = (2, rq.n_heads, rq.n_kv_heads, 40, rq.resolved_head_dim, fp32)
    device_time, caller = ("held",), ("held", "unheld", "host")
    return {
        "flash phase 8 B2 H4/2 S40 hd32 fp32": (caller, lambda: _flash(*p8_flash)),
        "rwkv phase 8 B2 L40 H4 M32 fp32": (caller, lambda: _rwkv(2, 40, rr.d_model // rr.rwkv_head_dim,
                                                                  rr.rwkv_head_dim, fp32)),
        "prefill phase 8 qwen2.5-3b reduced fp32 2 x 40": (("wall",), lambda: _prefill("qwen2.5-3b")),
        "prefill phase 8 rwkv6-3b reduced fp32 2 x 40": (("wall",), lambda: _prefill("rwkv6-3b")),
        "flash qwen B4 H16/2 S2048 hd128 fp32": (device_time, lambda: _flash(
            4, qwen.n_heads, qwen.n_kv_heads, 2048, qwen.resolved_head_dim, fp32)),
        "flash gemma B2 H8/4 S2048 hd256 fp32": (device_time, lambda: _flash(
            2, gemma.n_heads, gemma.n_kv_heads, 2048, gemma.resolved_head_dim, fp32)),
        "rwkv rwkv6-3b B4 L2048 H40 M64 fp32": (device_time, lambda: _rwkv(4, 2048, rwkv3b.d_model // 64, 64, fp32)),
        "rwkv B4 L2048 H20 M128 fp32": (device_time, lambda: _rwkv(4, 2048, rwkv3b.d_model // 128, 128, fp32)),
        "rwkv B4 L2048 H20 M128 bf16": (device_time, lambda: _rwkv(4, 2048, rwkv3b.d_model // 128, 128, bf16)),
        "flash B4 H16/2 S2048 hd64 bf16": (device_time, lambda: _flash(4, qwen.n_heads, qwen.n_kv_heads, 2048, 64,
                                                                       bf16)),
        "flash qwen B4 H16/2 S2048 hd128 bf16": (device_time, lambda: _flash(
            4, qwen.n_heads, qwen.n_kv_heads, 2048, qwen.resolved_head_dim, bf16)),
        "flash qwen B1 H16/2 S512 hd128 bf16": (device_time, lambda: _flash(
            1, qwen.n_heads, qwen.n_kv_heads, 512, qwen.resolved_head_dim, bf16)),
        "flash gemma B2 H8/4 S2048 hd256 bf16": (device_time, lambda: _flash(
            2, gemma.n_heads, gemma.n_kv_heads, 2048, gemma.resolved_head_dim, bf16)),
        "flash gemma B2 H8/4 S2048 hd256 bf16 w1024": (device_time, lambda: _flash(
            2, gemma.n_heads, gemma.n_kv_heads, 2048, gemma.resolved_head_dim, bf16, gemma.sliding_window)),
        "rwkv rwkv6-3b B4 L2048 H40 M64 bf16": (device_time, lambda: _rwkv(4, 2048, rwkv3b.d_model // 64, 64, bf16)),
        "rwkv rwkv6-3b B1 L512 H40 M64 bf16": (device_time, lambda: _rwkv(1, 512, rwkv3b.d_model // 64, 64, bf16)),
        "rwkv rwkv6-3b B1 L16384 H40 M64 bf16": (device_time, lambda: _rwkv(
            1, 16384, rwkv3b.d_model // 64, 64, bf16)),
        # last: the profiler's hooks stay in the process for every later call
        "flash phase 8 B2 H4/2 S40 hd32 fp32, after a profiler session": (
            ("unheld", "host"), lambda: _flash(*p8_flash, profiled=True)),
    }


if __name__ == "__main__":
    sys.path.insert(0, str(ab.ROOT / "src"))
    sys.exit(ab.main(__file__, cases))
