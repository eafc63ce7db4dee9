#!/usr/bin/env python3
"""Time this checkout against another in turns, on one NVIDIA GPU, each side
in a process of its own.

A tool (``tools/attn_ab.py``, ``tools/mix_walk_ab.py``) defines ``cases()``:
a case's name -> ``(modes, build)``.  ``build()`` makes the case's inputs on
the card from a fixed seed, through the ``repro_torch`` package it finds
first on ``sys.path``, and returns ``(run, info)``: ``run()`` makes one call
through the package's own Python wrappers; ``info`` holds ``worst`` (the
largest error over its tolerance against the plain version: at most 1),
a free-text ``note`` and, under ``same``, digests of outputs that both sides
must give bit for bit.

``main`` starts one worker per side (this file run as a script), with that
side's ``src/`` first on ``sys.path``: each side builds its libraries from
its own sources with its own flags, routes by its own wrappers and counts
its own launches.  For each case the workers build it in turn, then the driver
asks for each mode's timings in turns (the other side, this one, this one,
the other, per pair):

- ``held``: CUDA events around one call, L2 flushed before it, the stream
  first held by a ~0.5 ms spin so that the whole call is queued before the
  start event fires: device time only.
- ``unheld``: the same without the hold: what a caller pays where the
  call's host time outlasts the flush before it.
- ``wall``: the host clock around one call and a synchronize.
- ``host``: the host clock around one call alone, the stream idle before
  it: what the caller's thread spends to launch it.

Each timing is the median of 7.  The script prints every time, each side's
median and their ratio, and the card's name and power limit; it exits 1 if a
case misses its tolerance on either side or the sides' ``same`` digests
differ.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPLY = "@ab "  # prefix of a worker's replies on its stdout; other lines are passed on


def digest(t) -> str:
    """A digest of a tensor's bytes, to compare outputs across processes."""
    return hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _load(tool: Path):
    spec = importlib.util.spec_from_file_location(tool.stem, tool)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _time(run, mode: str, flush, reps: int = 7) -> float:
    import torch

    from chip_smoke import host_ms, time_ms

    if mode == "host":
        return host_ms(run, reps=reps)
    if mode != "wall":
        return time_ms(run, reps=reps, flush=flush, hold=mode == "held")
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _worker(side_root: Path, tool: Path) -> None:
    """Serve one side: build its libraries, then answer requests, one JSON
    line each, from stdin."""
    sys.path[:0] = [str(side_root / "src"), str(ROOT)]  # the side's package; this checkout's chip_smoke
    import torch

    from repro_torch.kernels import build as kbuild

    kbuild.build()
    cases = _load(tool).cases()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    run = None
    for line in sys.stdin:
        req = json.loads(line)
        if req["op"] == "build":
            run = None
            torch.cuda.empty_cache()
            run, info = cases[req["case"]][1]()
            run()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()  # what the plain version held, for the other side's build
            reply = info
        else:
            reply = {"ms": _time(run, req["mode"], flush)}
        print(REPLY + json.dumps(reply), flush=True)


class _Side:
    def __init__(self, side_root: Path, tool: Path):
        self.proc = subprocess.Popen(
            [sys.executable, __file__, "--worker", str(side_root), str(tool)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, bufsize=1)

    def send(self, req: dict) -> None:
        self.proc.stdin.write(json.dumps(req) + "\n")
        self.proc.stdin.flush()

    def receive(self) -> dict:
        for line in self.proc.stdout:
            if line.startswith(REPLY):
                return json.loads(line[len(REPLY):])
            print("    | " + line, end="", file=sys.stderr)
        raise RuntimeError(f"a worker ended with code {self.proc.wait()}")

    def close(self) -> None:
        self.proc.stdin.close()
        self.proc.wait()


def main(tool: str, cases) -> int:
    """The command line of a tool; ``cases`` is its ``cases``."""
    ap = argparse.ArgumentParser(description=f"Time this checkout against another in turns: {Path(tool).name}")
    ap.add_argument("--other", required=True, type=Path, help="an unpacked checkout of another commit")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("-k", dest="only", default="", help="run the cases whose name holds this text")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print(f"{Path(tool).name}: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    sides = {"other": _Side(args.other.resolve(), Path(tool).resolve()), "this": _Side(ROOT, Path(tool).resolve())}
    ok = True
    try:
        for name, (modes, _) in cases().items():
            if args.only not in name:
                continue
            info = {}
            for s, side in sides.items():  # one side at a time: a plain version may take half the card
                side.send({"op": "build", "case": name})
                info[s] = side.receive()
            same = {key: info["this"].get("same", {})[key] == digest_other
                    for key, digest_other in info["other"].get("same", {}).items()}
            ok &= all(i["worst"] <= 1.0 for i in info.values()) and all(same.values())
            print(f"{name}: " + "; ".join(f"{s}{' ' + i['note'] if 'note' in i else ''} (worst err/tol "
                                          f"{i['worst']:.3f})" for s, i in info.items())
                  + "".join(f"; {key} bitwise equal across sides {eq}" for key, eq in same.items()), flush=True)
            for mode in modes:
                times = {s: [] for s in sides}
                for _ in range(args.pairs):
                    for s in ("other", "this", "this", "other"):
                        sides[s].send({"op": "time", "mode": mode})
                        times[s].append(sides[s].receive()["ms"])
                med = {s: statistics.median(t) for s, t in times.items()}
                print(f"  {mode}: " + "; ".join(f"{s} median {med[s]:.4f} ms (" + ", ".join(f"{x:.4f}" for x in t)
                                                 + ")" for s, t in times.items())
                      + f"; this / other {med['this'] / med['other']:.3f}", flush=True)
    finally:
        for side in sides.values():
            side.close()
    return 0 if ok else 1


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(Path(sys.argv[2]), Path(sys.argv[3]))
