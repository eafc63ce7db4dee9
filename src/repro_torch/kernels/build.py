"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each library is one ``.cu`` source (plus the ``.cuh`` headers beside it)
with a plain C interface, compiled for Hopper (``sm_90a``) into
``<repo>/build/kernels/lib<name>-<hash>.so`` at first use.  The hash covers
the sources, the headers and the flags, so an edited source never loads a
stale library.  ``build()`` starts one nvcc per library, all at once, and
waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "LIBRARIES", "build", "build_log", "load_library", "sass"]

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
LIBRARIES = {
    "mix": KERNELS_DIR / "mix" / "csrc" / "mix.cu",
    "mix_bsr": KERNELS_DIR / "mix" / "csrc" / "mix_bsr.cu",
    "mix_hyb": KERNELS_DIR / "mix" / "csrc" / "mix_hyb.cu",
    "quant_mix": KERNELS_DIR / "mix" / "csrc" / "quant_mix.cu",
    "flash_sm90": KERNELS_DIR / "flash" / "csrc" / "flash_sm90.cu",
    "rwkv_sm90": KERNELS_DIR / "rwkv" / "csrc" / "rwkv_sm90.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _tool(name: str) -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _target(name: str) -> Path:
    src = LIBRARIES[name]
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas register / spill report) for the current sources."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=tuple(LIBRARIES)) -> list[str]:
    """Compile every named library that is not built yet, in parallel.
    Returns the names it compiled; raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        log = target.with_suffix(".log")
        cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(LIBRARIES[name])]
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, target, log))
    failed = []
    for name, proc, tmp, target, log in jobs:
        if proc.wait() == 0:
            os.replace(tmp, target)
        else:
            failed.append(f"--- {name} ---\n{log.read_text()}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [j[0] for j in jobs]


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library: the machine code that runs."""
    build([name])
    return subprocess.run([_tool("cuobjdump"), "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True).stdout


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(_target(name)))
    return _loaded[name]
