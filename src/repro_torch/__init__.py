"""PyTorch + CUDA port of the decentralised federated learning system.

The layout mirrors ``src/repro/`` module for module (``core/``, ``data/``,
``models/``, ``optim/``, ``fed/``, ``gossip/``, ``kernels/mix/``, ``launch/``), so the
counterpart of every JAX module is found at the same path.  The port imports
torch and numpy only — never jax and nothing of the JAX package.

Device policy: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that explicit choice it raises
(``repro_torch.device.resolve_device``).  On a CUDA tensor the DecAvg
mixing wrappers launch the hand-written kernels of ``kernels/mix/csrc``; on
a CPU tensor they run the kernels' plain PyTorch versions.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
