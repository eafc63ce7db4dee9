"""Optimizers of the port."""
from .optimizers import AdamWState, Optimizer, SgdState, adamw, sgd

__all__ = ["AdamWState", "Optimizer", "SgdState", "adamw", "sgd"]
