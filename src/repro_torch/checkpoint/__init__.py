"""Durable step-directory checkpoints (counterpart of ``repro/checkpoint``)."""
from .io import load_pytree, restore_train_state, save_pytree, save_train_state

__all__ = ["save_pytree", "load_pytree", "save_train_state", "restore_train_state"]
