"""Architecture configurations the port runs (counterpart of ``repro/configs``)."""
from .base import ArchConfig, ffn_kinds, get_config, get_reduced_config, layer_kinds, list_archs

__all__ = ["ArchConfig", "ffn_kinds", "get_config", "get_reduced_config", "layer_kinds", "list_archs"]
