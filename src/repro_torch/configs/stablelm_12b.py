"""stablelm-12b [dense]: 40L, d_model 5120, 32H GQA(kv=8), d_ff 13824,
vocab 100352.  Source: [hf:stabilityai/stablelm-2-1_6b family card,
scaled per assignment].
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    norm="layernorm",  # stablelm-2 uses LayerNorm (no bias on qkv)
    mlp_type="swiglu",
    rope_theta=10000.0,
    max_seq_len=4096,
    notes="long_500k skipped (full attention, no sub-quadratic variant).",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=160,
        n_heads=4,
        n_kv_heads=2,
        head_dim=40,
        d_ff=320,
        vocab_size=512,
        max_seq_len=256,
        dtype="float32",
    )
