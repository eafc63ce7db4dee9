"""granite-moe-1b-a400m [moe]: 24L, d_model 1024, 16H GQA(kv=8), expert
d_ff 512, vocab 49155, MoE 32 experts top-8 at every layer.
Source: [hf:ibm-granite/granite-3.0-1b-a400m-base].
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,  # per-expert hidden dim
    vocab_size=49155,
    n_experts=32,
    experts_per_token=8,
    moe_period=1,
    norm="rmsnorm",
    mlp_type="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    max_seq_len=4096,
    notes="vocab 49155 is not divisible by the 16-way model axis → the "
    "embedding shards on d_model instead (launch/shardings.py).",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        vocab_size=512,
        n_experts=4,
        experts_per_token=2,
        max_seq_len=256,
        dtype="float32",
    )
