"""jamba-1.5-large-398b [hybrid]: 72L, d_model 8192, 64H GQA(kv=8),
d_ff 24576, vocab 65536; Mamba:attention 7:1 interleave; MoE 16 experts
top-2 at every other layer.  Source: [arXiv:2403.19887].
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_period=2,
    moe_offset=1,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    norm="rmsnorm",
    mlp_type="swiglu",
    rope_theta=10000.0,
    max_seq_len=262144,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    notes="unit = 8 layers (1 attn + 7 mamba, 4 MoE); 72 = 9 units. "
    "long_500k runs natively: mamba layers carry O(1) state; the 9 attn "
    "layers keep full KV caches (9×500k×8×128).",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        n_experts=4,
        experts_per_token=2,
        moe_period=2,
        moe_offset=1,
        block_pattern=("attn", "mamba"),
        max_seq_len=256,
        mamba_d_state=8,
        dtype="float32",
    )
