"""llama4-scout-17b-a16e [moe]: 48L, d_model 5120, 40H GQA(kv=8),
expert d_ff 8192, vocab 202048, MoE 16 experts top-1, early-fusion
multimodal.  Source: [hf:meta-llama/Llama-4-Scout-17B-16E].

Early fusion: the arch supports a vision frontend (projector initialised)
but the assigned input shapes are text-token streams, so
``n_frontend_tokens = 0`` in the specs (DESIGN.md §5).
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    experts_per_token=1,
    moe_period=1,
    norm="rmsnorm",
    mlp_type="swiglu",
    rope_theta=500_000.0,
    max_seq_len=262144,
    frontend="vision",
    n_frontend_tokens=0,  # early-fusion capable; assigned shapes are text
    frontend_embed_dim=1408,
    notes="40 heads do not divide the 16-way model axis → attention "
    "shards on head_dim (launch/shardings.py). long_500k skipped (full "
    "attention at native config).",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        n_experts=4,
        experts_per_token=1,
        max_seq_len=256,
        n_frontend_tokens=0,
        frontend_embed_dim=32,
        dtype="float32",
    )
