"""qwen1.5-4b [dense]: 40L, d_model 2560, 20H MHA(kv=20), d_ff 6912,
vocab 151936, QKV bias.  Source: [hf:Qwen/Qwen1.5-0.5B family card,
scaled per assignment].
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    norm="rmsnorm",
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    max_seq_len=32768,
    notes="20 heads do not divide the 16-way model axis → attention "
    "shards on head_dim instead (launch/shardings.py). long_500k skipped "
    "(full attention).",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=120,
        n_heads=4,
        n_kv_heads=4,
        head_dim=30,
        d_ff=256,
        vocab_size=512,
        max_seq_len=256,
        dtype="float32",
    )
