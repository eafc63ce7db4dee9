"""qwen2.5-3b [dense]: 36L, d_model 2048, 16H GQA(kv=2), d_ff 11008,
vocab 151936, QKV bias.  Source: [hf:Qwen/Qwen2.5-0.5B family card,
scaled per assignment].
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    norm="rmsnorm",
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    max_seq_len=32768,
    notes="long_500k: native attention is quadratic-state → skipped at "
    "native config; a beyond-paper SWA-variant demo is recorded separately "
    "(see swa_variant()).",
)


def swa_variant(window: int = 8192) -> ArchConfig:
    """Beyond-paper sliding-window override enabling long_500k decode."""
    return dataclasses.replace(
        CONFIG,
        name="qwen2.5-3b-swa",
        block_pattern=("swa",),
        sliding_window=window,
        max_seq_len=524288,
        notes="demonstration variant: all layers sliding-window",
    )


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_seq_len=256,
        dtype="float32",
    )
