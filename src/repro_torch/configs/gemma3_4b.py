"""gemma3-4b [dense]: 34L, d_model 2560, 8H GQA(kv=4), d_ff 10240,
vocab 262144, 5:1 local(1024-window):global attention, 128k context.
Source: [hf:google/gemma-3-1b-pt family card, scaled per assignment].
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,  # gemma3 fixed head_dim (not d_model // n_heads)
    d_ff=10240,
    vocab_size=262144,
    block_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),  # 5:1 local:global
    sliding_window=1024,
    norm="rmsnorm",
    mlp_type="geglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    max_seq_len=131072,
    notes="34 = 5 full (swa×5+attn) units + 4 tail layers; long_500k runs "
    "natively: swa layers keep a ring-buffer window cache, global layers a full cache.",
)


def reduced() -> ArchConfig:
    """Smoke variant: same family (5:1 swa:attn, GQA, GeGLU, tied embed)."""
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=("swa", "attn"),
        sliding_window=16,
        max_seq_len=256,
        dtype="float32",
    )
