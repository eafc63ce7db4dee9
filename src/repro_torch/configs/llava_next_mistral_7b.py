"""llava-next-mistral-7b [vlm]: Mistral-7B text backbone — 32L, d_model
4096, 32H GQA(kv=8), d_ff 14336, vocab 32000 — consuming anyres-tiled
vision patch embeddings through a learned projector.
Source: [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Frontend stub (DESIGN.md §5): the CLIP-ViT-L/14-336 encoder is NOT
implemented; ``input_specs`` supplies (batch, n_patches, 1024) precomputed
patch embeddings (anyres: base 576 + 4 tiles × 576 = 2880 tokens).
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    norm="rmsnorm",
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    max_seq_len=32768,
    frontend="vision",
    n_frontend_tokens=2880,  # anyres: 576 base + 4×576 tiles
    frontend_embed_dim=1024,  # CLIP-ViT-L/14 hidden size
    notes="text tokens per shape = seq_len - 2880; long_500k skipped "
    "(full attention).",
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
        n_frontend_tokens=8,
        frontend_embed_dim=32,
        dtype="float32",
    )
