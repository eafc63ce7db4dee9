"""musicgen-large [audio]: decoder-only transformer over EnCodec tokens —
48L, d_model 2048, 32H (MHA, kv=32), d_ff 8192, vocab 2048 (EnCodec
codebook).  Source: [arXiv:2306.05284].

Frontend stub (DESIGN.md §5): the EnCodec conv codec + T5 text conditioner
are NOT implemented; ``input_specs`` supplies (batch, n_cond, 1024)
precomputed conditioning embeddings prepended to the token stream; the
modelled stream is one codebook (the delay-pattern interleave collapses to
a flat stream for shape purposes).
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    source="arXiv:2306.05284",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    norm="layernorm",
    mlp_type="gelu_mlp",
    rope_theta=10000.0,
    max_seq_len=32768,
    frontend="audio",
    n_frontend_tokens=256,  # conditioning embeddings (T5-large width)
    frontend_embed_dim=1024,
    notes="long_500k skipped (full attention). Decode shapes model "
    "autoregressive EnCodec-token generation.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=256,
        max_seq_len=256,
        n_frontend_tokens=8,
        frontend_embed_dim=32,
        dtype="float32",
    )
