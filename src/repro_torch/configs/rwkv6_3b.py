"""rwkv6-3b "Finch" [ssm]: 32L, d_model 2560, attention-free (RWKV-6
time-mix with data-dependent decay), channel-mix d_ff 8960, vocab 65536.
Source: [arXiv:2404.05892].
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    source="arXiv:2404.05892",
    n_layers=32,
    d_model=2560,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv",),
    norm="layernorm",
    rwkv_head_dim=64,  # 40 heads of 64
    max_seq_len=524288,
    notes="long_500k runs natively: O(1) recurrent state (H×64×64 per "
    "layer), no KV cache.",
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=128,
        d_ff=256,
        vocab_size=512,
        rwkv_head_dim=32,
        max_seq_len=256,
        dtype="float32",
    )
