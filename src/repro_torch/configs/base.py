"""Architecture configuration schema and registry (counterpart of ``repro/configs/base.py``).

``ArchConfig`` is a copy of the JAX package's dataclass, field for field, so
one configuration module reads the same in both packages; ``param_dtype``
returns a torch dtype.  The registry resolves the JAX package's ten zoo
architectures, and the paper's three classifiers (``paper_mlp``,
``paper_cnn``, ``paper_vgg16``); ``list_archs(include_paper=True)`` names
them too.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

import torch

__all__ = [
    "ArchConfig",
    "ffn_kinds",
    "get_config",
    "get_reduced_config",
    "layer_kinds",
    "list_archs",
]

Family = Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio", "paper"]

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    source: str  # citation: hf model card or arXiv id

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0  # 0 => attention-free
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 => derive d_model // n_heads
    qkv_bias: bool = False

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1  # layer j is MoE iff (j % moe_period == moe_offset) and n_experts > 0
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # --- layer pattern ---
    block_pattern: tuple[str, ...] = ("attn",)  # cycled over layers: attn|swa|mamba|rwkv
    sliding_window: int = 0  # window size for "swa" blocks

    # --- misc structure ---
    norm: str = "rmsnorm"
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu_mlp
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    max_seq_len: int = 131072

    # --- ssm ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_dim: int = 64

    # --- modality frontend stub ---
    frontend: str = ""  # "" | "vision" | "audio"
    n_frontend_tokens: int = 0
    frontend_embed_dim: int = 0

    dtype: str = "bfloat16"
    notes: str = ""
    # knobs of the JAX package's XLA lowering (roofline unrolling, chunked /
    # banded attention); kept so configurations read alike, unused here:
    # a full-sequence attention goes through the flash kernel, or through
    # the plain masked softmax when autograd records it (training), and a
    # full-sequence RWKV time-mix through the rwkv kernel
    unroll_scans: bool = False
    attn_impl: str = "full"
    swa_impl: str = "full"
    attn_weight_sharding: str = "auto"

    @property
    def resolved_head_dim(self) -> int:
        if self.n_heads == 0:
            return 0
        return self.head_dim or self.d_model // self.n_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once if tied; the
        final norm is not counted, as in the JAX package)."""
        d, f = self.d_model, self.d_ff
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        hd = self.resolved_head_dim
        for kind, fk in zip(layer_kinds(self), ffn_kinds(self)):
            if kind in ("attn", "swa"):
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
                if self.qkv_bias:
                    total += hd * (self.n_heads + 2 * self.n_kv_heads)
            elif kind == "mamba":
                di = self.mamba_expand * d
                total += (
                    d * 2 * di + di * self.mamba_d_conv + di * (2 * self.mamba_d_state + 1)
                    + di * self.mamba_d_state + di + di * d
                )
            elif kind == "rwkv":
                total += 4 * d * d + d * d  # r,k,v,g,o projections
                total += d * (self.d_ff + 1) + self.d_ff * d  # channel mix
            if kind != "rwkv":  # rwkv folds its FFN into channel-mix above
                n_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
                if fk == "moe":
                    total += d * self.n_experts + self.n_experts * n_mats * d * f
                else:
                    total += n_mats * d * f
            total += 2 * d  # norms
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE counts top-k experts only)."""
        if not self.is_moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        n_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        inactive = 0
        for fk in ffn_kinds(self):
            if fk == "moe":
                inactive += (self.n_experts - self.experts_per_token) * n_mats * d * f
        return self.n_params() - inactive


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Block kind per layer: the pattern is cycled (gemma3 5 swa : 1 attn)."""
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def ffn_kinds(cfg: ArchConfig) -> list[str]:
    """FFN kind per layer: "moe" or "dense" ("none" for rwkv blocks, which
    carry their own channel-mix)."""
    out = []
    for j, kind in enumerate(layer_kinds(cfg)):
        if kind == "rwkv":
            out.append("none")
        elif cfg.is_moe and (j % cfg.moe_period == cfg.moe_offset):
            out.append("moe")
        else:
            out.append("dense")
    return out


# ----------------------------------------------------------------------
_ZOO = [  # the JAX package's order
    "gemma3_4b", "granite_moe_1b_a400m", "jamba_1p5_large_398b", "qwen2p5_3b", "llava_next_mistral_7b",
    "stablelm_12b", "musicgen_large", "qwen1p5_4b", "rwkv6_3b", "llama4_scout_17b_a16e",
]
_PAPER = ["paper_mlp", "paper_cnn", "paper_vgg16"]

_ALIASES = {
    "gemma3-4b": "gemma3_4b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "qwen2.5-3b": "qwen2p5_3b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "stablelm-12b": "stablelm_12b",
    "musicgen-large": "musicgen_large",
    "qwen1.5-4b": "qwen1p5_4b",
    "rwkv6-3b": "rwkv6_3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
}


def _module(arch: str):
    mod = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if mod not in _ZOO and mod not in _PAPER:
        raise ValueError(f"unknown arch {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ArchConfig:
    return _module(arch).reduced()


def list_archs(include_paper: bool = False) -> list[str]:
    """The ten zoo architectures (and the paper's, if asked)."""
    return list(_ZOO) + (list(_PAPER) if include_paper else [])
