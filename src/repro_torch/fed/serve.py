"""Offline serving of a decentralised model (counterpart of ``repro/fed/serve.py``).

Decentralised training's end product is an ensemble: every node holds its
own parameters, equal only up to the consensus noise floor.  This module
serves it two ways:

* ``consensus_params`` averages the ensemble into one parameter set and
  ``generate`` / ``ServeEngine.generate`` answer a batch from it: one
  batched prefill (``prefill_cache``: on the card every attention layer is
  one flash kernel launch and every RWKV layer one rwkv kernel launch) and
  then a decode loop, one token per step;
* ``ServeEngine.serve`` answers each query from the node it is assigned to,
  reading that node's parameters as views of the ensemble.

The cache is the decoder's: KV caches of ``cache_len`` slots for attention
layers, an O(1) token-shift and wkv state for RWKV layers, which ignore
``cache_len``, as in the JAX package.  Greedy decoding emits the JAX
package's tokens on the same parameters.
Temperature sampling draws Gumbel noise from a ``torch.Generator`` (one
(B, V) draw per sampled token), so a run is reproducible for a given
generator but does not reproduce JAX's threefry draws.  Live serving
(``run_serve_trajectory``, the router) needs the event executor and is not
ported yet.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.flat import tree_map
from repro_torch.models import transformer as tf

Tree = dict[str, Any]

__all__ = [
    "ServeEngine",
    "consensus_params",
    "decode_one",
    "generate",
    "generate_tokenwise",
    "prefill",
]

_CHUNK = 1 << 26  # elements averaged at a time: bounds the fp32 transient to 256 MB


@torch.no_grad()
def consensus_params(node_params: Tree, weights: torch.Tensor | np.ndarray | None = None) -> Tree:
    """Average the node ensemble (every leaf (n, ...)) into one parameter set.

    Leaf by leaf and chunk by chunk in fp32, each result in its leaf's
    dtype: no fp32 copy of the ensemble, or of one whole leaf, is built.
    ``weights`` (n,) are normalised to sum to one; None is the plain mean.
    """
    w = None if weights is None else np.asarray(torch.as_tensor(weights).cpu(), np.float64)
    if w is not None:
        w = (w / w.sum()).astype(np.float32)

    def avg(leaf: torch.Tensor) -> torch.Tensor:
        n = leaf.shape[0]
        flat = leaf.reshape(n, -1)
        out = torch.empty(flat.shape[1], dtype=leaf.dtype, device=leaf.device)
        for c0 in range(0, flat.shape[1], _CHUNK):
            part = flat[:, c0 : c0 + _CHUNK]
            if w is None:
                acc = part[0].to(torch.float32, copy=True)  # never an alias of the ensemble
                for i in range(1, n):
                    acc += part[i].float()
                acc /= n
            else:
                acc = part[0].float() * float(w[0])
                for i in range(1, n):
                    acc += part[i].float() * float(w[i])
            out[c0 : c0 + _CHUNK] = acc.to(leaf.dtype)
        return out.reshape(leaf.shape[1:])

    return tree_map(avg, node_params)


@torch.no_grad()
def prefill(params: Tree, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward → next-token logits of the LAST position only
    ((..., V)); the full logits never materialise (vocab can be 262k)."""
    hidden, _ = tf.forward(params, cfg, tokens)
    return tf.hidden_to_logits(params, cfg, hidden[..., -1:, :])[..., 0, :]


def decode_one(params: Tree, cfg: ArchConfig, cache: Tree, tokens: torch.Tensor, pos: int):
    """ONE new token against the cache: tokens (B, 1) at absolute ``pos``."""
    return tf.decode_step(params, cfg, cache, tokens, pos)


def _sample(logits: torch.Tensor, temperature: float, generator: torch.Generator | None) -> torch.Tensor:
    if temperature > 0:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        return torch.argmax(logits.float() / temperature - torch.log(-torch.log(u)), dim=-1)
    return torch.argmax(logits, dim=-1)


def _setup(prompt, temperature: float, generator, device):
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return prompt, generator


@torch.no_grad()
def generate(
    params: Tree,
    cfg: ArchConfig,
    prompt,
    n_new: int,
    cache_len: int,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    *,
    device=None,
) -> torch.Tensor:
    """Greedy / temperature sampling: one batched prefill, then ``n_new - 1``
    decode steps.  prompt (..., S) → new tokens (..., n_new) in prompt's dtype."""
    prompt, generator = _setup(prompt, temperature, generator, device)
    s = prompt.shape[-1]
    logits, cache = tf.prefill_cache(params, cfg, prompt, cache_len)
    tok = _sample(logits, temperature, generator).to(prompt.dtype)
    out = [tok]
    for i in range(int(n_new) - 1):
        logits, cache = tf.decode_step(params, cfg, cache, tok[..., None], s + i)
        tok = _sample(logits[..., -1, :], temperature, generator).to(prompt.dtype)
        out.append(tok)
    return torch.stack(out, dim=-1)


@torch.no_grad()
def generate_tokenwise(
    params: Tree,
    cfg: ArchConfig,
    prompt,
    n_new: int,
    cache_len: int,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    *,
    device=None,
) -> torch.Tensor:
    """Reference decode loop: the prompt (B, S) is consumed one token at a
    time, the parity baseline for ``generate``'s prefill path."""
    prompt, generator = _setup(prompt, temperature, generator, device)
    cache = tf.init_cache(cfg, (prompt.shape[0],), cache_len, device=prompt.device)
    for t in range(prompt.shape[1] - 1):
        _, cache = tf.decode_step(params, cfg, cache, prompt[:, t : t + 1], t)
    pos = prompt.shape[1] - 1
    tok = prompt[:, -1:]
    out = []
    for _ in range(int(n_new)):
        logits, cache = tf.decode_step(params, cfg, cache, tok, pos)
        pos += 1
        tok = _sample(logits[:, -1], temperature, generator).to(prompt.dtype)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


class ServeEngine:
    """Batched prefill → decode engine over one parameter set or a
    node-stacked ensemble, on ``device`` (default ``cuda``).

    ``generate`` serves a batch against ONE parameter set (e.g. the
    consensus); ``serve`` answers each query with its assigned node's
    parameters (views of the ensemble, never a gathered copy), one
    ``generate`` per query.
    """

    def __init__(self, cfg: ArchConfig, cache_len: int, temperature: float = 0.0, *, device=None):
        self.cfg = cfg
        self.cache_len = int(cache_len)
        self.temperature = float(temperature)
        self.device = resolve_device(device)

    def generate(self, params: Tree, prompt, n_new: int, generator: torch.Generator | None = None) -> torch.Tensor:
        return generate(
            params, self.cfg, prompt, n_new, self.cache_len, self.temperature, generator, device=self.device
        )

    def serve(
        self, node_params: Tree, assignments, prompts, n_new: int, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """prompts (B, S) answered by the nodes in ``assignments`` (B,) → (B, n_new)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        nodes = [int(a) for a in np.asarray(torch.as_tensor(assignments).cpu())]
        if len(nodes) != prompts.shape[0]:
            raise ValueError(f"{len(nodes)} assignments for {prompts.shape[0]} prompts")
        out = []
        for i, node in enumerate(nodes):
            params = tree_map(lambda leaf: leaf[node], node_params)
            out.append(self.generate(params, prompts[i : i + 1], n_new, generator)[0])
        return torch.stack(out)
