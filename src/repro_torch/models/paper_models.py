"""The paper's MLP (counterpart of ``repro/models/paper_models.py``).

MLP — 4 fully-connected layers (512, 256, 128 hidden; 10 out), ReLU, with
every weight drawn by the gain-corrected He initialiser.  Parameters keep
the JAX package's layout (``w`` is ``(in, out)``) and may carry a leading
node axis: the node-stacked forward is one batched matrix product per layer.
The CNN and VGG16 are not ported yet.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.core.initialisation import InitConfig, scaled_init

Tree = dict[str, Any]

__all__ = ["init_mlp", "mlp_forward", "classifier_loss", "accuracy"]


def init_mlp(
    init_cfg: InitConfig,
    generator: torch.Generator,
    in_dim: int = 784,
    hidden: Sequence[int] = (512, 256, 128),
    n_classes: int = 10,
) -> Tree:
    """One MLP on ``generator``'s device; with an ``(n,)`` per-node gain
    tensor in ``init_cfg`` a node-stacked ensemble of n independent draws."""
    dims = [in_dim, *hidden, n_classes]
    gain = init_cfg.gain
    lead = (gain.shape[0],) if isinstance(gain, torch.Tensor) and gain.ndim == 1 else ()
    return {
        f"fc{i}": {
            "w": scaled_init(init_cfg, generator, (dims[i], dims[i + 1])),
            "b": torch.zeros(*lead, dims[i + 1], device=generator.device),
        }
        for i in range(len(dims) - 1)
    }


def mlp_forward(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """x (..., H, W, C) or (..., D) → logits (..., n_classes).

    With node-stacked params (``w`` (n, in, out)) x is either per node
    (n, B, ...) or shared by all nodes (B, ...); both give (n, B, n_classes).
    """
    n_layers = len(params)
    d_in = params["fc0"]["w"].shape[-2]
    # merge however many trailing axes multiply to d_in (image → flat vector)
    if x.shape[-1] != d_in:
        k, prod = x.ndim, 1
        while prod < d_in and k > 0:
            k -= 1
            prod *= x.shape[k]
        if prod != d_in:
            raise ValueError(f"cannot flatten {tuple(x.shape)} to feature dim {d_in}")
        x = x.reshape(*x.shape[:k], d_in)
    for i in range(n_layers):
        p = params[f"fc{i}"]
        x = torch.matmul(x, p["w"]) + p["b"].unsqueeze(-2)
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def classifier_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch axis (logits (..., B, C),
    labels broadcastable to (..., B)): a scalar for one node's batch, an
    (n,) vector of per-node losses for a node-stacked batch.  fp32 log-softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    idx = labels.long().expand(logits.shape[:-1]).unsqueeze(-1)
    return -torch.gather(logp, -1, idx).squeeze(-1).mean(-1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean(-1)
