"""The paper's own architectures, Appendix A (counterpart of ``repro/models/paper_models.py``).

* MLP    — 4 fully-connected layers (512, 256, 128 hidden; 10 out), ReLU.
* CNN    — 3 conv layers (32/64/64 ch, 3×3, pad 1, each followed by a 2×2
           max-pool) + FC 128, 64, out.
* VGG16  — Simonyan & Zisserman cfg-D, with a width multiplier for
           CPU-tractable runs (``width_mult=1.0``, the default, is full width).

Every weight is drawn by the gain-corrected He initialiser.  Parameters keep
the JAX package's layout — dense ``w`` ``(in, out)``, conv ``w`` HWIO
``(kh, kw, cin, cout)``, ``b`` ``(out,)`` — and may carry a leading node
axis, so the flat buffer, ``convert.py`` and the codecs' chunk tables are the
JAX package's.  Images are NHWC, as there.

The node-stacked forward runs every node in one call per layer: a dense
layer is one batched matrix product, a conv one grouped convolution
(``groups=n``) over the nodes' channels side by side, ``(B, n·C, H, W)`` in
channels-last memory — what XLA makes of the JAX package's ``vmap``.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.initialisation import InitConfig, scaled_init

Tree = dict[str, Any]

__all__ = [
    "init_mlp",
    "mlp_forward",
    "init_cnn",
    "cnn_forward",
    "init_vgg16",
    "vgg16_forward",
    "classifier_loss",
    "accuracy",
]


def _lead(init_cfg: InitConfig) -> tuple[int, ...]:
    """The node axis an ``(n,)`` per-node gain tensor prepends to every leaf."""
    gain = init_cfg.gain
    return (gain.shape[0],) if isinstance(gain, torch.Tensor) and gain.ndim == 1 else ()


def _dense_init(init_cfg: InitConfig, generator: torch.Generator, d_in: int, d_out: int) -> Tree:
    return {
        "w": scaled_init(init_cfg, generator, (d_in, d_out)),
        "b": torch.zeros(*_lead(init_cfg), d_out, device=generator.device),
    }


# ----------------------------------------------------------------- MLP
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
    return {f"fc{i}": _dense_init(init_cfg, generator, dims[i], dims[i + 1]) for i in range(len(dims) - 1)}


def _dense_stack(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """``fc0``, ``fc1``, ... in index order, ReLU between them."""
    i = 0
    while f"fc{i}" in params:
        p = params[f"fc{i}"]
        x = torch.matmul(x, p["w"]) + p["b"].unsqueeze(-2)
        if f"fc{i + 1}" in params:
            x = torch.relu(x)
        i += 1
    return x


def mlp_forward(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """x (..., H, W, C) or (..., D) → logits (..., n_classes).

    With node-stacked params (``w`` (n, in, out)) x is either per node
    (n, B, ...) or shared by all nodes (B, ...); both give (n, B, n_classes).
    """
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
    return _dense_stack(params, x)


# ----------------------------------------------------------------- conv nets
def _conv_init(init_cfg: InitConfig, generator: torch.Generator, kh: int, kw: int, cin: int, cout: int) -> Tree:
    return {
        "w": scaled_init(init_cfg, generator, (kh, kw, cin, cout)),
        "b": torch.zeros(*_lead(init_cfg), cout, device=generator.device),
    }


def _to_groups(x: torch.Tensor, n: int) -> torch.Tensor:
    """NHWC images → the grouped layout (B, n·C, H, W), channels-last in
    memory: node i's channels at i·C.  x is (n, B, H, W, C), one batch a
    node, or (B, H, W, C), shared by every node."""
    if x.ndim == 5:
        if x.shape[0] != n:
            raise ValueError(f"per-node batch of {x.shape[0]} nodes for {n} nodes' parameters")
        x = x.permute(1, 2, 3, 0, 4)  # (B, H, W, n, C)
    elif x.ndim == 4:
        x = x.unsqueeze(3).expand(*x.shape[:3], n, x.shape[3])
    else:
        raise ValueError(f"expected NHWC images, got shape {tuple(x.shape)}")
    b, h, w = x.shape[:3]
    return x.reshape(b, h, w, -1).permute(0, 3, 1, 2)


def _conv(p: Tree, x: torch.Tensor, n: int) -> torch.Tensor:
    """3×3 'SAME' conv of every node at once: x (B, n·cin, H, W) → (B,
    n·cout, H, W); the HWIO weights (n, kh, kw, cin, cout) become one
    grouped OIHW weight (n·cout, cin, kh, kw), copied into channels-last
    memory as the activations are."""
    w, b = p["w"].reshape(n, *p["w"].shape[-4:]), p["b"].reshape(-1)
    kh, kw, cin, cout = w.shape[1:]
    w = w.permute(0, 4, 1, 2, 3).reshape(n * cout, kh, kw, cin).permute(0, 3, 1, 2)
    return F.conv2d(x, w, b, padding=(kh // 2, kw // 2), groups=n)


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def _flatten(x: torch.Tensor, n: int, stacked: bool) -> torch.Tensor:
    """(B, n·C, h, w) → per node (n, B, h·w·C) in NHWC order, the JAX
    package's ``reshape(B, -1)`` of each node's (B, h, w, C) map; (B, h·w·C)
    for one unstacked parameter set."""
    b, nc, h, w = x.shape
    x = x.reshape(b, n, nc // n, h, w).permute(1, 0, 3, 4, 2).reshape(n, b, h * w * (nc // n))
    return x if stacked else x[0]


def _node_count(params: Tree) -> tuple[int, bool]:
    """(nodes, node-stacked?) from the first conv weight (rank 5 stacked)."""
    w = params["conv0"]["w"]
    return (w.shape[0], True) if w.ndim == 5 else (1, False)


def init_cnn(
    init_cfg: InitConfig,
    generator: torch.Generator,
    image_shape: tuple[int, int, int] = (32, 32, 10),
    channels: Sequence[int] = (32, 64, 64),
    fc_hidden: Sequence[int] = (128, 64),
    n_classes: int = 17,
) -> Tree:
    """Paper cfg. B's CNN (node-stacked with a per-node gain tensor, as ``init_mlp``)."""
    h, w, c_prev = image_shape
    params: Tree = {}
    for i, c in enumerate(channels):
        params[f"conv{i}"] = _conv_init(init_cfg, generator, 3, 3, c_prev, c)
        c_prev = c
        h, w = h // 2, w // 2  # one maxpool per conv
    dims = [h * w * c_prev, *fc_hidden, n_classes]
    for i in range(len(dims) - 1):
        params[f"fc{i}"] = _dense_init(init_cfg, generator, dims[i], dims[i + 1])
    return params


def cnn_forward(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) → logits (B, n_classes); node-stacked params take x
    per node (n, B, H, W, C) or shared (B, H, W, C) and give (n, B, n_classes)."""
    n, stacked = _node_count(params)
    x = _to_groups(x, n)
    i = 0
    while f"conv{i}" in params:
        x = _maxpool2(torch.relu(_conv(params[f"conv{i}"], x, n)))
        i += 1
    return _dense_stack(params, _flatten(x, n, stacked))


_VGG_D = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M")


def init_vgg16(
    init_cfg: InitConfig,
    generator: torch.Generator,
    image_shape: tuple[int, int, int] = (32, 32, 3),
    n_classes: int = 10,
    width_mult: float = 1.0,
    fc_dim: int = 4096,
) -> Tree:
    """Paper cfg. C's VGG16 (cfg-D); ``width_mult`` scales every width."""
    h, w, c_prev = image_shape
    params: Tree = {}
    conv_i = 0
    for entry in _VGG_D:
        if entry == "M":
            h, w = h // 2, w // 2
            continue
        c = max(8, int(entry * width_mult))
        params[f"conv{conv_i}"] = _conv_init(init_cfg, generator, 3, 3, c_prev, c)
        c_prev = c
        conv_i += 1
    fdim = max(16, int(fc_dim * width_mult))
    dims = [h * w * c_prev, fdim, fdim, n_classes]
    for i in range(3):
        params[f"fc{i}"] = _dense_init(init_cfg, generator, dims[i], dims[i + 1])
    return params


def vgg16_forward(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """As ``cnn_forward``, through cfg-D's 13 convs and 5 pools."""
    n, stacked = _node_count(params)
    x = _to_groups(x, n)
    conv_i = 0
    for entry in _VGG_D:
        if entry == "M":
            x = _maxpool2(x)
            continue
        x = torch.relu(_conv(params[f"conv{conv_i}"], x, n))
        conv_i += 1
    return _dense_stack(params, _flatten(x, n, stacked))


# ----------------------------------------------------------------- losses
def classifier_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch axis (logits (..., B, C),
    labels broadcastable to (..., B)): a scalar for one node's batch, an
    (n,) vector of per-node losses for a node-stacked batch.  fp32 log-softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    idx = labels.long().expand(logits.shape[:-1]).unsqueeze(-1)
    return -torch.gather(logp, -1, idx).squeeze(-1).mean(-1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean(-1)
