"""The paper's client model: a compact CNN classifier on NHWC images.

Every forward here is batched over a leading client axis: params are a
tree of ``(N, ...)`` leaves (views into a flat ``(N, P)`` buffer, see
:mod:`repro_torch.utils.bridge`) and images ``(N, B, H, W, C)``, or
``(1, B, H, W, C)`` to feed the same batch to every client. This stands in
for the reference's ``vmap`` over per-client weights. Single-client
functions lift their params to ``N = 1``.

The layout is the reference's: HWIO convs, ``(in, out)`` fc weights, NHWC
activations and an NHWC flatten before ``fc1``, so weights cross between
the packages with no transposes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.device import resolve_device
from repro_torch.utils.bridge import ParamLayout

Tree = Any


def param_layout(cfg: CNNConfig) -> ParamLayout:
    """Leaf shapes of one client's params, in the reference's leaf order."""
    blocks, c_in = [], cfg.channels
    for w in cfg.widths:
        blocks.append({"conv": (3, 3, c_in, w), "bias": (w,)})
        c_in = w
    feat = cfg.image_size // (2 ** len(cfg.widths))
    flat = feat * feat * cfg.widths[-1]
    spec = {"blocks": blocks,
            "fc1": {"w": (flat, cfg.hidden), "b": (cfg.hidden,)},
            "fc2": {"w": (cfg.hidden, cfg.n_classes), "b": (cfg.n_classes,)}}
    return ParamLayout.from_shapes(spec)


def matmul_shapes(cfg: CNNConfig) -> List[Tuple[int, int, int]]:
    """(rows a sample, k, n) of each matmul of one forward, in order: a
    3×3 SAME conv at side s is (s², 9·C_in, C_out) (the contraction form
    of :func:`_conv2d_same`), then ``fc1`` and ``fc2`` at one row."""
    shapes, c_in, side = [], cfg.channels, cfg.image_size
    for w in cfg.widths:
        shapes.append((side * side, 9 * c_in, w))
        c_in, side = w, side // 2
    shapes.append((1, side * side * c_in, cfg.hidden))
    shapes.append((1, cfg.hidden, cfg.n_classes))
    return shapes


def init_params(cfg: CNNConfig, generator: torch.Generator,
                n_clients: int = 1, *,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Fresh ``(n_clients, P)`` params: weights ~ N(0, 1/fan_in), biases 0
    (the reference's scheme; ``torch.Generator`` bits differ from
    ``jax.random``'s, so parity tests carry weights across instead)."""
    dev = resolve_device(device)
    layout = param_layout(cfg)
    flat = torch.zeros((n_clients, layout.size), dtype=torch.float32,
                       device=dev)
    tree = layout.views(flat)
    leaves = ([b["conv"] for b in tree["blocks"]]
              + [tree["fc1"]["w"], tree["fc2"]["w"]])
    for w in leaves:
        fan_in = 1
        for s in w.shape[1:-1]:
            fan_in *= s
        w.copy_(torch.randn(w.shape, generator=generator, device=dev)
                / fan_in ** 0.5)
    return flat


def _conv2d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv (odd kernel) as shifted views + one matmul, the
    reference's contraction form: the k·k views concatenated on channels
    in (di, dj, c) order meet ``w.reshape(k·k·C_in, C_out)`` of the HWIO
    weight. x: (N or 1, B, H, W, C); w: (N, k, k, C, O)."""
    k = w.shape[1]
    pad = k // 2
    n, b, h, wd, c = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    views = [xp[:, :, di:di + h, dj:dj + wd, :]
             for di in range(k) for dj in range(k)]
    patches = torch.cat(views, dim=-1).reshape(n, b * h * wd, k * k * c)
    out = torch.matmul(patches, w.reshape(w.shape[0], k * k * c, -1))
    return out.reshape(out.shape[0], b, h, wd, -1)


def _max_pool_2x2(h: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 VALID max-pool on (N, B, H, W, C)."""
    n, b, hh, ww, c = h.shape
    h2, w2 = hh // 2, ww // 2
    h = h[:, :, :2 * h2, :2 * w2, :].reshape(n, b, h2, 2, w2, 2, c)
    return h.amax(dim=(3, 5))


def apply_stacked(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Stacked params (N, ...) and x (N or 1, B, H, W, C) -> logits
    (N, B, n_classes)."""
    h = x
    for blk in params["blocks"]:
        h = _conv2d_same(h, blk["conv"])
        h = torch.relu(h + blk["bias"][:, None, None, None, :])
        h = _max_pool_2x2(h)
    h = h.reshape(h.shape[0], h.shape[1], -1)
    h = torch.relu(torch.matmul(h, params["fc1"]["w"])
                   + params["fc1"]["b"][:, None, :])
    return torch.matmul(h, params["fc2"]["w"]) + params["fc2"]["b"][:, None, :]


def per_sample_nll_stacked(params: Dict, x: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
    """(N, B) per-sample negative log-likelihood; y: (N or 1, B) int."""
    logp = torch.log_softmax(apply_stacked(params, x), dim=-1)
    y = y.long().expand(logp.shape[0], -1)
    return -torch.gather(logp, 2, y[..., None])[..., 0]


def masked_accuracy_stacked(params: Dict, x: torch.Tensor, y: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """(N,) accuracy over rows where ``mask`` (N, B) is set: padded rows
    count for nothing, so each entry equals the accuracy on the unpadded
    set."""
    ok = (torch.argmax(apply_stacked(params, x), dim=-1) == y).float()
    m = mask.float()
    return torch.sum(ok * m, dim=-1) / torch.clamp(torch.sum(m, dim=-1),
                                                   min=1.0)


# ------------------------------------------------- single-client functions

def _lift(params: Dict) -> Dict:
    if isinstance(params, dict):
        return {k: _lift(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_lift(v) for v in params]
    return params[None]


def apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, n_classes)."""
    return apply_stacked(_lift(params), x[None])[0]


def per_sample_nll(params: Dict, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Per-sample negative log-likelihood (the EM E-step loss, Eq 8)."""
    return per_sample_nll_stacked(_lift(params), x[None], y[None])[0]


def loss(params: Dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(per_sample_nll(params, x, y))


def accuracy(params: Dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(apply(params, x), dim=-1) == y).float())


def masked_accuracy(params: Dict, x: torch.Tensor, y: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    return masked_accuracy_stacked(_lift(params), x[None], y[None],
                                   mask[None])[0]
