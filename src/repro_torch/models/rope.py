"""Rotary position embeddings: standard ("rope") and partial ("rope2d",
chatglm's rotation of the first half of each head).

``apply_rope`` takes int positions (..., S) and rotates x (..., S, H, Dh)
over its last dim, as the reference does. M-RoPE (qwen2-vl) waits for that
family's port.
"""
from __future__ import annotations

import torch


def _inv_freq(rot_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, variant: str,
               theta: float, fraction: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, Dh). Rotates the first ``fraction`` of Dh; rope2d is
    rope with the config's ``rope_fraction``."""
    if variant == "none":
        return x
    if variant == "mrope":
        raise NotImplementedError("mrope comes with the qwen2-vl family "
                                  "(ROADMAP Queue A item 4)")
    if variant not in ("rope", "rope2d"):
        raise ValueError(f"unknown rope variant {variant!r}")
    dh = x.shape[-1]
    rot_dim = int(dh * fraction)
    rot_dim -= rot_dim % 2
    ang = positions.float()[..., None] * _inv_freq(rot_dim, theta, x.device)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)      # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = torch.chunk(x_rot, 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated, x_pass], dim=-1)
