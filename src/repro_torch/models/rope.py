"""Rotary position embeddings: standard ("rope"), partial ("rope2d",
chatglm's rotation of the first half of each head) and M-RoPE ("mrope",
qwen2-vl's three-axis rotation).

``apply_rope`` rotates x (..., S, H, Dh) over its last dim, as the
reference does. It takes int positions (..., S) for rope and rope2d, and
(..., S, 3) for mrope: the temporal, height and width components, each
driving its own band of the head's frequencies.
"""
from __future__ import annotations

from typing import Tuple

import torch

# the share of the half-dim frequencies that each M-RoPE component (t, h,
# w) drives; qwen2-vl's 16/24/24 of 64 half-dims
MROPE_SECTIONS: Tuple[float, float, float] = (0.25, 0.375, 0.375)


def _inv_freq(rot_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps)


def _mrope_angles(positions: torch.Tensor, rot_dim: int,
                  theta: float) -> torch.Tensor:
    """(..., S, 3) int positions -> (..., S, rot_dim / 2) fp32 angles: the
    first ``n_t`` frequencies take the temporal component, the next ``n_h``
    the height one, the rest the width one (M-RoPE, arXiv:2409.12191)."""
    half = rot_dim // 2
    n_t = int(round(MROPE_SECTIONS[0] * half))
    n_h = int(round(MROPE_SECTIONS[1] * half))
    band = torch.arange(half, device=positions.device)
    section = (band >= n_t).long() + (band >= n_t + n_h).long()  # 0, 1, 2
    picked = torch.index_select(positions.float(), -1, section)
    return picked * _inv_freq(rot_dim, theta, positions.device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, variant: str,
               theta: float, fraction: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, Dh). Rotates the first ``fraction`` of Dh; rope2d is
    rope with the config's ``rope_fraction``."""
    if variant == "none":
        return x
    if variant not in ("rope", "rope2d", "mrope"):
        raise ValueError(f"unknown rope variant {variant!r}")
    dh = x.shape[-1]
    rot_dim = int(dh * fraction)
    rot_dim -= rot_dim % 2
    if variant == "mrope":
        ang = _mrope_angles(positions, rot_dim, theta)
    else:
        ang = positions.float()[..., None] * _inv_freq(rot_dim, theta,
                                                       x.device)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)      # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = torch.chunk(x_rot, 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated, x_pass], dim=-1)
