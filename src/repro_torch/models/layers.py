"""Primitive layers: init helpers, RMSNorm, linear, the SwiGLU MLP, the
embedding and the fp32 unembedding.

Params are plain nested dicts of tensors in the reference's layouts:
``(in, out)`` dense weights, ``(V, D)`` embedding, ``(D,)`` norm scales,
in the dtype the init is given (fp32 by default; the reference defaults
to bf16). Inits draw in fp32 from an explicit ``torch.Generator`` with the
reference's distributions and then cast, as the reference does (its bits
come from ``jax.random`` and cannot be repeated; the tests carry the
reference's weights across instead).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1/in_dim) of shape (in_dim, out_dim), drawn in fp32 and
    scaled in place (the same bits as a scaled copy, without the copy)."""
    w = torch.randn((in_dim, out_dim), generator=gen, device=device)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 0.02²) of shape (vocab, d_model), drawn in fp32, scaled in
    place."""
    w = torch.randn((vocab, d_model), generator=gen, device=device)
    return w.mul_(0.02).to(dtype)


def rmsnorm_init(dim: int, device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.ones((dim,), device=device, dtype=dtype)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Statistics in fp32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def linear(w: torch.Tensor, x: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) @ w (in, out) [+ b]."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, device,
             dtype: torch.dtype = torch.float32) -> dict:
    return {"w_gate": dense_init(gen, d_model, d_ff, device, dtype),
            "w_up": dense_init(gen, d_model, d_ff, device, dtype),
            "w_down": dense_init(gen, d_ff, d_model, device, dtype)}


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: w_down(silu(w_gate x) * w_up x)."""
    h = F.silu(linear(params["w_gate"], x)) * linear(params["w_up"], x)
    return linear(params["w_down"], h)


def embed_apply(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embedding[tokens]


def unembed_apply(embedding_or_head: torch.Tensor, x: torch.Tensor,
                  transpose: bool) -> torch.Tensor:
    """Logits in fp32: x @ embedding.T (tied) or x @ lm_head."""
    w = embedding_or_head.float()
    return torch.matmul(x.float(), w.T if transpose else w)
