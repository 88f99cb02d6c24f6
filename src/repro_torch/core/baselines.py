"""The FL/PFL baselines the paper compares pFedWN with (Sec V-A): FedAvg,
FedProx, Per-FedAvg (first-order MAML) and FedAMP, on the stacked flat
client buffer ``(N, P)`` (leaves in the reference's order, see
:mod:`repro_torch.utils.bridge`).

None of them runs a kernel: in the reference they are ``tensordot``,
``einsum`` and autodiff outside any Pallas call, so here they are plain
torch products (with TF32 off on the card, :func:`repro_torch.disable_tf32`).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

# loss_fn(params (K, P), x (K or 1, B, ...), y (K or 1, B)) -> (K,)
LossFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def fedavg_aggregate(stack: torch.Tensor, sizes: torch.Tensor,
                     participant_mask: torch.Tensor) -> torch.Tensor:
    """Size-weighted average over the participating rows of ``stack``
    (N, P): the global model (P,)."""
    w = sizes.float() * participant_mask.float()
    w = w / torch.clamp(torch.sum(w), min=1e-30)
    return (w @ stack.float()).to(stack.dtype)


def broadcast_global(global_params: torch.Tensor, stack: torch.Tensor,
                     participant_mask: torch.Tensor) -> torch.Tensor:
    """Participants adopt the global model; the other rows keep their own."""
    return torch.where(participant_mask[:, None],
                       global_params[None].to(stack.dtype), stack)


def prox_term(params: torch.Tensor, anchor: torch.Tensor,
              mu: float) -> torch.Tensor:
    """FedProx: (μ/2)·||w − w_anchor||² per row, summed in fp32 (a scalar
    for one (P,) row)."""
    d = params.float() - anchor.float()
    return 0.5 * mu * torch.sum(d * d, dim=-1)


def loss_and_grad(loss_fn: LossFn, params: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K,) losses and the gradient of each row's own loss: rows share no
    parameters, so the summed loss gives row k the gradient of loss k."""
    leaf = params.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(leaf, x, y)
        (g,) = torch.autograd.grad(torch.sum(loss), leaf)
    return loss.detach(), g


def perfedavg_step(loss_fn: LossFn, params: torch.Tensor, x1: torch.Tensor,
                   y1: torch.Tensor, x2: torch.Tensor, y2: torch.Tensor,
                   inner_lr: float, outer_lr: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-order Per-FedAvg (MAML) step for K rows at once:
    w ← w − β ∇f_{D₂}(w − α ∇f_{D₁}(w)). Returns ``(new params, (K,) query
    losses at the adapted params)``, the loss the metrics tap records."""
    _, g1 = loss_and_grad(loss_fn, params, x1, y1)
    adapted = params.detach() - inner_lr * g1
    l2, g2 = loss_and_grad(loss_fn, adapted, x2, y2)
    return params.detach() - outer_lr * g2, l2


def maml_adapt(loss_fn: LossFn, params: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor, inner_lr: float) -> torch.Tensor:
    """Personalisation at evaluation time: one adaptation step."""
    _, g = loss_and_grad(loss_fn, params, x, y)
    return params.detach() - inner_lr * g


def fedamp_weights(stack: torch.Tensor, sigma: float,
                   participant_mask: torch.Tensor,
                   self_weight: float = 0.5) -> torch.Tensor:
    """FedAMP attention over the rows of ``stack`` (N, P): ξ_nm ∝
    exp(−||w_n − w_m||²/σ) for m ≠ n among participants, ξ_nn =
    ``self_weight``; a non-participant's row is the identity. The squared
    distances take the reference's Gram form, so they round as it does.

    As in the reference, a participant with no other participant gets a
    softmax row of −∞, which turns NaN and then 0: its row sums to
    ``self_weight``, not to 1."""
    W = stack.float()
    n = W.shape[0]
    sq = torch.sum(W * W, dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2 * W @ W.T, min=0.0)
    logits = -d2 / max(sigma, 1e-12)
    eye = torch.eye(n, dtype=torch.bool, device=W.device)
    pm = participant_mask.bool()
    valid = pm[None, :] & pm[:, None] & ~eye
    logits = torch.where(valid, logits,
                         torch.full_like(logits, float("-inf")))
    off = torch.softmax(logits, dim=1)
    off = torch.where(torch.isnan(off), torch.zeros_like(off), off)
    eye_f = eye.float()
    xi = self_weight * eye_f + (1 - self_weight) * off
    return torch.where(pm[:, None], xi, eye_f)


def fedamp_cloud_models(stack: torch.Tensor,
                        xi: torch.Tensor) -> torch.Tensor:
    """u_n = Σ_m ξ_nm w_m, one product over the stack."""
    return (xi.float() @ stack.float()).to(stack.dtype)
