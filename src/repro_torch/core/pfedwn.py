"""pFedWN's EM weight assignment at the target (Algorithm 1, bottom half).

Components are the target's copies of its M neighbours' models, held as one
stacked flat buffer (M, P). Each EM iteration runs the E-step (Eq 9) through
the fused cross-entropy + posterior kernel (:mod:`repro_torch.kernels.
em_posterior`), the M-step for π (Eq 10), and the λ-weighted component
refinement (Eq 11) whose first SGD step reuses the E-step's own forward.
:func:`pfedwn_round` is one whole Algorithm-2 round at the target: EM,
the erasure-gated Eq-1 mix (:mod:`repro_torch.kernels.weighted_agg`) and
local training from the aggregate.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import PFLConfig
from repro_torch.core import aggregation, em
from repro_torch.core.selection import link_success_mask
from repro_torch.kernels.em_posterior import em_posterior


class ModelFns(NamedTuple):
    """Model functions over a stacked flat param buffer ``(N, P)`` and a
    batch ``x`` of ``(N or 1, B, ...)`` (``1`` feeds every model the same
    batch), with labels ``y`` of ``(N or 1, B)``."""
    logits: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (N, B, V)
    per_sample_loss: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                              torch.Tensor]                       # (N, B)
    loss: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                   torch.Tensor]                                  # (N,)
    accuracy: Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor], torch.Tensor]   # (N,), masked rows


def pi_entropy(pi: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of the EM weights π (log M for uniform weights,
    → 0 as EM locks onto one neighbour; 0.0 for empty π)."""
    p = torch.clamp(pi, 1e-12, 1.0)
    return -torch.sum(p * torch.log(p))


def effective_neighbors(pi: torch.Tensor,
                        link_ok: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Inverse Simpson index 1/Σ π̃²_m of the (optionally erasure-gated)
    weights renormalised over surviving links: M for uniform weights with
    all links up, 1.0 when one neighbour dominates, 0.0 when every link
    failed."""
    w = pi if link_ok is None else pi * link_ok.to(pi.dtype)
    s = torch.sum(w)
    wn = w / torch.clamp(s, min=1e-12)
    eff = 1.0 / torch.clamp(torch.sum(wn * wn), min=1e-12)
    return torch.where(s > 0, eff, torch.zeros_like(eff)).float()


def component_losses(fns: ModelFns, components: torch.Tensor,
                     x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample losses of every component on the target's data.
    components: (M, P). Returns (n, M)."""
    return fns.per_sample_loss(components, x[None], y[None]).T


def refine_components(fns: ModelFns, components: torch.Tensor,
                      lam: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      lr: float, steps: int = 1) -> torch.Tensor:
    """Eq (11): λ-weighted SGD on each component. The summed objective
    gives each component the gradient of its own weighted loss."""
    for _ in range(steps):
        leaf = components.detach().requires_grad_(True)
        ell = fns.per_sample_loss(leaf, x[None], y[None])          # (M, n)
        obj = torch.sum(torch.stack([em.weighted_loss(ell[m], lam[:, m])
                                     for m in range(ell.shape[0])]))
        (g,) = torch.autograd.grad(obj, leaf)
        components = components - lr * g
    return components


def _e_step(fns: ModelFns, comps: torch.Tensor, pi: torch.Tensor,
            x: torch.Tensor, y: torch.Tensor, min_weight: float,
            with_grad: bool):
    """E-step through the fused kernel: (floored λ (n, M), π update,
    autograd leaf, per-sample losses ℓ (n, M))."""
    leaf = comps.detach().requires_grad_(with_grad)
    with torch.set_grad_enabled(with_grad):
        lam, ell = em_posterior(pi, fns.logits(leaf, x[None]), y)
    lam = em.floor_posterior(lam, min_weight)
    return lam, em.update_pi(lam), leaf, ell


def em_refine_loop(fns: ModelFns, components: torch.Tensor, pi: torch.Tensor,
                   x: torch.Tensor, y: torch.Tensor, *, iters: int, lr: float,
                   min_weight: float = 1e-6, component_steps: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``iters`` EM iterations on the components (M, P) with the target's
    data x (n, ...), y (n,) int64.

    Three hoists, as in the reference: ``iters <= 0`` returns at once; with
    ``component_steps=0`` the loss matrix is computed once for all
    iterations; otherwise each iteration runs one forward and one backward
    through the components, the backward pulling ℓ back with cotangent
    λ_im / Σ_i λ_im (the gradient of the first Eq-11 step), and the last
    iteration does E/M only. The caller's ``components`` are never written.

    Returns (components as seen by the final E-step, π*, π history
    (iters, M))."""
    if iters <= 0:
        return components, pi, pi.new_zeros((0,) + tuple(pi.shape))

    hist = []
    if component_steps == 0:
        with torch.no_grad():
            losses = component_losses(fns, components, x, y)
        for _ in range(iters):
            pi = em.update_pi(em.posterior(pi, losses, min_weight))
            hist.append(pi)
        return components, pi, torch.stack(hist)

    comps = components
    for _ in range(iters - 1):
        lam, pi_new, leaf, ell = _e_step(fns, comps, pi, x, y, min_weight,
                                         True)
        ct = lam / torch.clamp(torch.sum(lam, dim=0, keepdim=True),
                               min=1e-30)
        (g,) = torch.autograd.grad(ell, leaf, grad_outputs=ct)
        comps = comps - lr * g
        if component_steps > 1:
            comps = refine_components(fns, comps, lam, x, y, lr,
                                      component_steps - 1)
        pi = pi_new
        hist.append(pi_new)
    _, pi_star, _, _ = _e_step(fns, comps, pi, x, y, min_weight, False)
    hist.append(pi_star)
    return comps, pi_star, torch.stack(hist)


def pfedwn_round(generator: torch.Generator, fns: ModelFns,
                 target_params: torch.Tensor, neighbor_params: torch.Tensor,
                 pi: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 p_err: torch.Tensor, cfg: PFLConfig,
                 local_train: Callable[[torch.Tensor, torch.Generator],
                                       torch.Tensor],
                 component_steps: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Dict[str, torch.Tensor]]:
    """One Algorithm-2 round at the target.

    ``target_params`` (P,) and ``neighbor_params`` (M, P): the target and
    the M models as *received* this round; ``pi`` (M,) last
    round's posterior; ``p_err`` (M,) the links' erasure probabilities,
    drawn from ``generator`` (on ``p_err``'s device), which then goes on to
    ``local_train(mixed, generator)``. Returns (new target params, π*,
    info with ``pi``, ``pi_history`` and ``link_ok``)."""
    components, pi_star, pi_hist = em_refine_loop(
        fns, neighbor_params, pi, x, y, iters=cfg.em_iters, lr=cfg.lr,
        min_weight=cfg.em_min_weight, component_steps=component_steps)
    link_ok = link_success_mask(p_err, generator)
    mixed = aggregation.mix_params_with_erasures(
        target_params, neighbor_params, pi_star, cfg.alpha, link_ok)
    new_params = local_train(mixed, generator)
    info = {"pi": pi_star, "pi_history": pi_hist, "link_ok": link_ok}
    return new_params, pi_star, info
