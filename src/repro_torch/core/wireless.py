"""D2D wireless channel model (paper Sec III-B + Appendix A), in fp32.

  - single-slope path loss       (Eq 3)
  - Rayleigh block fading        (Eq 4)
  - log-normal interference approximation with the Appendix A moments
  - transmission error probability P_err = P(SINR < γ_th) as the
    fading-pdf-weighted CCDF integral (final eq of Sec III-B), by a
    256-point Gauss–Legendre quadrature on [β, β + 8√Γ]

Functions broadcast over leading axes: a batch of links is one call.
Node positions come from :func:`ppp_positions` (a Poisson point process on
the area) and their distances from :func:`pairwise_distances`.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import WirelessConfig

_QUAD_POINTS = 256


def path_loss_amplitude(cfg: WirelessConfig, d: torch.Tensor) -> torch.Tensor:
    """sqrt(path loss) ĥ (Eq 3); d in meters (>= d0)."""
    d = torch.clamp(d, min=cfg.ref_distance_m)
    return (cfg.wavelength / (4 * math.pi * cfg.ref_distance_m)) * torch.sqrt(
        (cfg.ref_distance_m / d) ** cfg.path_loss_exp)


def rayleigh_pdf(cfg: WirelessConfig, x: torch.Tensor) -> torch.Tensor:
    """Eq (4): p(x) = 2x/Γ exp(-x²/Γ)."""
    g = cfg.rayleigh_gamma
    return 2 * x / g * torch.exp(-x * x / g)


def p_transmit(cfg: WirelessConfig) -> float:
    """P(interferer transmits on the considered sub-channel):
    (1/|F|)(1 - (1 - e^{-β²/Γ})^{|F|})."""
    g, b, F = cfg.rayleigh_gamma, cfg.fading_threshold, cfg.n_subchannels
    return (1.0 / F) * (1 - (1 - math.exp(-b * b / g)) ** F)


def _moment_x3(cfg: WirelessConfig) -> float:
    """∫_β^∞ (2x³/Γ) e^{-x²/Γ} dx = Γ (1 + u) e^{-u}, u = β²/Γ."""
    g, b = cfg.rayleigh_gamma, cfg.fading_threshold
    u = b * b / g
    return g * (1 + u) * math.exp(-u)


def _moment_x5(cfg: WirelessConfig) -> float:
    """∫_β^∞ (2x⁵/Γ) e^{-x²/Γ} dx = Γ² (u² + 2u + 2) e^{-u}."""
    g, b = cfg.rayleigh_gamma, cfg.fading_threshold
    u = b * b / g
    return g * g * (u * u + 2 * u + 2) * math.exp(-u)


def interference_moments(cfg: WirelessConfig, interferer_dists: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Appendix A: (mean, variance) of the aggregate interference from
    interferers at the distances on the last axis. Distances <= 0 mark
    padding entries (ignored)."""
    valid = (interferer_dists > 0).float()
    h_hat2 = path_loss_amplitude(cfg, interferer_dists) ** 2
    P, p_tx = cfg.tx_power_w, p_transmit(cfg)
    # per-interferer first moment P ĥ² E[x²·α] and second moment P² ĥ⁴ m5 p_tx
    e1 = P * h_hat2 * _moment_x3(cfg) * p_tx * valid
    e2 = (P ** 2) * (h_hat2 ** 2) * _moment_x5(cfg) * p_tx * valid
    mean = torch.sum(e1, dim=-1)
    var = torch.sum(e2 - e1 ** 2, dim=-1)
    return mean, torch.clamp(var, min=1e-45)


def lognormal_params(mean: torch.Tensor, var: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Moment-matched log-normal (μ, σ) (Appendix A)."""
    mean = torch.clamp(mean, min=1e-45)
    ratio = var / (mean * mean)
    mu = torch.log(mean) - 0.5 * torch.log1p(ratio)
    sigma = torch.sqrt(torch.log1p(ratio))
    return mu, torch.clamp(sigma, min=1e-12)


def lognormal_ccdf(x: torch.Tensor, mu: torch.Tensor,
                   sigma: torch.Tensor) -> torch.Tensor:
    """v_s(x) = P(I > x); for x <= 0 the CCDF of a positive rv is 1."""
    z = (torch.log(torch.clamp(x, min=1e-45)) - mu) / sigma
    ccdf = 0.5 * torch.special.erfc(z / math.sqrt(2.0))
    return torch.where(x <= 0, torch.ones_like(ccdf), ccdf)


def error_probability(cfg: WirelessConfig, link_dist: torch.Tensor,
                      interferer_dists: torch.Tensor,
                      sinr_threshold: float | None = None) -> torch.Tensor:
    """P_err for links at ``link_dist`` (...,) with interferers at
    ``interferer_dists`` (..., K) (entries <= 0 are padding).

    P_err = ∫_β^∞ p_fading(x) · v(P ĥ² x² / γ_th − σ²) dx, as a
    Gauss–Legendre quadrature on [β, β + 8 sqrt(Γ)]."""
    gamma_th = (cfg.sinr_threshold_db if sinr_threshold is None
                else sinr_threshold)
    mean, var = interference_moments(cfg, interferer_dists)
    mu, sigma = lognormal_params(mean, var)
    h_hat2 = path_loss_amplitude(cfg, link_dist) ** 2
    g, beta = cfg.rayleigh_gamma, cfg.fading_threshold

    nodes, weights = np.polynomial.legendre.leggauss(_QUAD_POINTS)
    hi = beta + 8.0 * float(np.sqrt(g))
    x = torch.as_tensor(0.5 * (nodes + 1) * (hi - beta) + beta,
                        dtype=torch.float32, device=link_dist.device)
    w = torch.as_tensor(weights * 0.5 * (hi - beta), dtype=torch.float32,
                        device=link_dist.device)

    pdf = rayleigh_pdf(cfg, x)
    arg = cfg.tx_power_w * h_hat2[..., None] * x * x / gamma_th \
        - cfg.noise_power
    ccdf = lognormal_ccdf(arg, mu[..., None], sigma[..., None])
    return torch.clamp(torch.sum(w * pdf * ccdf, dim=-1), 0.0, 1.0)


def pairwise_distances(pos: torch.Tensor) -> torch.Tensor:
    """(G, G) distances between the rows of ``pos`` (G, 2). The root is
    taken in fp64 and rounded once: torch's fp32 root on the CPU is not
    correctly rounded, and this one is, as the reference's is."""
    d = pos[:, None, :] - pos[None, :, :]
    sq = torch.sum(d * d, dim=-1) + 1e-12
    return torch.sqrt(sq.double()).to(sq.dtype)


def ppp_positions(generator: torch.Generator, cfg: WirelessConfig,
                  density: float, max_nodes: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Poisson point process on the area, on ``generator``'s device:
    (positions (max_nodes, 2) uniform on the square, valid mask). The node
    count is Poisson(density · area), clipped to [1, max_nodes]; the first
    that many rows are valid."""
    dev = generator.device
    rate = torch.tensor(density * cfg.area_m * cfg.area_m,
                        dtype=torch.float32, device=dev)
    n = torch.clamp(torch.poisson(rate, generator=generator), 1, max_nodes)
    pos = torch.rand((max_nodes, 2), generator=generator,
                     device=dev) * cfg.area_m
    valid = torch.arange(max_nodes, device=dev) < n
    return pos, valid
