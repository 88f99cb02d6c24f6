"""Federated-learning and wireless-channel configs (paper Table I)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WirelessConfig:
    """Table I parameters (ISM band)."""
    area_m: float = 50.0
    n_subchannels: int = 14
    rayleigh_gamma: float = 2.0       # Γ (E[h~^2])
    path_loss_exp: float = 3.0        # α_s
    ref_distance_m: float = 1.0       # d0
    tx_power_w: float = 0.2           # P
    freq_hz: float = 2.4e9
    boltzmann: float = 1.38e-23
    noise_temp_k: float = 290.0
    bandwidth_hz: float = 100e6
    fading_threshold: float = 2.0     # β
    sinr_threshold_db: float = 10.0   # γ_th (linear value used directly in paper: 5/10/15)
    error_threshold: float = 0.05     # ε

    @property
    def noise_power(self) -> float:
        return self.boltzmann * self.noise_temp_k * self.bandwidth_hz

    @property
    def wavelength(self) -> float:
        return 3e8 / self.freq_hz


@dataclass(frozen=True)
class PFLConfig:
    alpha: float = 0.5                # Eq (1) self-weight
    local_epochs: int = 1             # E
    lr: float = 0.05                  # η
    rounds: int = 100                 # T
    em_iters: int = 5                 # EM refinement iterations per round
    em_min_weight: float = 1e-6       # simplex floor for numerical safety
    seed: int = 0
