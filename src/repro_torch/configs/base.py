"""Federated-learning and wireless-channel configs (paper Table I), LM
training's ``TrainConfig``, the language models' ``ModelConfig``, the
step builders' ``ShapeConfig`` and the registry ``--arch`` selects
from."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple


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


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgd"            # sgd | momentum | adamw
    lr: float = 3e-4
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0
    remat: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    seed: int = 0


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 0
    n_shared_experts: int = 0     # always-on shared experts (deepseek style)
    expert_d_ff: int = 0          # per-expert hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-3
    first_k_dense: int = 0        # leading dense layers (deepseek v3: 3)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (deepseek-v2/v3, minicpm3)."""
    q_lora_rank: int = 0          # 0 => full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16           # N
    conv_dim: int = 4             # depthwise conv window
    expand: int = 2               # d_inner = expand * d_model
    version: int = 1              # 1 = mamba1, 2 = mamba2 (SSD heads)
    head_dim: int = 64            # mamba2 head dim
    n_groups: int = 1             # mamba2 B/C groups


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    rope: str = "rope"            # none | rope | rope2d | mrope
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0    # chatglm rotates half => 0.5
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0       # 0 => full attention
    attn_logit_softcap: float = 0.0
    qkv_bias: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0    # zamba2: one shared attention block every k
    n_stub_tokens: int = 0        # vlm/audio: precomputed frontend embeddings
    mtp_depth: int = 0            # deepseek v3 multi-token prediction
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model <= 256, <= 4 heads and
        experts, vocab <= 512; the reference's ``reduced`` field by field."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) or 1
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        kw: Dict = dict(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512) or 0,
            vocab=min(self.vocab, 512),
            head_dim=64 if self.head_dim else 0,
            n_stub_tokens=min(self.n_stub_tokens, 8),
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            mtp_depth=min(self.mtp_depth, 1),
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=min(self.moe.expert_d_ff, 128),
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                first_k_dense=min(self.moe.first_k_dense, 1),
                capacity_factor=4.0,
            )
        if self.mla:
            kw["mla"] = dataclasses.replace(
                self.mla,
                q_lora_rank=min(self.mla.q_lora_rank, 64),
                kv_lora_rank=min(self.mla.kv_lora_rank, 32),
                qk_nope_head_dim=32,
                qk_rope_head_dim=16,
                v_head_dim=32,
            )
        if self.ssm:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=min(self.ssm.state_dim, 16),
                head_dim=min(self.ssm.head_dim, 32))
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """An input shape of the step builders (``launch/steps.py``)."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                     # train | prefill | decode
    # decode shapes: cache length == seq_len, step processes ONE new token
    force_sliding_window: int = 0 # long_500k: SW substitution for dense archs


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
