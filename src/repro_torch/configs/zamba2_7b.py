"""zamba2-7b (arXiv:2411.15242): 81 Mamba2 layers of d_model 3584 (112
SSD heads of 64, state 64, one B/C group) and one shared attention + MLP
block (32 heads of 112, d_ff 14,336) applied after every 6th layer: 13
applications."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("zamba2-7b")
def zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
        n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
        hybrid_attn_every=6,
        ssm=SSMConfig(state_dim=64, conv_dim=4, expand=2, version=2,
                      head_dim=64, n_groups=1),
        source="arXiv:2411.15242")
