"""falcon-mamba-7b (arXiv:2410.05355): attention-free, 64 Mamba1 layers
of d_model 4096 (d_inner 8192, state 16, conv 4), vocab 65,024, an untied
head."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("falcon-mamba-7b")
def falcon_mamba_7b() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=65024, rope="none",
        ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2, version=1),
        source="arXiv:2410.05355")
