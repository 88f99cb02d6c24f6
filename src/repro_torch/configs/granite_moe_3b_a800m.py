"""granite-moe-3b-a800m: 32 MoE layers of 40 experts (top 8, 512 wide),
24 heads over 8 KV heads of 64, vocab 49,155. The ``source`` field is
copied as the reference has it."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("granite-moe-3b-a800m")
def granite_moe() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
        n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155,
        moe=MoEConfig(n_experts=40, top_k=8, n_shared_experts=0,
                      expert_d_ff=512),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base")
