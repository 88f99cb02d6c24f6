"""deepseek-v3-671b (arXiv:2412.19437): 61 layers, the first 3 dense, the
rest MoE (256 routed experts, top 8, one shared, 2048 wide); MLA (q LoRA
1536, kv latent 512, qk 128 + 64, v 128); one MTP block."""
from __future__ import annotations

from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      register)


@register("deepseek-v3-671b")
def deepseek_v3_671b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
        n_heads=128, n_kv_heads=128, d_ff=18432, vocab=129280,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, n_shared_experts=1,
                      expert_d_ff=2048, first_k_dense=3),
        mtp_depth=1,
        source="arXiv:2412.19437")
