"""minicpm3-4b (hf:openbmb/MiniCPM3-4B): dense, with multi-head latent
attention (MLA): 40 heads attending at 64 + 32 (no-rope + rope) over a
256-wide KV latent, v 64, a q LoRA of rank 768."""
from __future__ import annotations

from repro_torch.configs.base import MLAConfig, ModelConfig, register


@register("minicpm3-4b")
def minicpm3_4b() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense", n_layers=62, d_model=2560,
        n_heads=40, n_kv_heads=40, d_ff=6400, vocab=73448,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32,
                      v_head_dim=64),
        source="hf:openbmb/MiniCPM3-4B")
