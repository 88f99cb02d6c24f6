"""qwen2-vl-2b (arXiv:2409.12191): the language backbone, dense GQA (12
heads over 2 KV heads of 128) with qkv biases and M-RoPE (the head's
frequencies split 16/24/24 between the temporal, height and width position
components). The vision encoder is a stub: 256 precomputed patch
embeddings arrive as a prefix (``stub_embeds``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register


@register("qwen2-vl-2b")
def qwen2_vl_2b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
        n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936,
        rope="mrope", rope_theta=1e6, n_stub_tokens=256, qkv_bias=True,
        source="arXiv:2409.12191")
