"""chatglm3-6b (arXiv:2406.12793): RoPE on half of each head ("rope2d"),
GQA with 2 KV groups."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register


@register("chatglm3-6b")
def chatglm3_6b() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
        n_heads=32, n_kv_heads=2, d_ff=13696, vocab=65024,
        rope="rope2d", rope_fraction=0.5,
        source="arXiv:2406.12793")
