"""musicgen-large (arXiv:2306.05284): a decoder over EnCodec tokens, 32
heads of 64 (G = 1), no rotary embedding. The text-conditioning frontend
is a stub: 64 precomputed frame embeddings arrive as a prefix
(``stub_embeds``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register


@register("musicgen-large")
def musicgen_large() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=2048,
        rope="none", n_stub_tokens=64,
        source="arXiv:2306.05284")
