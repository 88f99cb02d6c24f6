"""smollm-135m (hf:HuggingFaceTB/SmolLM-135M): dense GQA, 9 heads over 3 KV
heads of 64."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register


@register("smollm-135m")
def smollm_135m() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense", n_layers=30, d_model=576,
        n_heads=9, n_kv_heads=3, d_ff=1536, vocab=49152,
        source="hf:HuggingFaceTB/SmolLM-135M")
