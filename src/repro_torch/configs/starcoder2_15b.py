"""starcoder2-15b (arXiv:2402.19173): dense GQA with its native 4096-token
sliding window."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register


@register("starcoder2-15b")
def starcoder2_15b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=4, d_ff=24576, vocab=49152,
        sliding_window=4096,
        source="arXiv:2402.19173")
