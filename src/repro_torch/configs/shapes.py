"""The four assigned input shapes, the reference's ``configs/shapes.py``
(a copy: the port imports nothing of the reference)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ShapeConfig

SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256,
                            mode="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32,
                               mode="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128,
                              mode="decode"),
    # long-context decode: sub-quadratic attention required. Dense archs get
    # the sliding-window substitution (launch/steps.py::effective_window).
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1,
                             mode="decode", force_sliding_window=4096),
}


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]
