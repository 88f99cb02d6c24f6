"""Collective traffic of a step, counted as the port's calls issue it: the
port's counterpart of the reference's ``roofline/hlo.py``, which reads it
out of a compiled module's HLO. The port has no HLO; its collectives all go
through ``core/aggregation.py``'s :func:`all_gather` and :func:`all_reduce`
(the round step's exchange, its π gather and its metrics reduce among
them), which report each one here.

As ``hlo.py`` does, an op contributes its OUTPUT bytes, the bytes that
land on each rank: an all-gather of a (K, ...) tensor over D ranks its
(D·K, ...) result, an all-reduce its reduced tensor. The return shape is
``hlo.py``'s, ``{"total", "by_kind", "count"}``.
"""
from __future__ import annotations

from typing import Dict, List

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_active: List["CollectiveCounter"] = []


class CollectiveCounter:
    """A context that sums the collectives issued inside it, by kind."""

    def __init__(self):
        self.by_kind: Dict[str, float] = {k: 0.0 for k in KINDS}
        self.count = 0

    def __enter__(self):
        _active.append(self)
        return self

    def __exit__(self, *exc):
        _active.remove(self)

    def summary(self) -> Dict:
        """``{"total": bytes, "by_kind": {kind: bytes}, "count": int}``,
        the kinds that moved no bytes left out, as ``hlo.py`` returns."""
        return {"total": sum(self.by_kind.values()),
                "by_kind": {k: v for k, v in self.by_kind.items() if v},
                "count": self.count}


def record(kind: str, out: torch.Tensor) -> None:
    """One collective of ``kind`` whose result on this rank is ``out``."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    for c in _active:
        c.by_kind[kind] += out.numel() * out.element_size()
        c.count += 1
