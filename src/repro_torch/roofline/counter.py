"""The work a run does, counted while it runs: the port's counterpart of
XLA's ``cost_analysis`` on a compiled step.

:class:`CostCounter` is a ``TorchDispatchMode``. Every aten op that runs
under it adds its FLOPs (``torch.utils.flop_counter``'s formulas: the
matrix products and convolutions, the ops that carry a step's FLOPs) and
its bytes accessed: the bytes of its tensor arguments and results, each
read or written once, a view (a result that aliases an argument and
writes nothing) counting 0. An eager op reads its inputs from and writes
its outputs to device memory, so this is the step's traffic with no
fusion, where XLA's count is its fused program's.

The port's hand-written kernels are counted by their own formulas, the
same on every device: the kernel wrappers enter :func:`kernel` around the
work of one call, whether it runs on the card (a ctypes launch, which no
dispatch mode sees), on the CPU (the plain version, whose own aten ops
are then not counted) or on the ``meta`` device (shapes only). A counter
adds the kernel's FLOPs and bytes to its totals and to
``kernels[name]``. Outside any counter :func:`kernel` computes nothing.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_active: List["CostCounter"] = []     # the counters entered, innermost last


def _tensor_bytes(args) -> int:
    """The bytes of the tensors in ``args`` (a tensor, or a list, tuple or
    dict of them, nested)."""
    if isinstance(args, torch.Tensor):
        return args.numel() * args.element_size()
    if isinstance(args, dict):
        args = args.values()
    elif not isinstance(args, (list, tuple)):
        return 0
    return sum(_tensor_bytes(a) for a in args)


_views: Dict[object, bool] = {}


def _is_view(func) -> bool:
    """Whether ``func``'s results alias an argument it does not write."""
    if func not in _views:
        returns = func._schema.returns
        _views[func] = bool(returns) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in returns)
    return _views[func]


class CostCounter(TorchDispatchMode):
    """Counts FLOPs and bytes accessed (module docstring): ``flops`` and
    ``bytes`` in all; ``kernels[name]`` = {"flops", "bytes", "calls"} for
    each hand-written kernel."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self._inside_kernel = 0

    def __enter__(self):
        _active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active.remove(self)
        return super().__exit__(*exc)

    def kernel_flops(self) -> int:
        return sum(k["flops"] for k in self.kernels.values())

    def summary(self) -> Dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "kernel_flops": self.kernel_flops()}

    def _add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        entry = self.kernels.setdefault(name, {"flops": 0, "bytes": 0,
                                               "calls": 0})
        entry["flops"] += flops
        entry["bytes"] += nbytes
        entry["calls"] += 1
        self.flops += flops
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside_kernel:
            return out
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not _is_view(func):
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


@contextlib.contextmanager
def kernel(name: str, cost: Callable[[], Tuple[int, int]]):
    """Around one call of a hand-written kernel: every active counter adds
    ``cost()`` = (FLOPs, bytes) under ``name`` and counts none of the aten
    ops run inside (the plain version's, on the CPU). ``cost`` is called
    only when a counter is active."""
    if not _active:
        yield
        return
    flops, nbytes = cost()
    counters = list(_active)
    for c in counters:
        c._add_kernel(name, int(flops), int(nbytes))
        c._inside_kernel += 1
    try:
        yield
    finally:
        for c in counters:
            c._inside_kernel -= 1
