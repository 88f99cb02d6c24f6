"""Where each rank's clients live: the client half of the reference's
``sharding/rules.py`` (``client_axis_spec``, ``client_stack_shardings``,
``client_tap_spec``) as plain functions.

The reference partitions the leading client axis of every stacked tensor
over a ``("clients",)`` mesh axis. Here each of the D ranks of a
``torch.distributed`` group holds the contiguous slab of S = N / D clients
that starts at ``rank · S``: of the (N, ...) client stacks (params, the
padded train and test stacks) along axis 0, and of a (rounds, N, ...) tap
buffer along axis 1. The language-model rules of the reference's module
(``spec_for_param``, ``param_shardings``, ``batch_spec``,
``cache_shardings``) have no counterpart yet.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def client_slab(n: int, d: int, rank: int) -> Tuple[int, int]:
    """(offset, S): the first client of ``rank``'s slab and the slab's
    size, for N = ``n`` clients over ``d`` ranks (``d`` must divide
    ``n``)."""
    if d < 1 or n % d:
        raise ValueError(f"client count N={n} must be divisible by the "
                         f"client-group size D={d}")
    if not 0 <= rank < d:
        raise ValueError(f"rank {rank} is outside a client group of {d}")
    s = n // d
    return rank * s, s


def take_slab(x, offset: int, size: int, client_axis: int = 0):
    """The slab ``[offset, offset + size)`` of ``x`` along its client axis:
    0 for an (N, ...) stack, 1 for a (rounds, N, ...) tap buffer. A view
    for tensors and numpy arrays alike."""
    index = (slice(None),) * client_axis + (slice(offset, offset + size),)
    return x[index]


def join_slabs(slabs: Sequence[torch.Tensor],
               client_axis: int = 0) -> torch.Tensor:
    """The full client stack from the ranks' slabs, given in rank order."""
    return torch.cat(list(slabs), dim=client_axis)
