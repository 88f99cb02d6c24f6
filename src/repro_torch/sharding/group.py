"""The sharded engine's ``"clients"`` process group, and :func:`spawn`, which
starts one process a rank.

:func:`client_group` is the counterpart of the reference's
``FederatedSimulation._client_mesh_info``: D = ``shard_devices`` ranks
(every rank of the default group when None) each own S = N / D clients.
The reference builds a mesh over the first D devices; here the ranks of the
default ``torch.distributed`` group play the devices, so the group must
have been started (:func:`spawn` does it) before a sharded run with D > 1.
With no process group started, D = 1 runs in process and every collective
reduces over that one rank.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist


class ClientGroup(NamedTuple):
    group: Optional[Any]     # the process group; None: no group, D = 1
    d: int                   # ranks in the group
    s: int                   # clients a rank holds
    rank: int                # this process's rank in the group


def client_group(n: int, shard_devices: Optional[int] = None) -> ClientGroup:
    """The client group for N = ``n`` clients over ``shard_devices`` ranks.

    Raises ValueError when D does not divide N or exceeds the default
    group's world size, and RuntimeError when D > 1 and no process group
    has been started (it never runs on fewer ranks quietly). Every rank of
    the default group must call it, since a group smaller than the world is
    made with ``new_group``; a rank outside the first D has no slab and
    raises."""
    started = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if started else 1
    d = shard_devices or world
    if d < 1 or n % d != 0:
        raise ValueError(f"client count N={n} must be divisible by the "
                         f"client-group size D={d}")
    if not started:
        if d > 1:
            raise RuntimeError(
                f"shard_devices={d} needs {d} ranks, and no process group "
                f"is started: call torch.distributed.init_process_group in "
                f"each rank (repro_torch.sharding.spawn does it)")
        return ClientGroup(None, 1, n, 0)
    if d > world:
        raise ValueError(f"shard_devices={d} but only {world} devices "
                         f"(ranks of the default process group) are visible")
    group = dist.group.WORLD if d == world else dist.new_group(list(range(d)))
    rank = dist.get_rank()
    if rank >= d:
        raise ValueError(f"rank {rank} is outside the client group of the "
                         f"first {d} ranks")
    return ClientGroup(group, d, n // d, rank)


def default_backend(world: int, device: str) -> str:
    """``nccl`` when every rank can have a card of its own, else ``gloo``
    (the CPU, or more ranks than cards: NCCL refuses two ranks on one
    device, and gloo stages CUDA tensors through the host)."""
    if torch.device(device).type == "cuda" and \
            world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               device: str, store: str, out_dir: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str, device: str,
          *args) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` new processes, one a rank, each in a
    started ``backend`` process group of that world size, and return each
    rank's result (moved to the CPU), in rank order.

    Processes start with the ``spawn`` method, since CUDA cannot be used
    in a forked child; ``fn`` and ``args`` are pickled, so ``fn`` must be
    importable (a function of a package or script, not of a test file that
    imports JAX). On ``device="cuda"`` rank r uses card r mod the card
    count. The group meets through a file store in a fresh temporary
    directory, so no port is taken and parallel runs cannot collide. If a
    rank raises, the others are stopped and the error is raised here.

    ``args`` reach the ranks through a file in that directory, not with
    the start: a child reads its start only after importing the parent's
    main module, so a start larger than a pipe holds the next child's
    until then, and the ranks would start one after another."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        torch.save(args, os.path.join(tmp, "args.pt"))
        torch.multiprocessing.start_processes(
            _rank_main, nprocs=world, join=True, start_method="spawn",
            args=(fn, world, backend, device, os.path.join(tmp, "store"),
                  tmp))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
