"""Client sharding for the simulator's sharded engine: which clients each
rank holds (:mod:`.rules`) and the ``"clients"`` process group
(:mod:`.group`)."""
from repro_torch.sharding.group import (ClientGroup, client_group,
                                        default_backend, spawn)
from repro_torch.sharding.rules import client_slab, join_slabs, take_slab

__all__ = ["ClientGroup", "client_group", "client_slab", "default_backend",
           "join_slabs", "spawn", "take_slab"]
