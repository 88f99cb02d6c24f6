"""Client sharding for the simulator's sharded engine: which clients each
rank holds (:mod:`.rules`) and the ``"clients"`` process group
(:mod:`.group`); and the language models' layouts on a mesh
(:mod:`.rules`' LM half)."""
from repro_torch.sharding.group import (ClientGroup, client_group,
                                        default_backend, spawn)
from repro_torch.sharding.rules import (batch_spec, cache_shardings,
                                        client_slab, join_slabs,
                                        param_shardings, spec_for_param,
                                        take_slab)

__all__ = ["ClientGroup", "batch_spec", "cache_shardings", "client_group",
           "client_slab", "default_backend", "join_slabs", "param_shardings",
           "spawn", "spec_for_param", "take_slab"]
