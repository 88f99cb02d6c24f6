"""Client sharding for the simulator's sharded engine: which clients each
rank holds (:mod:`.rules`) and the ``"clients"`` process group
(:mod:`.group`); the language models' layouts on a mesh (:mod:`.rules`'
LM half), each rank's blocks of them (:mod:`.place`) and the dense
family's steps on the blocks (:mod:`.tensor_parallel`)."""
from repro_torch.sharding.group import (ClientGroup, client_group,
                                        default_backend, spawn)
from repro_torch.sharding.place import (Placement, make_placement,
                                        unshard_tree)
from repro_torch.sharding.rules import (batch_spec, cache_shardings,
                                        client_slab, join_slabs,
                                        param_shardings, spec_for_param,
                                        take_slab)

__all__ = ["ClientGroup", "Placement", "batch_spec", "cache_shardings",
           "client_group", "client_slab", "default_backend", "join_slabs",
           "make_placement", "param_shardings", "spawn", "spec_for_param",
           "take_slab", "unshard_tree"]
