"""Production meshes: the reference's ``launch/mesh.py`` as device-free
descriptions.

The reference builds a ``jax.sharding.Mesh`` over 256 or 512 TPU chips:
``("data", "model")`` within a pod, and a leading ``"pod"`` axis that is
also the pFedWN FL-client axis. The port keeps the geometry as a
:class:`MeshSpec` (axis names and sizes, no devices), from which the
sharding rules (:mod:`repro_torch.sharding.rules`) read the axis sizes
and :func:`pod_group` binds ``"pod"`` to a process group.

What each axis places in the port:
  - ``"pod"``: one FL client a rank of a started ``torch.distributed``
    group, the world or its first C ranks, as
    :func:`repro_torch.sharding.client_group` binds ``"clients"``
    (``launch/steps.py::make_pfedwn_round_step``);
  - ``"data"`` and ``"model"``: one client over a mesh of D x T ranks
    (:func:`repro_torch.sharding.place.make_placement`), each rank holding
    its block of every param, batch and cache leaf by the rules' specs
    (``sharding/place.py``); the dense and MoE families' train step,
    prefill and decode run on the blocks, the batch over ``"data"``,
    heads, d_ff and experts over ``"model"``, the MoE routing group-local
    over ``"data"`` (``sharding/tensor_parallel.py``, the step builders'
    ``placement``). The MLA, SSM, hybrid and stub-prefix families'
    compute, and a pod's client placed within the multi-pod round step,
    come later (ROADMAP D1c, D1d).

Building a spec touches no device and no process state, as in the
reference, where the meshes are functions so that importing the module
does not.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch.distributed as dist

from repro_torch.sharding.group import ClientGroup, client_group


@dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and sizes, in order."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{len(self.shape)}-d mesh")

    def axis_sizes(self) -> Dict[str, int]:
        """{axis name: size}, the reference's ``compat.mesh_axis_sizes``."""
        return dict(zip(self.axis_names, self.shape))


def _mesh(multi_pod: bool, side: int) -> MeshSpec:
    shape = (2, side, side) if multi_pod else (side, side)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(axes, shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """Single pod: (16, 16) ``("data", "model")``, 256 chips. Multi-pod:
    (2, 16, 16) ``("pod", "data", "model")``, 512 chips; the ``"pod"``
    axis doubles as the pFedWN FL-client axis."""
    return _mesh(multi_pod, 16)


def make_debug_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The small mesh of the reference's CI on 8 host devices: (2, 2), or
    (2, 2, 2) with the ``"pod"`` axis."""
    return _mesh(multi_pod, 2)


def pod_group(mesh: MeshSpec, group=None) -> ClientGroup:
    """The process group the mesh's ``"pod"`` axis binds to: ``group``,
    else the first C ranks of the started default group
    (:func:`~repro_torch.sharding.client_group`), C the axis's size, one
    client a rank. Raises ValueError when the mesh has no ``"pod"`` axis
    or the group's size is not C."""
    sizes = mesh.axis_sizes()
    if "pod" not in sizes:
        raise ValueError(f"mesh {mesh.axis_names} has no 'pod' axis")
    c = sizes["pod"]
    if group is None:
        return client_group(c, c)
    d = dist.get_world_size(group)
    if d != c:
        raise ValueError(f"the mesh's 'pod' axis has {c} clients, the "
                         f"group {d} ranks")
    return ClientGroup(group, d, 1, dist.get_rank(group))

