"""Mesh construction on ``torch.distributed``.

Counterpart of ``repro.launch.mesh``. ``make_mesh`` builds a ``DeviceMesh``
over the default process group, one process per device: every process
calls it, after ``torch.distributed.init_process_group``. The production
shapes are functions, never module-level state, so importing this module
touches no device or process group; ``production_mesh_shape`` describes
them without any process (for the rule table and the dry-run).
"""
from __future__ import annotations

from ..runtime.sharding import MeshShape


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The reference's pod mesh: 16x16 = 256 devices; 2 pods = 512."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(shape.shape, shape.axis_names, device_type=device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group
    (``device_type`` "cpu" for a gloo group)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
