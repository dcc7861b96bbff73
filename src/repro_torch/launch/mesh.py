"""Production and debug meshes over ``torch.distributed``. Functions, not
module constants, so importing this module touches no process group.

Twin of ``src/repro/launch/mesh.py``: each returns a ``DeviceMesh`` with
the canonical axis names of ``distributed.sharding.MESH_AXES``. The
caller has initialised the default process group with as many ranks as
the mesh has devices (``init_process_group``); ``device_type="cpu"``
builds a mesh of CPU ranks (the gloo tests).
"""

from __future__ import annotations


def _mesh(shape, names, device_type):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """16x16 = 256 devices per pod; multi_pod adds the 2-pod axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, device_type="cuda"):
    """A small (data, model) mesh over the default group's ranks."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
