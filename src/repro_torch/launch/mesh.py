"""Production mesh builders.

Functions, not module-level constants: importing this module touches no
process group.  The caller brings the process group (``torch.distributed``
initialised with as many ranks as the mesh has devices: gloo ranks, a fake
group for the dry run, or NCCL ranks on the cards).  Port of the
reference's ``launch/mesh.py`` onto ``init_device_mesh``.
"""
from __future__ import annotations


def _mesh(shape: tuple, names: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 2, model: int = 4, *, pod: int = 0,
                    device_type: str = "cuda"):
    """Small mesh for tests and one-card runs (``data * model`` ranks, times
    ``pod`` if given)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)
