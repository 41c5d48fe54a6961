"""Production meshes (the port's copy of ``repro/launch/mesh.py``).

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the 'pod' axis is pure
data parallelism over the inter-pod network -- only gradient all-reduces
cross it, optionally int8-compressed (dist/compression.py).

Functions, not module-level constants: they need an initialized process
group of the mesh's size (``torch.distributed.init_process_group``) and
never create one, so importing this module touches no device and no
network (the dry run makes a ``fake`` group of 256 or 512 ranks first).
"""
from __future__ import annotations

import socket

from repro_torch.dist.compat import init_device_mesh
from repro_torch.dist.sharding import Parallel


def local_init_method() -> str:
    """An ``init_method`` for a process group on this host:
    ``tcp://127.0.0.1:<port>`` at a port that was free when asked."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_parallel(*, multi_pod: bool = False,
                  device_type: str = "cuda") -> Parallel:
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    data_axes = ("pod", "data") if multi_pod else ("data",)
    return Parallel(mesh=mesh, data_axes=data_axes, model_axis="model")


def make_local_parallel(data: int = 2, model: int = 4,
                        device_type: str = "cuda") -> Parallel:
    """A small (data, model) mesh over the ranks of the process group
    (tests, the launcher's ``--mesh``; ``device_type="cpu"`` over gloo)."""
    mesh = init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
    return Parallel(mesh=mesh, data_axes=("data",), model_axis="model")
