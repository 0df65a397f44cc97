"""Production mesh definitions for H100 clusters.

The port of the reference's ``repro.launch.mesh``.  Every mesh is built by
a FUNCTION (never a module-level constant), so importing this module
touches no process-group or device state.

Topology: hosts of 8 H100s joined by NVLink (the ``model`` axis, 450 GB/s
each way a card), hosts joined by InfiniBand (``data`` and ``pod``).  The
single production mesh is 256 cards as ``("data", "model") = (32, 8)``;
the multi-pod one 512 as ``("pod", "data", "model") = (2, 32, 8)``.  The
dry run has one process, so a production mesh lives on a ``fake`` process
group of the mesh's world size (``torch.testing``'s ``FakeStore``): its
collectives move nothing and cost nothing, and a tracer sees them.  The
group is created by the function that needs it, and created anew when a
mesh of another size follows.  Its meshes have device type ``cpu``; the
tensors on them are fake (:mod:`repro_torch.launch.dryrun`).

:func:`make_host_mesh` covers the cards there are on one host: a real
process group of world size 1 (NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import os
import tempfile

SINGLE = ("single_pod_32x8", (32, 8), ("data", "model"))
MULTI = ("multi_pod_2x32x8", (2, 32, 8), ("pod", "data", "model"))


def _fresh_group(backend: str, world_size: int, **kw) -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        if (dist.get_backend() == backend
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group(backend, rank=0, world_size=world_size, **kw)


def fake_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over a ``fake`` process group whose
    world is the mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 1
    for n in shape:
        world *= n
    _fresh_group("fake", world, store=FakeStore())
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    _, shape, names = MULTI if multi_pod else SINGLE
    return fake_mesh(shape, names)


def mesh_name(*, multi_pod: bool = False) -> str:
    return (MULTI if multi_pod else SINGLE)[0]


def make_host_mesh(model: int = 1, *, device=None):
    """A ``(1, 1)`` ``("data", "model")`` mesh on a real process group of
    world size 1: one process drives one card (``device=None``), or the
    CPU (``device="cpu"``, gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import resolve_device

    if model != 1:
        raise ValueError(f"one process drives one card; model={model}")
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    path = os.path.join(tempfile.mkdtemp(prefix="host_mesh_"), "rendezvous")
    _fresh_group(backend, 1, init_method=f"file://{path}")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))


def chips(mesh) -> int:
    return int(mesh.size())


def sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of ``mesh``."""
    return {n: int(mesh.size(i)) for i, n in enumerate(mesh.mesh_dim_names)}


__all__ = ["MULTI", "SINGLE", "chips", "fake_mesh", "make_host_mesh",
           "make_production_mesh", "mesh_name", "sizes"]
