"""Meshes for the port, the JAX package's ``launch/mesh.py`` over
``torch.distributed``.

The reference targets TPU v5e pods: a (16, 16) ``("data", "model")`` mesh of
256 chips, and a multi-pod (2, 16, 16) ``("pod", "data", "model")`` mesh of
512.  The port keeps those shapes, axis names and chip counts, so that every
sharding spec it computes compares with the JAX package's.  On H100s a
16-wide ``model`` axis spans two 8-GPU NVLink nodes: its collectives cross
InfiniBand (``roofline/hw.py``).

Meshes are built by functions, so importing this module touches no process
group.  ``make_production_mesh`` and ``make_host_mesh`` build a
``DeviceMesh`` over the process group that is live; the dry run makes that
group a fake one of 256 or 512 ranks in one process
(``init_fake_process_group``), which stands in for the reference's 512
placeholder XLA devices.  The fake group lives in ``torch.testing._internal``
and is imported here only.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class AbstractMesh:
    """A device-free mesh record: ``shape`` maps each axis name to its size,
    in order, as the reference's ``AbstractMesh.shape`` does."""
    shape: dict
    axis_names: tuple


def make_abstract_mesh(shape, axis_names) -> AbstractMesh:
    return AbstractMesh(dict(zip(axis_names, shape)), tuple(axis_names))


def as_abstract(mesh) -> AbstractMesh:
    """The axis record of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return make_abstract_mesh(tuple(mesh.shape), mesh.mesh_dim_names)


def production_shape(multi_pod: bool) -> tuple[tuple, tuple]:
    """(sizes, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def init_fake_process_group(world_size: int) -> None:
    """Make the live process group a fake one of ``world_size`` ranks in
    this process (rank 0): its collectives move nothing, and DTensor traces
    on it as on a real group.  A fake group of another size is replaced; a
    real group is refused."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:                     # pragma: no cover
        raise RuntimeError(
            "this torch has no fake process group (torch.testing._internal."
            "distributed.fake_pg); the dry run needs one") from e
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group is live; the dry run "
                f"runs in a process of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _device_mesh(device: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a live process group: call "
                           "torch.distributed.init_process_group first")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The (16, 16) or (2, 16, 16) ``DeviceMesh`` over the live group (256 or
    512 ranks); the dry run passes ``device="cpu"`` on its fake group."""
    shape, axes = production_shape(multi_pod)
    return _device_mesh(device, shape, axes)


def make_host_mesh(model_parallel: int = 1, device: str = "cuda"):
    """A ``("data", "model")`` mesh over the ranks of the live group: world
    size 1 on one card.  Refuses to run without a card unless
    ``device="cpu"`` is passed."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA card; pass device='cpu' "
                           "to build the mesh on the CPU")
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a live process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    mp = max(1, min(model_parallel, n))
    return _device_mesh(device, (n // mp, mp), ("data", "model"))


def data_axes(mesh) -> tuple:
    """Axes that shard the batch: ('pod', 'data') on multi-pod meshes."""
    return tuple(a for a in as_abstract(mesh).axis_names
                 if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
