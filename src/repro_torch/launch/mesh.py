"""Device meshes: the production meshes (16x16 single-pod, 2x16x16
multi-pod), arbitrary ones for tests, and the elastic mesh.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, one rank a device. This differs from JAX,
where one controller process a host drives every local device: a
multi-card run of the port is one process a card (``torchrun``, or one
process a card each given its rank, the world size and a ``tcp://``
address), every process builds the same mesh, and ``elastic_mesh`` sizes
it from ``dist.get_world_size()``.

``make_mesh`` needs a process group of at least the mesh's size. With
none initialised and a mesh of one device it makes its own: a world of 1
on an in-memory store (NCCL on the card, gloo on the CPU), so one card
needs no launcher and reads no environment variable. A larger mesh
without a group that large raises, naming the ranks it needs. The dry-run
(``launch/dryrun.py``) builds its 256- and 512-rank meshes on a fake
process group in one process.

Functions, not module constants: importing this module touches no
device and no process group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _device_type(device):
    from repro_torch import resolve_device
    return resolve_device(device).type


def init_world_one(device_type: str):
    """A process group of one rank on an in-memory store (NCCL for
    ``"cuda"``, gloo otherwise); a no-op when one exists."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _mk(shape, axes, device=None):
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    dtype = _device_type(device)
    if not dist.is_initialized() and n == 1:
        init_world_one(dtype)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} ranks, have {world}: start one "
            "process a device with torch.distributed initialised "
            f"(world size {n}), or use launch/dryrun.py's fake process "
            "group for a device-free trace")
    return DeviceMesh(dtype, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def production_shape(*, multi_pod: bool = False):
    """(shape, axis names) of a production mesh: 16x16 (data, model) on
    one pod, 2x16x16 (pod, data, model) over two."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    return _mk(*production_shape(multi_pod=multi_pod), device)


def make_mesh(shape, axes, device=None):
    """An arbitrary mesh (tests, one card, elastic scaling)."""
    return _mk(tuple(shape), tuple(axes), device)


def elastic_mesh(*, model_parallel: int = 16, device=None):
    """A mesh over every rank of the world: the model axis
    gcd(``model_parallel``, world), the rest data-parallel."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    mp = math.gcd(model_parallel, n)
    return _mk((n // mp, mp), ("data", "model"), device)


def destroy():
    """Tear down the default process group (and every mesh on it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
