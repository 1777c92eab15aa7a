"""Mesh construction (the JAX package's ``repro.launch.mesh``).

A ``jax.sharding.Mesh`` becomes a ``torch.distributed.device_mesh.
DeviceMesh`` with ``mesh_dim_names``, over the ranks of the initialised
default process group (one process a device; JAX's one controller holds
every device of a host, torch's one rank holds one).  Nothing here runs at
import: a mesh needs the process group first.

The mesh's device type is the package's device (``ops.get_device()``):
``cuda`` unless ``ops.set_device("cpu")`` (the CPU tests, a gloo group).
"""
from __future__ import annotations

import math


def _device_type() -> str:
    from repro_torch.kernels import ops as kops

    return kops.check_device().type


def _mesh(shape: tuple, names: tuple):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks; the group has {n}")
    device_type = _device_type()
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The dry run's mesh: (data 16, model 16), or (pod 2, data 16, model
    16) with ``multi_pod``.  It needs a group of 256 or 512 ranks (torch's
    fake process group stands in for them)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh over the group's ranks: the multi-rank tests'
    mesh and the card's one-rank mesh.  The group must hold exactly
    ``data * model`` ranks."""
    return _mesh((data, model), ("data", "model"))
