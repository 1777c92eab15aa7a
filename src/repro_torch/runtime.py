"""Ambient runtime context: the active device mesh (the JAX package's
``repro.runtime``).

Model code (the MoE layer's explicit collective schedule, the FSDP
gathers and the sharding constraints of ``models.transformer``) consults
:func:`get_mesh`.  Smoke tests and single-device runs leave it unset and
take the local math path: the same semantics, no collectives.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` (``jax.sharding.Mesh`` in the JAX package), built by
``repro_torch.launch.mesh``.  :func:`shard_map` stands in for
``jax.shard_map``: ``torch.distributed.tensor.experimental.local_map``,
whose body sees each rank's local tensors and runs explicit collectives.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

_state = threading.local()


def get_mesh():
    """The active ``DeviceMesh``, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh.  While one is active, plain tensors
    meeting DTensors act as replicated operands (``implicit_replication``):
    the tables a forward builds (positions, masks, rotary factors), and the
    saved masks its backward reads.  The switch is entered once, by the
    outermost ``use_mesh`` that names a mesh."""
    prev = get_mesh()
    _state.mesh = mesh
    try:
        if mesh is not None and prev is None:
            from torch.distributed.tensor.experimental import \
                implicit_replication

            with implicit_replication():
                yield mesh
        else:
            yield mesh
    finally:
        _state.mesh = prev


def opt_barrier(x):
    """The identity.  ``jax.lax.optimization_barrier`` pins XLA's op order
    and dtypes across a collective (it keeps a convert from being hoisted
    past a gather or a ``psum``); eager torch runs the ops in the order and
    the dtypes the code states and reorders nothing, so there is nothing to
    pin."""
    return x


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object with the
    JAX mesh's ``axis_names`` and ``shape``, as the tests' fake mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return {a: int(mesh.shape[a]) for a in mesh.axis_names}
    return dict(zip(names, (int(s) for s in mesh.shape)))


def shard_map(f, *, mesh, in_specs, out_specs, in_grad_specs=None):
    """``jax.shard_map`` as ``local_map``: ``f`` runs on each rank's local
    tensors.  ``in_specs`` holds one spec per positional argument (a
    ``sharding.P``); the DTensor arguments are redistributed to it first.
    ``out_specs`` is the spec of ``f``'s one tensor result.
    ``in_grad_specs`` names, per argument, the mesh axes over which the
    gradient the body's backward yields is a part of a sum (a weight that
    every rank of the axis uses on rows of its own): the argument's
    gradient takes ``Partial`` there, and its own placement elsewhere."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding import placements

    in_pl = tuple(placements(s, mesh) for s in in_specs)
    grad_pl = None if in_grad_specs is None else tuple(
        placements(s, mesh, partial=p) for s, p in
        zip(in_specs, in_grad_specs))
    # a list: local_map reads a tuple as one placement list per output
    return local_map(f, out_placements=list(placements(out_specs, mesh)),
                     in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)


def data_axes(mesh=None) -> tuple[str, ...]:
    """The batch/FSDP axes present in the mesh ('pod' first when multi-pod)."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return ()
    names = tuple(mesh_axes(mesh))
    return tuple(a for a in ("pod", "data") if a in names)


class _PsumReplicated(torch.autograd.Function):
    """All-reduce (sum) whose backward is the identity: for a sum that
    every rank of the axis then uses alike (a replicated output), the
    gradient arriving on each rank is already the whole gradient of the
    sum, which is each part's."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x, mesh, axis: str):
    """``jax.lax.psum`` over one mesh axis of a sum used alike on every
    rank of the axis (the identity backward of ``_PsumReplicated``)."""
    return _PsumReplicated.apply(x, mesh.get_group(axis))


def psum_local_use(x, mesh, axis: str):
    """All-reduce (sum) over one mesh axis of a sum that each rank then
    uses on its own part of the work: its backward sums the ranks'
    gradients (``torch.distributed.nn.functional.all_reduce``)."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=mesh.get_group(axis))
