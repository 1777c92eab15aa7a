"""Logical-axis sharding resolution (the JAX package's ``repro.sharding``).

Param ``spec_*`` trees hold tuples of logical names per dim:

  - ``"model"`` — tensor-parallel candidate (heads / d_ff / vocab / experts).
  - ``"fsdp"``  — shard over the ("pod","data") axes when ``cfg.fsdp``.
  - ``"batch"`` — activation batch dims, always over ("pod","data").
  - ``"seq"``   — sequence-parallel candidate (KV-cache length) -> "model".
  - ``None``    — replicated dim.

:func:`resolve_tree` turns (shapes, logical specs) into concrete specs with
two safety rules applied per tensor, left-to-right over dims:

  1. a mesh axis may be claimed by at most one dim (first eligible wins —
     e.g. MoE weights ``("model","fsdp","model")``: the expert dim claims
     "model" when E divides it (kimi, 384/16), otherwise d_ff claims it
     (grok, 8 experts));
  2. a dim only claims an axis when its size divides the axis size product
     (no uneven sharding; 40-head archs fall back to replicated attention
     weights).

A resolved spec is a :class:`P`, the counterpart of JAX's
``PartitionSpec``: one entry per tensor dim (trailing ``None`` dropped),
each ``None``, a mesh axis name, or a tuple of names.  :func:`placements`
turns it into the DTensor placements over a ``DeviceMesh``, and
:class:`NamedSharding` pairs it with its mesh as JAX's ``NamedSharding``
does.  Resolution reads only the mesh's axis names and sizes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

LOGICAL_RULES = {
    "model": ("model",),
    "seq": ("model",),
    "fsdp": ("pod", "data"),
    "batch": ("pod", "data"),
}


class P(tuple):
    """A resolved spec (``jax.sharding.PartitionSpec``): a tuple, so it
    compares equal to the tuple of its entries, and a leaf type of its own
    in spec trees."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    """A logical spec leaf: a tuple of names and ``None``."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def _axes(mesh) -> dict:
    from repro_torch.runtime import mesh_axes

    return mesh_axes(mesh)


def _axes_for(logical, names, fsdp: bool):
    if logical is None:
        return None
    if logical == "fsdp" and not fsdp:
        return None
    cand = tuple(a for a in LOGICAL_RULES[logical] if a in names)
    return cand or None


def resolve_spec(shape, logical_spec, mesh, fsdp: bool) -> P:
    """Concrete spec for one tensor."""
    assert len(shape) == len(logical_spec), (shape, logical_spec)
    sizes = _axes(mesh)
    claimed: set[str] = set()
    out = []
    for size, logical in zip(shape, logical_spec):
        axes = _axes_for(logical, sizes, fsdp)
        if axes is None or any(a in claimed for a in axes):
            out.append(None)
            continue
        if size % math.prod(sizes[a] for a in axes) != 0:
            out.append(None)
            continue
        claimed.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def placements(spec, mesh, *, partial=()) -> tuple:
    """DTensor placements of a resolved spec over ``mesh``: mesh axis ``a``
    takes ``Shard(d)`` where dim ``d``'s entry names ``a``, ``Partial()``
    where ``a`` is in ``partial``, ``Replicate()`` otherwise.  A dim over
    ``("pod", "data")`` is sharded over both mesh axes, pod outer, as JAX
    orders the devices (``DeviceMesh`` shards a dim over several mesh axes
    in mesh order, and the meshes here list pod before data)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    owner = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                owner[a] = d
    out = []
    for a in _axes(mesh):
        if a in partial:
            out.append(Partial())
        elif a in owner:
            out.append(Shard(owner[a]))
        else:
            out.append(Replicate())
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def constrain(x, logical_spec, mesh=None, fsdp: bool = False):
    """``jax.lax.with_sharding_constraint`` against the ambient mesh: a
    DTensor ``x`` is redistributed to the spec its logical spec resolves
    to (with ``fsdp`` dims dropped unless ``fsdp``).  A plain tensor, or no
    mesh, leaves ``x`` as it is."""
    from repro_torch.runtime import get_mesh

    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = resolve_spec(tuple(x.shape), logical_spec, mesh, fsdp)
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor (every rank holding
    it alike) becomes a replicated one."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def stacked(spec_tree):
    """The logical specs of a stack of layers (a leading layer dim, never
    sharded) from one layer's."""
    if is_spec(spec_tree):
        return (None,) + spec_tree
    if isinstance(spec_tree, dict):
        return {k: stacked(v) for k, v in spec_tree.items()}
    return type(spec_tree)(stacked(v) for v in spec_tree)


def _shape(leaf) -> tuple:
    shape = getattr(leaf, "shape", None)
    if shape is None:  # a Python scalar
        return ()
    return tuple(shape)


def _map_up_to(shapes_tree, specs_tree, fn):
    """Map ``fn(shape_leaf, spec_leaf)`` with specs taken *up to* the
    shapes tree's structure — logical spec tuples are themselves tuples, so
    a walk of both at once would mis-recurse into them.  Dict keys are
    walked sorted, as ``jax.tree_util`` walks them; the result keeps the
    shapes tree's structure."""
    if isinstance(shapes_tree, dict):
        return {k: _map_up_to(shapes_tree[k], specs_tree[k], fn)
                for k in sorted(shapes_tree)}
    if isinstance(shapes_tree, (list, tuple)):
        if len(shapes_tree) != len(specs_tree):
            raise ValueError(f"spec tree {specs_tree!r} does not match a "
                             f"node of {len(shapes_tree)} children")
        return type(shapes_tree)(_map_up_to(s, p, fn)
                                 for s, p in zip(shapes_tree, specs_tree))
    if shapes_tree is None:
        return None
    return fn(shapes_tree, specs_tree)


def resolve_tree(shapes_tree, specs_tree, mesh, fsdp: bool):
    """shapes_tree: tree of tensors or shape-carrying leaves; specs_tree:
    matching tree of logical tuples.  Returns a tree of NamedSharding."""
    return _map_up_to(
        shapes_tree, specs_tree,
        lambda sh, sp: NamedSharding(mesh, resolve_spec(_shape(sh), sp, mesh,
                                                        fsdp)))


def pspec_tree(shapes_tree, specs_tree, mesh, fsdp: bool):
    """Same as resolve_tree but returns raw specs."""
    return _map_up_to(
        shapes_tree, specs_tree,
        lambda sh, sp: resolve_spec(_shape(sh), sp, mesh, fsdp))


def distribute_tree(tree, shardings):
    """Carry a state onto its mesh: each tensor or numpy leaf becomes a
    DTensor with its sharding's placements, this rank holding its local
    shard (cut from the whole leaf, which every rank must hold alike;
    ``jax.device_put`` with a ``NamedSharding``).  Leaves land on the mesh's
    device type; ``steps.state_from_numpy`` first takes the JAX package's
    numpy state to tensors."""
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor

    def one(leaf, sh):
        if isinstance(leaf, np.ndarray):
            from repro_torch.train.steps import state_from_numpy

            leaf = state_from_numpy(leaf, device="cpu")
        t = torch.as_tensor(leaf)
        return distribute_tensor(t.detach(), sh.mesh, sh.placements,
                                 src_data_rank=None)

    return _map_up_to(tree, shardings, one)
