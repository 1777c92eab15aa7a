"""Host half of L1 capture for trees of tensors.

A state is a tree of nested dicts, lists and tuples whose leaves are
tensors (on any device), numpy arrays or Python scalars.  The walk visits
dict keys in sorted order and names each leaf by its path joined with "/"
("params/blocks/0/ffn/w_up"), exactly as ``jax.tree_util`` walks and the
JAX package names the same tree — so both packages write the same regions
in the same order and either one restores the other's checkpoints.

  - :func:`snapshot_device` is the standalone L1 capture: a clone of every
    leaf in device memory, issued on the caller's current stream, plus an
    event recorded after the clones.  It is the only work that blocks the
    application in async mode.
  - :func:`iter_host_regions` is the device-to-host stage the ActiveBackend
    drains: it copies each leaf of a snapshot to the host as one VELOC
    region on a copy stream of its own, which first waits on the snapshot's
    events — so the copies neither wait for nor hold up the work the
    application queues on its stream after the snapshot.
  - :func:`tree_from_regions` rebuilds a tree on restart, each leaf on the
    device and with the dtype of the matching template leaf.

Device-side dirty tracking (the JAX package's ``DeviceDeltaCapture``) is
not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core.format import Region, host_array


@dataclass
class DeviceSnapshot:
    """A cloned tree and, per CUDA device, the event recorded on the
    caller's stream after the clones were issued."""

    tree: Any
    events: dict = field(default_factory=dict)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _walk(tree, path=()):
    """``(path, leaf)`` pairs in ``jax.tree_util`` order: dict keys sorted,
    list and tuple items by index, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    elif tree is not None:
        yield path, tree


def map_tree(fn, tree, path=()):
    """Rebuild ``tree`` with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def leaves_with_paths(tree) -> list[tuple[str, Any]]:
    """``[(path name, leaf)]`` in checkpoint order."""
    return [(_path_str(p), leaf) for p, leaf in _walk(tree)]


def snapshot_device(state) -> DeviceSnapshot:
    """Explicit device-side copy of a tree (standalone L1 capture).

    Clones run on the caller's current stream, so they are ordered before
    any later in-place update the caller makes there; the backend's copy
    stream waits on the recorded events instead of synchronizing."""
    devices = set()

    def clone(_, x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
            return x.detach().clone()
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    tree = map_tree(clone, state)
    events = {}
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events[dev] = ev
    return DeviceSnapshot(tree, events)


def iter_host_regions(snap, *, rank_prefix: str = "") -> Iterator[Region]:
    """Yield one Region per leaf, copied to the host.  ``snap`` is a
    ``DeviceSnapshot`` or a plain tree (the caller's own capture, copied on
    the current stream, after whatever the caller queued there)."""
    streams = {}
    if isinstance(snap, DeviceSnapshot):
        for dev, ev in snap.events.items():
            streams[dev] = torch.cuda.Stream(device=dev)
            streams[dev].wait_event(ev)
        snap = snap.tree
    for path, leaf in _walk(snap):
        stream = streams.get(getattr(leaf, "device", None))
        if stream is None:
            arr, dtype = host_array(leaf)
        else:
            # a blocking copy: the leaf is on the host when this returns
            with torch.cuda.stream(stream):
                arr, dtype = host_array(leaf)
        yield Region(name=rank_prefix + _path_str(path), array=arr,
                     global_shape=tuple(np.shape(leaf)), dtype=dtype)


def host_state_bytes(snap) -> int:
    if isinstance(snap, DeviceSnapshot):
        snap = snap.tree
    total = 0
    for _, leaf in _walk(snap):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "dtype"):
            total += leaf.size * leaf.dtype.itemsize
    return total


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    if str(dtype) == "bfloat16":  # an ml_dtypes template leaf
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _as_tensor(arr) -> torch.Tensor:
    """A region as read by ``ShardReader``: numpy, or a bf16 tensor."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.asarray(arr))


def _assemble(name: str, shape, regions: dict):
    """Reassemble a leaf from per-shard pieces ("name@start0,start1,...")."""
    prefix = name + "@"
    pieces = {k: _as_tensor(v) for k, v in regions.items()
              if k.startswith(prefix)}
    if not pieces:
        raise KeyError(f"region {name!r} missing from checkpoint")
    first = pieces[next(iter(pieces))]
    out = torch.zeros(tuple(shape), dtype=first.dtype)
    for k, piece in pieces.items():
        suffix = k[len(prefix):]
        starts = tuple(int(s) for s in suffix.split(",")) if suffix else ()
        sl = tuple(slice(s, s + d) for s, d in zip(starts, piece.shape))
        out[sl] = piece
    return out


def tree_from_regions(template, regions: dict, shardings=None):
    """Rebuild a tree from {path: array}: each leaf takes the shape, dtype
    and device of the matching template leaf (a numpy or scalar template
    leaf gives a CPU tensor)."""
    if shardings is not None:
        raise NotImplementedError(
            "sharded restore is not ported yet (ROADMAP.md queue 1, item 10)")

    def build(path, leaf):
        name = _path_str(path)
        if isinstance(leaf, torch.Tensor):
            shape, dtype, device = leaf.shape, leaf.dtype, leaf.device
        else:
            a = np.asarray(leaf)
            shape, dtype, device = a.shape, _torch_dtype(a.dtype), "cpu"
        if name in regions:
            t = _as_tensor(regions[name])
        else:
            t = _assemble(name, shape, regions)
        # always a copy: a region read from a shard aliases the shard's
        # immutable bytes
        return t.reshape(shape).to(device=device, dtype=dtype, copy=True)

    return map_tree(build, template)
