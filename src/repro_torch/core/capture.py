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
    device and with the dtype of the matching template leaf, or as a
    DTensor on its sharding's mesh.

  - :class:`DeviceDeltaCapture` is device-side dirty tracking: it keeps
    each leaf's block fingerprints in device memory across checkpoints, so
    dirty detection is one fused fingerprint-diff kernel and only the dirty
    chunks, packed by the gather kernel, are copied to the host.  Its work
    runs on a capture stream of its own that waits on the snapshot's events,
    like the copy stream above.

Sharded leaves (DTensors, one process a rank) follow the JAX package's
"every host writes its own shard" rule: a leaf whose local shard is
smaller than the leaf yields one region for this rank's shard, named
``name@s0,s1,...`` after the shard's global starts; a leaf whose local
shard is the whole leaf (replicated, or a one-rank mesh) keeps its plain
name.  Device-delta capture takes only such whole leaves, as in JAX.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import concurrency
from repro_torch.sharding import is_dtensor
from repro_torch.core import delta as dlt
from repro_torch.core.format import Region, dtype_name, host_array
from repro_torch.kernels import ops as kops


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


def _local_box(shape, mesh, placements):
    """(local shape, global starts) of this rank's shard of a leaf."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    local, starts = compute_local_shape_and_global_offset(
        tuple(shape), mesh, tuple(placements))
    return tuple(int(n) for n in local), tuple(int(o) for o in starts)


def _local_leaf(leaf):
    """A leaf as this rank holds it: ``(tensor, starts)``, ``starts`` None
    when the tensor is the whole leaf."""
    if not is_dtensor(leaf):
        return leaf, None
    local = leaf.to_local()
    if tuple(local.shape) == tuple(leaf.shape):
        return local, None
    _, starts = _local_box(leaf.shape, leaf.device_mesh, leaf.placements)
    return local, starts


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


# ---------------------------------------------------------------------------
# device-side dirty tracking (fused fingerprint-diff-gather capture)
# ---------------------------------------------------------------------------


@dataclass
class DevicePlan:
    """One region's device-side diff plan.  The words and the new
    fingerprints stay in device memory until the pipeline's dirty-ratio
    decision picks ``gather`` (ship only dirty chunks) or ``materialize``
    (ship it all)."""

    key: tuple              # (stream, region name) — capture state key
    leaf: Any               # the device tensor
    words: Any              # flat int32 words of the leaf, on its device
    new_fp: Any             # (rows, 2) int32 fingerprints, on the device
    n_words: int
    rows: int               # chunk count (== DeltaPatch.n_chunks)
    nbytes: int
    chunk_bytes: int
    dtype: str              # on-disk dtype name ("float32", "bfloat16")
    dirty_idx: np.ndarray   # (n_dirty,) int64 sorted ascending
    dirty_bytes: int        # exact bytes a delta of this plan would carry
    full: bool              # first version / shape change / forced full


class DeviceDeltaCapture:
    """Dirty tracking in device memory across checkpoints (the fused
    fingerprint-diff-gather capture path).

    Holds each protected leaf's previous block fingerprints ON THE DEVICE,
    so a checkpoint's dirty detection is one fused kernel pass (hash +
    compare, no fingerprint ever reaches the host) followed by a gather
    kernel that packs the dirty chunks contiguously — the device-to-host
    copy then moves ``dirty_ratio * bytes``, not ``bytes``.  Fingerprints
    are keyed by (stream, region name) and invalidated on any shape/dtype
    change (elastic restart), which falls back to a full transfer + fresh
    fingerprints — never a wrong diff.

    Ordering: on a CUDA device every step runs on the capture's own stream.
    ``iter_host_regions`` makes that stream wait on the snapshot's event
    before it yields a region, so the hash never reads a clone before the
    clone is written, and ``plan`` records the leaf on the stream, so the
    allocator does not hand its memory to the application while the
    capture still reads it.  The fingerprints kept across versions are made
    and read on the same stream.

    Thread safety: ``plan`` / ``gather`` / ``materialize`` / ``commit`` for
    one stream must run under DeltaModule's per-stream lock (two racing
    versions of a stream must not diff against the same fingerprints — the
    same contract as the host tracker).  The state dict and the transfer
    counters get their own leaf guard because several streams may share one
    capture.

    ``stats`` counts the bytes this capture actually copies device→host
    (mask + fingerprints + checksum tables + gathered or materialized
    payloads).  With the package's device set to "cpu" the plain versions
    run and "device to host" is a copy in memory, but the counters count the
    same transfers a CUDA device makes."""

    def __init__(self, chunk_bytes: int = dlt.DEFAULT_CHUNK_BYTES):
        self.chunk_bytes = int(chunk_bytes)
        self._fps: dict[tuple, Any] = {}     # key -> device fingerprints
        self._meta: dict[tuple, tuple] = {}  # key -> (shape, dtype)
        self._streams: dict = {}             # CUDA device -> capture stream
        self._guard = concurrency.TrackedLock(
            "capture._guard", concurrency.RANK_GUARD)
        self.stats = {"planned": 0, "gathered": 0, "materialized": 0,
                      "fresh_full": 0, "d2h_bytes": 0,
                      "d2h_gather_bytes": 0, "d2h_full_bytes": 0}

    def _count(self, **deltas):
        with self._guard:
            for k, v in deltas.items():
                self.stats[k] += int(v)

    # -- streams ---------------------------------------------------------
    def stream(self, device) -> Optional["torch.cuda.Stream"]:
        """The capture stream of a CUDA device (None for the CPU)."""
        device = torch.device(device)
        if device.type != "cuda":
            return None
        with self._guard:
            s = self._streams.get(device)
            if s is None:
                s = self._streams[device] = torch.cuda.Stream(device=device)
            return s

    def wait_event(self, device, event):
        """Order the capture's later work on ``device`` after ``event``
        (the snapshot's clones)."""
        self.stream(device).wait_event(event)

    def _on_stream(self, tensor):
        s = self.stream(tensor.device)
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    # -- eligibility -----------------------------------------------------
    def eligible(self, leaf) -> bool:
        """Device path supported: a non-empty tensor on the package's device
        (``ops.get_device()``) whose element size is 1, 2 or 4 bytes, and
        not bool or complex.  Everything else — host numpy leaves, tensors
        elsewhere, other dtypes — keeps the host path."""
        if not isinstance(leaf, torch.Tensor):
            return False
        return leaf.device.type == kops.get_device().type \
            and leaf.numel() > 0 and leaf.element_size() in (1, 2, 4) \
            and leaf.dtype != torch.bool and not leaf.is_complex()

    # -- per-checkpoint protocol ----------------------------------------
    def plan(self, stream, name: str, leaf, *,
             force_full: bool = False) -> DevicePlan:
        """Fused fingerprint + diff of one region in device memory.  Only
        the chunk-sized dirty mask crosses to the host; the decision of
        whether the chunks follow is the caller's (dirty-ratio cutoff)."""
        key = (stream, name)
        meta = (tuple(leaf.shape), dtype_name(leaf.dtype))
        nbytes = leaf.numel() * leaf.element_size()
        with self._on_stream(leaf):
            if leaf.is_cuda:
                leaf.record_stream(torch.cuda.current_stream(leaf.device))
            words, n_words, rows = kops.device_words(leaf, self.chunk_bytes)
            with self._guard:
                prev = self._fps.get(key)
                fresh = prev is None or self._meta.get(key) != meta \
                    or tuple(prev.shape) != (rows, 2)
            if force_full or fresh:
                new_fp = kops.device_fingerprints(words,
                                                  self.chunk_bytes // 4)
                dirty_idx = np.arange(rows, dtype=np.int64)
                dirty_bytes = nbytes
            else:
                new_fp, mask_dev = kops.fingerprint_diff(
                    words, prev, self.chunk_bytes // 4)
                mask = mask_dev.cpu().numpy()
                self._count(d2h_bytes=mask.nbytes)
                dirty_idx = np.nonzero(mask[:rows, 0])[0].astype(np.int64)
                dirty_bytes = len(dirty_idx) * self.chunk_bytes
                if len(dirty_idx) and int(dirty_idx[-1]) == rows - 1:
                    # short tail chunk counts its real bytes
                    dirty_bytes += (nbytes - (rows - 1) * self.chunk_bytes) \
                        - self.chunk_bytes
        self._count(planned=1, fresh_full=int(fresh and not force_full))
        return DevicePlan(key=key, leaf=leaf, words=words, new_fp=new_fp,
                          n_words=n_words, rows=rows, nbytes=nbytes,
                          chunk_bytes=self.chunk_bytes, dtype=meta[1],
                          dirty_idx=dirty_idx, dirty_bytes=dirty_bytes,
                          full=bool(force_full or fresh))

    def host_fp(self, plan: DevicePlan) -> np.ndarray:
        """Host copy of the plan's new fingerprints (tracker state; a few
        bytes per chunk)."""
        with self._on_stream(plan.leaf):
            fp = plan.new_fp.cpu().numpy().view(np.uint32)
        self._count(d2h_bytes=fp.nbytes)
        return fp[:plan.rows]

    def gather(self, plan: DevicePlan) -> dlt.PrecomputedDiff:
        """Pack the plan's dirty chunks contiguously ON THE DEVICE, copy
        only them to the host, and emit the precomputed diff ``make_patch``
        packs verbatim.  Exactly the dirty chunks move: the JAX package pads
        the index vector to a power of two to bound jit retraces, which the
        port, without jit, does not need."""
        cb = plan.chunk_bytes
        k = int(len(plan.dirty_idx))
        with self._on_stream(plan.leaf):
            if k == 0:
                data: bytes = b""
                digests: list = []
            else:
                host = kops.gather_rows(plan.words, plan.dirty_idx,
                                        cb // 4).cpu().numpy()
                self._count(gathered=1, d2h_bytes=host.nbytes,
                            d2h_gather_bytes=host.nbytes)
                u8 = host.view(np.uint8).reshape(-1)
                tail = plan.nbytes - (plan.rows - 1) * cb
                views = [u8[t * cb:t * cb
                            + (cb if int(i) < plan.rows - 1 else tail)]
                         for t, i in enumerate(plan.dirty_idx)]
                digests = kops.chunk_digests(views)
                # dirty rows are already contiguous; only a short tail
                # (always last) needs trimming — one copy of the dirty
                # bytes, total.
                data = u8[:int(sum(v.shape[0] for v in views))].tobytes()
            # full-array digest WITHOUT the full array: checksum the device
            # words in place; only the (rows, 2) table reaches the host.
            table = kops.fletcher_chunks(plan.words)
        self._count(d2h_bytes=table.nbytes)
        # a 0-d leaf is stored with shape (1,), as np.ascontiguousarray
        # gives it to the full shard and the host patch; the JAX package's
        # device patch keeps shape (), which its own overlay then refuses
        return dlt.PrecomputedDiff(
            shape=tuple(plan.leaf.shape) or (1,), dtype=plan.dtype,
            nbytes=plan.nbytes, chunk_bytes=cb,
            indices=plan.dirty_idx, data=data, chunk_digests=digests,
            full_digest=kops.fold_digest(table, plan.n_words),
            fps=self.host_fp(plan))

    def materialize(self, plan: DevicePlan) -> np.ndarray:
        """Full device-to-host copy of the region (full checkpoint,
        mostly-dirty cutoff, or first version) — the honest fallback the
        counters keep visible.  A bfloat16 leaf comes back as its uint16
        bit patterns (``plan.dtype`` names it)."""
        with self._on_stream(plan.leaf):
            arr, _ = host_array(plan.leaf)
        self._count(materialized=1, d2h_bytes=arr.nbytes,
                    d2h_full_bytes=arr.nbytes)
        return arr

    def commit(self, plan: DevicePlan):
        """Adopt the plan's fingerprints as the leaf's device-resident
        state (call once the version's diff decision is final, under the
        same per-stream lock that planned it)."""
        with self._guard:
            self._fps[plan.key] = plan.new_fp
            self._meta[plan.key] = (tuple(plan.leaf.shape), plan.dtype)

    def invalidate(self, stream=None):
        """Drop device fingerprints (all streams, or one) — e.g. after an
        elastic restart re-shards the state."""
        with self._guard:
            if stream is None:
                self._fps.clear()
                self._meta.clear()
                return
            for key in [k for k in self._fps if k[0] == stream]:
                self._fps.pop(key, None)
                self._meta.pop(key, None)


def iter_host_regions(snap, *, rank_prefix: str = "",
                      device_delta: Optional[DeviceDeltaCapture] = None
                      ) -> Iterator[Region]:
    """Yield one Region per leaf, copied to the host.  ``snap`` is a
    ``DeviceSnapshot`` or a plain tree (the caller's own capture, copied on
    the current stream, after whatever the caller queued there).

    With ``device_delta``, the leaves the capture supports are yielded
    UNMATERIALIZED (``array=None`` with ``leaf``/``capture`` set): the delta
    module fingerprints and diffs them in device memory and only dirty
    chunks reach the host.  Before the first such region of a device, the
    capture's stream waits on the snapshot's event (or, for a plain tree,
    on the current stream).  Host leaves and unsupported dtypes keep the
    materializing host path."""
    streams = {}
    events = {}
    if isinstance(snap, DeviceSnapshot):
        events = dict(snap.events)
        for dev, ev in snap.events.items():
            streams[dev] = torch.cuda.Stream(device=dev)
            streams[dev].wait_event(ev)
        snap = snap.tree
    waited = set()
    for path, leaf in _walk(snap):
        name = rank_prefix + _path_str(path)
        global_shape = tuple(np.shape(leaf))
        leaf, starts = _local_leaf(leaf)
        if starts is not None:
            name += "@" + ",".join(str(o) for o in starts)
        if starts is None and device_delta is not None \
                and device_delta.eligible(leaf):
            if leaf.is_cuda and leaf.device not in waited:
                ev = events.get(leaf.device)
                if ev is None:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(leaf.device))
                device_delta.wait_event(leaf.device, ev)
                waited.add(leaf.device)
            yield Region(name=name, array=None, global_shape=global_shape,
                         leaf=leaf, capture=device_delta)
            continue
        stream = streams.get(getattr(leaf, "device", None))
        if stream is None:
            arr, dtype = host_array(leaf)
        else:
            # a blocking copy: the leaf is on the host when this returns
            with torch.cuda.stream(stream):
                arr, dtype = host_array(leaf)
        yield Region(name=name, array=arr, global_shape=global_shape,
                     dtype=dtype)


def host_state_bytes(snap) -> int:
    if isinstance(snap, DeviceSnapshot):
        snap = snap.tree
    total = 0
    for _, leaf in _walk(snap):
        leaf = _local_leaf(leaf)[0]
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


def _assemble(name: str, shape, regions: dict, box_starts=None):
    """Reassemble a leaf, or the box of it of ``shape`` at global
    ``box_starts``, from per-shard pieces ("name@start0,start1,..."):
    each piece fills where it overlaps the box."""
    prefix = name + "@"
    pieces = {k: _as_tensor(v) for k, v in regions.items()
              if k.startswith(prefix)}
    if not pieces:
        raise KeyError(f"region {name!r} missing from checkpoint")
    box = tuple(box_starts or (0,) * len(shape))
    first = pieces[next(iter(pieces))]
    out = torch.zeros(tuple(shape), dtype=first.dtype)
    covered = 0
    for k, piece in pieces.items():
        suffix = k[len(prefix):]
        starts = tuple(int(s) for s in suffix.split(",")) if suffix else ()
        lo = [max(s, b) for s, b in zip(starts, box)]
        hi = [min(s + d, b + n) for s, d, b, n in
              zip(starts, piece.shape, box, shape)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        dst = tuple(slice(a - b, c - b) for a, c, b in zip(lo, hi, box))
        src = tuple(slice(a - s, c - s) for a, c, s in zip(lo, hi, starts))
        out[dst] = piece[src]
        covered += math.prod(c - a for a, c in zip(lo, hi))
    if covered < math.prod(shape):
        raise KeyError(f"region {name!r}: the checkpoint's pieces cover "
                       f"{covered} of the {math.prod(shape)} values wanted")
    return out


def _sharded_leaf(name, shape, dtype, sh, regions):
    """This rank's shard of a leaf, from the whole leaf's region or the
    pieces that overlap it, as a DTensor with the sharding's placements
    (``jax.device_put`` with a ``NamedSharding``)."""
    from torch.distributed.tensor import DTensor

    mesh, pl = sh.mesh, sh.placements
    local_shape, starts = _local_box(shape, mesh, pl)
    if name in regions:
        t = _as_tensor(regions[name]).reshape(shape)
        t = t[tuple(slice(s, s + n) for s, n in zip(starts, local_shape))]
    else:
        t = _assemble(name, local_shape, regions, starts)
    device = mesh.device_type
    if device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    local = t.to(device=device, dtype=dtype, copy=True).contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def tree_from_regions(template, regions: dict, shardings=None):
    """Rebuild a tree from {path: array}: each leaf takes the shape, dtype
    and device of the matching template leaf (a numpy or scalar template
    leaf gives a CPU tensor; a ``meta`` tensor, a template that holds no
    memory as ``jax.eval_shape``'s does, lands on the package's device as
    a ``ShapeDtypeStruct`` leaf lands on JAX's default device).

    With ``shardings`` (a tree of ``sharding.NamedSharding`` matching the
    template, e.g. ``resolve_tree``'s), each leaf is a DTensor on its
    sharding's mesh with its placements, this rank holding its shard,
    rebuilt from the regions it wrote (its own shard, or the whole leaf)
    or from any pieces that cover it."""
    by_path = None if shardings is None else {
        _path_str(p): sh for p, sh in _walk(shardings)}

    def build(path, leaf):
        name = _path_str(path)
        if by_path is not None:
            shape = tuple(np.shape(leaf))
            dtype = leaf.dtype if isinstance(leaf, torch.Tensor) \
                else _torch_dtype(np.asarray(leaf).dtype)
            return _sharded_leaf(name, shape, dtype, by_path[name], regions)
        if isinstance(leaf, torch.Tensor):
            shape, dtype, device = leaf.shape, leaf.dtype, leaf.device
            if device.type == "meta":
                device = kops.check_device()
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
