"""Device-level L2: partner replication and distributed XOR parity across
the slots of the data axis, in device memory (the JAX package's
``repro.core.partner``).

In the JAX package both entry points are one ``shard_map`` over the mesh:
each device flattens its local shard blocks into a uint32 buffer and the
buffers move between devices by ``ppermute``.  ``encode_l2`` has two forms:

  - the mesh form, ``encode_l2(state, pspecs, mesh, ...)``: the same
    schedule over a ``DeviceMesh``, one process a rank, under
    ``runtime.shard_map`` (``local_map``); a ``ppermute`` is a
    ``permute_tensor`` over the axis' process group.  Each rank's output is
    the JAX mesh device's slice, and the whole is a DTensor sharded over
    every mesh axis, as JAX's ``P(all_axes)``.
  - the slot-list form, ``encode_l2(local, ...)``: one controller drives a
    list of slots, one local tree per slot along the data axis, each on its
    slot's device (on one card every slot is ``cuda:0``; in the CPU tests
    the slots are CPU tensors).  A ``ppermute`` is a move of each slot's
    buffer to its destination slot's device.  It is the single-process
    oracle of the mesh form.

  encode_l2(mode="partner") — every slot's buffer goes to the slot
      ``distance`` further along the ring (replication without stable
      storage).  Slot g ends up holding slot g - distance's buffer.

  encode_l2(mode="xor") — SCR/RAID-5 rotating XOR parity by a ring
      reduce-scatter with ``ops.xor_pair`` (the XOR-pair kernel) as the
      combiner.  Each slot's buffer is split into G-1 chunks assigned to
      the stripes that do NOT include that slot, so the parity a slot holds
      never covers its own data; after G-1 steps slot g holds the parity of
      stripe g.  Any one lost slot per group is rebuilt from the survivors
      and the parity (``xor_reconstruct_group``).

Buffers are int32 tensors holding the uint32 words, bit-identical to the
JAX package's, padding included.  Slots of unequal length are refused: a
``shard_map`` cannot express them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.capture import leaves_with_paths
from repro_torch.kernels import ops as kops

_PACK16 = (torch.bfloat16, torch.float16)


def _leaf_words(leaf: torch.Tensor) -> torch.Tensor:
    flat = leaf.detach().reshape(-1)
    if flat.dtype in (torch.float32, torch.int32, torch.uint32):
        return flat.view(torch.int32)
    if flat.dtype in _PACK16:
        # pairs packed low half first, an odd count padded with a zero half:
        # on a little-endian device that is the pair's 4 bytes as one word
        if flat.shape[0] % 2:
            flat = torch.cat([flat, flat.new_zeros(1)])
        return flat.contiguous().view(torch.int32)
    # a value cast, sign-extended for signed integers as XLA's convert does
    # (int8 -1 -> 0xFFFFFFFF); int64 wraps to its low 32 bits
    return flat.to(torch.int64).to(torch.int32)


def flatten_local_u32(tree) -> torch.Tensor:
    """Concatenate a tree's (local) leaves, in checkpoint order, into one
    flat int32 tensor of uint32 words on the leaves' device."""
    parts = [_leaf_words(torch.as_tensor(leaf))
             for _, leaf in leaves_with_paths(tree)]
    return torch.cat(parts)


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-x.shape[0]) % mult
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x


def _stripe_layout(buf: torch.Tensor, g: int, G: int):
    """Place the local buffer's G-1 chunks into a (G, c) stripe table with
    row g zeroed (a slot's parity stripe never covers its own data).  The
    rows lie a multiple of 4 words apart, so each is 16-byte aligned for
    the XOR-pair kernel's vector loads."""
    c = -(-buf.shape[0] // (G - 1))
    chunks = _pad_to(buf, c * (G - 1)).view(G - 1, c)
    xs = buf.new_zeros((G, -(-c // 4) * 4))[:, :c]
    j = torch.arange(G - 1, device=buf.device)
    xs[j + (j >= g).to(j.dtype)] = chunks  # skip the own stripe index
    return xs, c


def _encode_mesh(state, pspecs, mesh, mode, axis, distance):
    from torch.distributed import _functional_collectives as funcol

    from repro_torch import runtime, sharding

    G = runtime.mesh_axes(mesh).get(axis)
    if G is None or G < 2:
        raise ValueError("L2 encode needs >=2 slots on the partner axis")
    group = mesh.get_group(axis)  # group rank = coordinate along the axis
    g = mesh.get_local_rank(axis)
    pairs = []  # (leaf, spec) in checkpoint order (dict keys sorted)
    sharding._map_up_to(state, pspecs,
                        lambda leaf, sp: pairs.append((leaf, sp)))

    def permute(buf, shift):
        out = funcol.permute_tensor(buf.contiguous(),
                                    [(i + shift) % G for i in range(G)],
                                    group)
        return funcol.wait_tensor(out)

    def inner(*leaves):
        buf = _pad_to(flatten_local_u32(list(leaves)), 1024)
        if mode == "partner":
            return permute(buf, distance)
        # --- SCR rotating-parity ring reduce-scatter -------------------
        xs, _ = _stripe_layout(buf, g, G)
        acc = xs[(g - 1) % G]
        for i in range(G - 1):
            acc = kops.xor_pair(permute(acc, 1), xs[(g - 2 - i) % G])
        return acc

    all_axes = tuple(runtime.mesh_axes(mesh))
    fn = runtime.shard_map(inner, mesh=mesh,
                           in_specs=tuple(sp for _, sp in pairs),
                           out_specs=sharding.P(all_axes))
    return fn(*(leaf for leaf, _ in pairs))


def encode_l2(local, pspecs=None, mesh=None, *, mode: str = "xor",
              axis: str = "data", distance: int = 1):
    """Mesh form (``mesh`` given): ``local`` is the sharded state (DTensor
    leaves), ``pspecs`` its matching tree of resolved specs; every rank of
    ``mesh`` calls it.  Returns a 1-D DTensor of int32 words sharded over
    every mesh axis: this rank's local part is the L2 artifact its host
    must persist (the partner copy it received along ``axis``, or its
    parity stripe), JAX's mesh device's slice.

    Slot-list form: ``local`` is the G local trees along the data axis, one
    per slot, each on its slot's device.  Returns the G output buffers:
    slot g's is what device g of the JAX package's mesh holds, on slot g's
    device."""
    if mode not in ("partner", "xor"):
        raise ValueError(f"unknown L2 mode {mode!r}")
    if mesh is not None:
        return _encode_mesh(local, pspecs, mesh, mode, axis, distance)
    G = len(local)
    if G < 2:
        raise ValueError("L2 encode needs >=2 slots on the partner axis")
    bufs = [_pad_to(flatten_local_u32(tree), 1024) for tree in local]
    if len({b.shape[0] for b in bufs}) != 1:
        raise ValueError(f"slots of unequal length "
                         f"{[b.shape[0] for b in bufs]}: a shard_map "
                         f"cannot express them")
    devices = [b.device for b in bufs]
    if mode == "partner":
        return [bufs[(g - distance) % G].to(devices[g]) for g in range(G)]
    # --- SCR rotating-parity ring reduce-scatter ---------------------------
    tables = [_stripe_layout(b, g, G)[0] for g, b in enumerate(bufs)]
    acc = [tables[g][(g - 1) % G] for g in range(G)]
    for i in range(G - 1):
        recv = [acc[(g - 1) % G].to(devices[g]) for g in range(G)]
        acc = [kops.xor_pair(recv[g], tables[g][(g - 2 - i) % G])
               for g in range(G)]
    return acc


# ---------------------------------------------------------------------------
# host-side oracles / recovery (tests + restart path)
# ---------------------------------------------------------------------------


def stripe_table_host(buf: np.ndarray, g: int, G: int) -> np.ndarray:
    c = -(-buf.shape[0] // (G - 1))
    b = np.zeros(c * (G - 1), np.uint32)
    b[: buf.shape[0]] = buf
    chunks = b.reshape(G - 1, c)
    xs = np.zeros((G, c), np.uint32)
    for j in range(G - 1):
        xs[j + (1 if j >= g else 0)] = chunks[j]
    return xs


def ring_xor_parity_ref(buffers: list[np.ndarray]) -> list[np.ndarray]:
    """Oracle: parity stripe each device holds (device g -> stripe g)."""
    G = len(buffers)
    tables = [stripe_table_host(np.asarray(b), g, G) for g, b in enumerate(buffers)]
    out = []
    for s in range(G):
        acc = np.zeros(tables[0].shape[1], np.uint32)
        for g in range(G):
            acc ^= tables[g][s]
        out.append(acc)
    return out


def xor_reconstruct_group(survivor_buffers: dict[int, np.ndarray],
                          parity: dict[int, np.ndarray], lost: int, G: int,
                          length: int) -> np.ndarray:
    """Rebuild the lost device's u32 buffer.  survivor_buffers: {dev: full
    local buffer}; parity: {dev: parity stripe it held}."""
    c = parity[next(d for d in parity if d != lost)].shape[0]
    tables = {d: stripe_table_host(b, d, G) for d, b in survivor_buffers.items()}
    rebuilt = np.zeros((G - 1, c), np.uint32)
    j = 0
    for s in range(G):
        if s == lost:
            continue  # stripe s==lost contains no data from the lost device
        acc = parity[s].copy()  # device s held stripe s parity and s != lost
        for d, t in tables.items():
            acc ^= t[s]
        rebuilt[j] = acc
        j += 1
    return rebuilt.reshape(-1)[:length]
