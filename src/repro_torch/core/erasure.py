"""Erasure coding for VELOC level-2: XOR parity (1 failure / group) and
GF(2^8) Reed-Solomon (up to R failures / group).

The XOR hot path runs through the CUDA kernel (``repro_torch.kernels``); the RS
math is vectorized numpy over byte planes (table-based GF multiplies) — on a
real deployment the GF inner loop is also a streaming-kernel candidate, but
recovery is rare and off the critical path, so host execution is the right
cost/complexity point (DESIGN.md §2).
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels import ops as kops

# ---------------------------------------------------------------------------
# GF(2^8) tables (poly 0x11d, generator 3)
# ---------------------------------------------------------------------------

_EXP = np.zeros(512, np.uint8)
_LOG = np.zeros(256, np.int32)


def _init_tables():
    x = 1
    for i in range(255):
        _EXP[i] = x
        _LOG[x] = i
        x <<= 1
        if x & 0x100:
            x ^= 0x11D
    _EXP[255:510] = _EXP[:255]


_init_tables()


def gf_mul_scalar(vec: np.ndarray, c: int) -> np.ndarray:
    """vec: uint8 array; c: scalar in GF(256)."""
    if c == 0:
        return np.zeros_like(vec)
    if c == 1:
        return vec.copy()
    lc = int(_LOG[c])
    out = np.zeros_like(vec)
    nz = vec != 0
    out[nz] = _EXP[_LOG[vec[nz]] + lc]
    return out


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[int(_LOG[a]) + int(_LOG[b])])


def _gf_inv(a: int) -> int:
    assert a != 0
    return int(_EXP[255 - int(_LOG[a])])


def _gf_matinv(m: np.ndarray) -> np.ndarray:
    """Invert a small GF(256) matrix via Gauss-Jordan."""
    n = m.shape[0]
    a = m.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r, col]), None)
        if piv is None:
            raise ValueError("singular GF matrix (too many erasures)")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        ipiv = _gf_inv(int(a[col, col]))
        a[col] = gf_mul_scalar(a[col], ipiv)
        inv[col] = gf_mul_scalar(inv[col], ipiv)
        for r in range(n):
            if r != col and a[r, col]:
                f = int(a[r, col])
                a[r] ^= gf_mul_scalar(a[col], f)
                inv[r] ^= gf_mul_scalar(inv[col], f)
    return inv


def _vandermonde(r: int, k: int) -> np.ndarray:
    """r x k RS generator rows: V[j,i] = alpha^(j*i)."""
    return np.array([[_EXP[(j * i) % 255] for i in range(k)] for j in range(r)],
                    np.uint8)


# ---------------------------------------------------------------------------
# public API — shards are byte buffers (padded to equal length internally)
# ---------------------------------------------------------------------------


def _pad_stack(shards: list[bytes]) -> tuple[np.ndarray, list[int]]:
    lens = [len(s) for s in shards]
    n = max(lens)
    n = -(-n // 4) * 4
    stack = np.zeros((len(shards), n), np.uint8)
    for i, s in enumerate(shards):
        stack[i, :len(s)] = np.frombuffer(s, np.uint8)
    return stack, lens


def xor_encode(shards: list[bytes]) -> bytes:
    """Group parity via the XOR-reduce kernel."""
    stack, _ = _pad_stack(shards)
    parity = kops.xor_reduce(stack.view(np.uint32))
    return np.asarray(parity).view(np.uint8).tobytes()


def xor_reconstruct(survivors: dict[int, bytes], parity: bytes, k: int,
                    missing: int, length: int) -> bytes:
    """Rebuild shard ``missing`` of a k-shard group from k-1 survivors."""
    assert len(survivors) == k - 1, "XOR tolerates exactly one missing shard"
    blobs = list(survivors.values()) + [parity]
    stack, _ = _pad_stack(blobs)
    rec = kops.xor_reduce(stack.view(np.uint32))
    return np.asarray(rec).view(np.uint8).tobytes()[:length]


def rs_encode(shards: list[bytes], r: int) -> list[bytes]:
    """r parity shards over a k-data-shard group (tolerates r erasures)."""
    stack, _ = _pad_stack(shards)
    k = len(shards)
    V = _vandermonde(r, k)
    out = []
    for j in range(r):
        acc = np.zeros(stack.shape[1], np.uint8)
        for i in range(k):
            acc ^= gf_mul_scalar(stack[i], int(V[j, i]))
        out.append(acc.tobytes())
    return out


def rs_reconstruct(survivors: dict[int, bytes], parities: dict[int, bytes],
                   k: int, missing: list[int], length: int) -> dict[int, bytes]:
    """Rebuild the ``missing`` data shards.  survivors: {data_idx: bytes};
    parities: {parity_idx: bytes}.  len(missing) <= len(parities)."""
    assert len(missing) <= len(parities), "not enough parity for erasures"
    surv = sorted(survivors.items())
    pars = sorted(parities.items())
    blobs = [b for _, b in surv] + [b for _, b in pars]
    stack, _ = _pad_stack(blobs)
    n = stack.shape[1]
    V = _vandermonde(max(parities) + 1 if parities else 0, k)

    # rows of the combined system: identity rows for survivors, V rows for
    # the parities we use; solve for the full data vector.
    rows = []
    rhs = []
    for idx, (di, _) in enumerate(surv):
        row = np.zeros(k, np.uint8)
        row[di] = 1
        rows.append(row)
        rhs.append(stack[idx])
    for j, (pi, _) in enumerate(pars):
        rows.append(V[pi])
        rhs.append(stack[len(surv) + j])
    A = np.stack(rows[:k])
    B = np.stack(rhs[:k])
    Ainv = _gf_matinv(A)
    out = {}
    for mi in missing:
        acc = np.zeros(n, np.uint8)
        for c in range(k):
            if Ainv[mi, c]:
                acc ^= gf_mul_scalar(B[c], int(Ainv[mi, c]))
        out[mi] = acc.tobytes()[:length]
    return out


def group_of(rank: int, group_size: int) -> tuple[int, int]:
    """(group_id, index_within_group)."""
    return rank // group_size, rank % group_size


def parity_home(gid: int, group_size: int, nranks: int) -> int:
    """Node that stores group gid's parity.  Cross-group placement: a node
    must never hold the parity protecting its own data (else one node loss
    kills both), so group gid's parity lives on the next group's leader.
    With a single group there is no safe member — the caller falls back to
    the external tier (rank -1)."""
    ngroups = -(-nranks // group_size)
    if ngroups <= 1:
        return -1
    return ((gid + 1) % ngroups) * group_size


def partner_of(rank: int, nranks: int, distance: int = 1) -> int:
    return (rank + distance) % nranks
