"""Plain PyTorch versions of the port's kernels.

The wrappers in ``checksum.py``, ``xor_parity.py``, ``blockhash.py``,
``gather.py`` and ``quantize.py`` run these for tensors that lie on the CPU,
and tests compare the CUDA kernels with them on the card.  Words are uint32
values held in int32 tensors (the same bits); PyTorch's uint32 has no shifts
or sums on the CPU, so the arithmetic runs in int64 on values masked to 32
bits.  The checksum's largest sum, over a 2048-word row, is below 2**54, so
it is exact.  The block hash multiplies two 32-bit values, whose product can
reach 2**64 and overflow int64, so ``_mul32`` splits the multiplier into
16-bit halves: every partial product stays below 2**48.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int32:
        return x
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    raise TypeError(f"expected int32 or uint32 words, got {x.dtype}")


def _to_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same low bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def checksum_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (n_chunks, chunk) words -> (n_chunks, 2) int32 holding the uint32
    pair ``c1 = sum(x)``, ``c2 = sum((i+1) * x)``, both mod 2**32."""
    w = _as_i32(x).to(torch.int64) & _MASK
    weights = torch.arange(1, w.shape[1] + 1, dtype=torch.int64,
                           device=w.device)
    c1 = w.sum(dim=1) & _MASK
    c2 = (w * weights).sum(dim=1) & _MASK
    return _to_u32_bits(torch.stack([c1, c2], dim=1))


def xor_reduce_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (K, N) words -> (N,) XOR of the K rows."""
    x = _as_i32(x)
    out = x[0].clone()
    for k in range(1, x.shape[0]):
        out ^= x[k]
    return out


_MIX1 = 0x9E3779B1
_MIX2 = 0x85EBCA77
_MIX3 = 0xC2B2AE3D


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2**32`` for int64 values in [0, 2**32): ``b`` is split
    into 16-bit halves, so no partial product overflows int64."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


def blockhash_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (n_chunks, chunk) words -> (n_chunks, 2) int32 holding the uint32
    fingerprint pair of each row: per word the avalanche
    ``y = mix(x)``, then ``h1 = sum(y * (2i+1))`` and
    ``h2 = sum((y ^ w2) * w2)`` with ``w2 = ((i+1) * 0xC2B2AE3D) | 1``, all
    mod 2**32 (``repro.kernels.checksum._blockhash_rows``)."""
    w = _as_i32(x).to(torch.int64) & _MASK
    i = torch.arange(w.shape[1], dtype=torch.int64, device=w.device)
    y = _mul32(w ^ (w >> 15), _MIX1)
    y = _mul32(y ^ (y >> 13), _MIX2)
    y = y ^ (y >> 16)
    w1 = (2 * i + 1) & _MASK
    w2 = _mul32(i + 1, _MIX3) | 1
    h1 = _mul32(y, w1).sum(dim=1) & _MASK
    h2 = _mul32(y ^ w2, w2).sum(dim=1) & _MASK
    return _to_u32_bits(torch.stack([h1, h2], dim=1))


def blockhash_diff_ref(x: torch.Tensor, prev: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n, chunk) words, prev: (n, 2) words -> (fp (n, 2) int32,
    dirty (n, 1) int32 0/1 where the fingerprint differs from ``prev``)."""
    fp = blockhash_ref(x)
    dirty = (fp != _as_i32(prev)).any(dim=1, keepdim=True)
    return fp, dirty.to(torch.int32)


def gather_rows_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (n, chunk), idx: (n_out,) -> (n_out, chunk),
    ``out[j] = x[idx[j]]``."""
    return x[idx.to(torch.int64)]


def xor_pair_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (N,) words -> ``a ^ b``."""
    return _as_i32(a) ^ _as_i32(b)


#: float32(1/127): the JAX package's ``max(absmax, 1e-30) / 127.0`` is
#: rewritten by XLA under ``jit`` into a multiply by this reciprocal, and the
#: scales it writes differ from a true division by 1 ulp in ~2.5 % of blocks.
#: The port multiplies, so its q8 shards are byte-identical.
INV_127 = float.fromhex("0x1.020408p-7")


def quantize_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n, 256) float -> (q (n, 256) int8, scales (n,) float32), per row
    ``s = max(absmax, 1e-30) * f32(1/127)``, ``q = clip(round(x / s), ±127)``
    (round half to even).  A row holding a NaN gets scale NaN (the quiet NaN
    ``0x7FC00000``) and codes 0; a row holding ±inf gets scale inf and codes
    0 — both restore as NaN, as in the JAX package."""
    x = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x), dim=1)
    s = torch.clamp(absmax, min=1e-30) * torch.tensor(
        INV_127, dtype=torch.float32, device=x.device)
    # one NaN bit pattern whatever the device's arithmetic makes of NaN
    s = torch.where(torch.isnan(s), float("nan"), s)
    q = torch.clamp(torch.round(x / s[:, None]), -127, 127)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8), s


BLOCK_SIZE = 256  # values per quantization block (one scale each)


def quantize_flat_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n,) float -> ``quantize_ref`` of the values zero-padded, on their
    own device, to whole blocks: (q (ceil(n/256), 256) int8, s float32).
    Zeros leave a block's absmax as it is, and their codes are 0."""
    n = x.shape[0]
    padded = x.new_zeros((-(-n // BLOCK_SIZE) * BLOCK_SIZE,),
                         dtype=torch.float32)
    padded[:n] = x
    return quantize_ref(padded.view(-1, BLOCK_SIZE))


def dequantize_ref(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q: (n, 256) int8, s: (n,) float32 -> (n, 256) float32 ``q * s``."""
    return q.to(torch.float32) * s[:, None]
