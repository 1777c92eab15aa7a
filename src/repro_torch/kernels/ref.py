"""Plain PyTorch versions of the port's kernels.

The wrappers in ``checksum.py`` and ``xor_parity.py`` run these for tensors
that lie on the CPU, and tests compare the CUDA kernels with them on the
card.  Words are uint32 values held in int32 tensors (the same bits);
PyTorch's uint32 has no shifts or sums on the CPU, so the checksum sums in
int64 and masks to 32 bits: the largest sum, over a 2048-word row, is below
2**54, so it is exact.
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
