"""XOR parity over K rows: the wrapper of ``csrc/xor_parity.cu``.

Replaces the TPU kernel ``xor_reduce_pallas``
(src/repro/kernels/xor_parity.py): ``parity[n] = x[0,n] ^ ... ^ x[K-1,n]``
over uint32 words — VELOC's L2 XOR-group encode, and the reconstruct of a
lost member from the survivors and the parity.  A CUDA tensor goes through
the kernel (grid-stride, 16-byte loads; see the source's note); a CPU tensor
goes through the plain version, ``ref.xor_reduce_ref``.  On the card the
rows must be 16-byte aligned (``x.stride(0) % 4 == 0``, aligned base) for the
kernel's vector loads; they may be padded (``x.stride(0) >= N``), so the
caller aligns them without padding N itself (``ops.xor_reduce`` does).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import xor_reduce_ref

#: launches of the CUDA kernel (the plain CPU version does not count)
LAUNCHES = _build.LaunchCount("xor_reduce")


#: int veloc_xor_reduce(x, out, k, n, ld, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """x: (K, N) int32/uint32 words -> (N,) int32 parity."""
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"expected a (K>=1, N) tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return xor_reduce_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"xor_reduce: unsupported device {x.device}")
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    if x.dtype != torch.int32:
        raise TypeError(f"xor_reduce: expected int32/uint32 words, "
                        f"got {x.dtype}")
    k, n = x.shape
    if x.stride(1) != 1 or (k > 1 and x.stride(0) < n):
        raise ValueError("xor_reduce: rows must be contiguous and must not "
                         "overlap")
    if (k > 1 and x.stride(0) % 4) or x.data_ptr() % 16:
        raise ValueError("xor_reduce: rows must be 16-byte aligned (row "
                         "stride a multiple of 4 words)")
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    fn = _build.function("xor_parity", "veloc_xor_reduce", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), k, n, x.stride(0), stream)
    _build.check(rc, "xor_reduce kernel launch")
    LAUNCHES.add()
    return out
