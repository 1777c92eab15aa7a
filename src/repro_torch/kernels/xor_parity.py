"""XOR parity over K rows, and the pairwise XOR: the wrappers of
``csrc/xor_parity.cu``.

``xor_reduce`` replaces the TPU kernel ``xor_reduce_pallas``
(src/repro/kernels/xor_parity.py): ``parity[n] = x[0,n] ^ ... ^ x[K-1,n]``
over uint32 words — VELOC's L2 XOR-group encode, and the reconstruct of a
lost member from the survivors and the parity.  ``xor_pair`` replaces
``xor_pair_pallas``: ``a ^ b``, the combiner of the device-level L2 ring
(``core/partner.py``).  A CUDA tensor goes through the kernel (16-byte
loads; ``xor_reduce`` in a grid-stride loop, ``xor_pair`` in one pass of
``PAIR_BLOCK_WORDS`` words a block; see the source's note); a CPU tensor
goes through the plain version in ``ref.py``.  On the card the rows must be 16-byte aligned
(``x.stride(0) % 4 == 0``, aligned base) for the kernel's vector loads; they
may be padded (``x.stride(0) >= N``), so the caller aligns them without
padding N itself (``ops.xor_reduce`` and ``ops.xor_pair`` do).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import xor_pair_ref, xor_reduce_ref

#: launches of the CUDA kernels (the plain CPU versions do not count)
LAUNCHES = _build.LaunchCount("xor_reduce")
PAIR_LAUNCHES = _build.LaunchCount("xor_pair")

#: words one block of the XOR-pair kernel covers (``kPairThreads`` 16-byte
#: vectors in csrc/xor_parity.cu); the last block takes the ragged rest
PAIR_BLOCK_WORDS = 512


#: int veloc_xor_reduce(x, out, k, n, ld, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


def _words(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32/uint32 words, got {x.dtype}")
    return x


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """x: (K, N) int32/uint32 words -> (N,) int32 parity."""
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"expected a (K>=1, N) tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return xor_reduce_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"xor_reduce: unsupported device {x.device}")
    x = _words(x, "xor_reduce")
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


#: int veloc_xor_pair(a, b, out, n, stream)
_PAIR_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_void_p]


def xor_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (N,) int32/uint32 words on one device -> (N,) int32 ``a ^ b``."""
    if a.dim() != 1 or a.shape != b.shape:
        raise ValueError(f"xor_pair: expected two (N,) tensors, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"xor_pair: operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return xor_pair_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"xor_pair: unsupported device {a.device}")
    a, b = _words(a, "xor_pair"), _words(b, "xor_pair")
    if a.stride(0) != 1 or b.stride(0) != 1 or a.data_ptr() % 16 \
            or b.data_ptr() % 16:
        raise ValueError("xor_pair: words must be contiguous and 16-byte "
                         "aligned")
    (n,) = a.shape
    out = torch.empty((n,), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    fn = _build.function("xor_parity", "veloc_xor_pair", _PAIR_ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, stream)
    _build.check(rc, "xor_pair kernel launch")
    PAIR_LAUNCHES.add()
    return out
