"""Chunked Fletcher-style checksum: the wrapper of ``csrc/checksum.cu``.

Replaces the TPU kernel ``checksum_pallas`` (src/repro/kernels/checksum.py).
For each row of ``chunk`` uint32 words it computes ``c1 = sum(x)`` and
``c2 = sum((i+1) * x)``, both mod 2**32.  A CUDA tensor goes through the
kernel (one block per row, see the source's note); a CPU tensor goes through
the plain version, ``ref.checksum_ref``.  No TPU tiling carries over: the
caller pads only the last partial row.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import checksum_ref

CHUNK_WORDS = 2048

#: launches of the CUDA kernel (the plain CPU version does not count)
LAUNCHES = _build.LaunchCount("checksum")


#: int veloc_checksum_rows(x, out, rows, chunk, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p]


def checksum(x: torch.Tensor) -> torch.Tensor:
    """x: (n_chunks, chunk) int32/uint32 words -> (n_chunks, 2) int32
    holding the uint32 pair of each row."""
    if x.dim() != 2:
        raise ValueError(f"expected a (rows, chunk) tensor, "
                         f"got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return checksum_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"checksum: unsupported device {x.device}")
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    if x.dtype != torch.int32:
        raise TypeError(f"checksum: expected int32/uint32 words, got {x.dtype}")
    rows, chunk = x.shape
    if chunk % 4 or chunk <= 0:
        raise ValueError(f"checksum: chunk must be a positive multiple of 4, "
                         f"got {chunk}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("checksum: words must be contiguous and 16-byte "
                         "aligned")
    out = torch.empty((rows, 2), dtype=torch.int32, device=x.device)
    if rows == 0:
        return out
    fn = _build.function("checksum", "veloc_checksum_rows", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), rows, chunk, stream)
    _build.check(rc, "checksum kernel launch")
    LAUNCHES.add()
    return out
