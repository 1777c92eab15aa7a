"""Block-wise int8 quantize and dequantize: the wrappers of
``csrc/quantize.cu``.

Replace the TPU kernels ``quantize_pallas`` and ``dequantize_pallas``
(src/repro/kernels/quantize.py), VELOC's lossy compression module (the
"q8" shard encoding): each block of 256 values gets the scale
``s = max(absmax, 1e-30) * f32(1/127)`` and int8 codes
``q = clip(round(x / s), ±127)``; dequantize is ``q * s``.  A CUDA tensor
goes through the kernels (one warp per block; see the source's note); a CPU
tensor goes through the plain versions, ``ref.quantize_flat_ref`` and
``ref.dequantize_ref``.  The kernels take the count of real values, ``n``,
and read the missing values of a ragged last block as zeros, so nothing is
padded on the card (the JAX package pads to 256-row tiles, a TPU tiling).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (BLOCK_SIZE, dequantize_ref,
                                     quantize_flat_ref)

#: launches of the CUDA kernels (the plain CPU versions do not count)
LAUNCHES = _build.LaunchCount("quantize")
DEQUANT_LAUNCHES = _build.LaunchCount("dequantize")

#: int veloc_quantize(x, q, s, n, stream) and
#: int veloc_dequantize(q, s, out, n, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p]


def blocks(n: int) -> int:
    """Quantization blocks of ``n`` values (the last may be ragged)."""
    return -(-n // BLOCK_SIZE)


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n,) float32 -> (q (blocks(n), 256) int8, s (blocks(n),) float32);
    the codes of a ragged last block's missing values are 0."""
    if x.dim() != 1:
        raise ValueError(f"quantize: expected a flat (n,) tensor, got "
                         f"{tuple(x.shape)}")
    n = x.shape[0]
    rows = blocks(n)
    if x.device.type == "cpu":
        return quantize_flat_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"quantize: expected float32 values, got {x.dtype}")
    if x.stride(0) != 1 and n > 1:
        raise ValueError("quantize: values must be contiguous")
    q = torch.empty((rows, BLOCK_SIZE), dtype=torch.int8, device=x.device)
    s = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if n == 0:
        return q, s
    fn = _build.function("quantize", "veloc_quantize", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), n, stream)
    _build.check(rc, "quantize kernel launch")
    LAUNCHES.add()
    return q, s


def dequantize(q: torch.Tensor, s: torch.Tensor, n: int) -> torch.Tensor:
    """q: (blocks(n), 256) int8, s: (blocks(n),) float32 -> (n,) float32
    ``q * s`` (the ragged last block's missing values are not written)."""
    rows = blocks(n)
    if q.shape != (rows, BLOCK_SIZE) or s.shape != (rows,):
        raise ValueError(f"dequantize: {n} values need ({rows}, {BLOCK_SIZE}) "
                         f"codes and ({rows},) scales, got {tuple(q.shape)} "
                         f"and {tuple(s.shape)}")
    if q.device != s.device:
        raise ValueError(f"dequantize: operands on {q.device} and {s.device}")
    if q.device.type == "cpu":
        return dequantize_ref(q, s).reshape(-1)[:n]
    if q.device.type != "cuda":
        raise ValueError(f"dequantize: unsupported device {q.device}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"dequantize: expected int8 codes and float32 "
                        f"scales, got {q.dtype} and {s.dtype}")
    if not q.is_contiguous() or not s.is_contiguous() or q.data_ptr() % 8:
        raise ValueError("dequantize: codes and scales must be contiguous, "
                         "the codes 8-byte aligned")
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    fn = _build.function("quantize", "veloc_dequantize", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), s.data_ptr(), out.data_ptr(), n, stream)
    _build.check(rc, "dequantize kernel launch")
    DEQUANT_LAUNCHES.add()
    return out
