"""Block fingerprints and the fused fingerprint + diff: the wrappers of
``csrc/blockhash.cu``.

Replace the TPU kernels ``blockhash_pallas`` and ``blockhash_diff_pallas``
(src/repro/kernels/checksum.py).  The words are a flat buffer cut into rows
of ``chunk`` words; the last row may be ragged, and the kernel hashes its
missing words as zeros, so no leaf is copied to pad it.  A CUDA tensor goes
through the kernel (one block per row, see the source's note); a CPU tensor
goes through the plain versions, ``ref.blockhash_ref`` and
``ref.blockhash_diff_ref``, on a zero-padded copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import blockhash_diff_ref, blockhash_ref

#: launches of each CUDA kernel (the plain CPU versions do not count)
LAUNCHES = _build.LaunchCount("blockhash")
DIFF_LAUNCHES = _build.LaunchCount("blockhash_diff")

#: int veloc_blockhash(x, n_words, chunk, rows, fp, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
#: int veloc_blockhash_diff(x, n_words, chunk, rows, prev, fp, dirty, stream)
_DIFF_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p]


def _flat_words(x: torch.Tensor, chunk, what: str):
    """(1-D int32 words, chunk, rows) of a flat or (rows, chunk) buffer."""
    if x.dim() == 2 and chunk is None:
        chunk = x.shape[1]
    if x.dim() not in (1, 2) or chunk is None or chunk <= 0:
        raise ValueError(f"{what}: expected flat words and a chunk > 0, or a "
                         f"(rows, chunk) tensor; got {tuple(x.shape)}, "
                         f"chunk={chunk}")
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32/uint32 words, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: words must be contiguous")
    x = x.reshape(-1)
    return x, int(chunk), -(-x.shape[0] // int(chunk))


def _padded(x: torch.Tensor, chunk: int, rows: int) -> torch.Tensor:
    """(rows, chunk) copy of the flat words, the ragged row zero-padded —
    the tiling the plain versions and the JAX package hash."""
    out = torch.zeros(rows * chunk, dtype=torch.int32, device=x.device)
    out[:x.shape[0]] = x
    return out.view(rows, chunk)


def blockhash(x: torch.Tensor, chunk: int = None) -> torch.Tensor:
    """x: flat int32/uint32 words (``chunk`` given) or (rows, chunk) ->
    (rows, 2) int32 holding the uint32 fingerprint pair of each row."""
    x, chunk, rows = _flat_words(x, chunk, "blockhash")
    if x.device.type == "cpu":
        return blockhash_ref(_padded(x, chunk, rows))
    fp = torch.empty((rows, 2), dtype=torch.int32, device=x.device)
    if rows == 0:
        return fp
    fn = _build.function("blockhash", "veloc_blockhash", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), x.shape[0], chunk, rows, fp.data_ptr(), stream)
    _build.check(rc, "blockhash kernel launch")
    LAUNCHES.add()
    return fp


def blockhash_diff(x: torch.Tensor, prev: torch.Tensor, chunk: int = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused dirty detection: fingerprint ``x`` as ``blockhash`` does and
    compare each row with ``prev`` (rows, 2) -> (fp (rows, 2) int32,
    dirty (rows, 1) int32 0/1)."""
    x, chunk, rows = _flat_words(x, chunk, "blockhash_diff")
    if prev.dtype == torch.uint32:
        prev = prev.view(torch.int32)
    if tuple(prev.shape) != (rows, 2) or prev.dtype != torch.int32:
        raise ValueError(f"blockhash_diff: prev must be ({rows}, 2) int32, "
                         f"got {tuple(prev.shape)} {prev.dtype}")
    if prev.device != x.device:
        raise ValueError("blockhash_diff: prev and words on different "
                         "devices")
    if x.device.type == "cpu":
        return blockhash_diff_ref(_padded(x, chunk, rows), prev)
    prev = prev.contiguous()
    fp = torch.empty((rows, 2), dtype=torch.int32, device=x.device)
    dirty = torch.empty((rows, 1), dtype=torch.int32, device=x.device)
    if rows == 0:
        return fp, dirty
    fn = _build.function("blockhash", "veloc_blockhash_diff", _DIFF_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), x.shape[0], chunk, rows, prev.data_ptr(),
                fp.data_ptr(), dirty.data_ptr(), stream)
    _build.check(rc, "blockhash_diff kernel launch")
    DIFF_LAUNCHES.add()
    return fp, dirty
