"""Row gather: the wrapper of ``csrc/gather_rows.cu``.

Replaces the TPU kernel ``gather_rows_pallas``
(src/repro/kernels/checksum.py): ``out[j] = x[idx[j]]`` over rows of
``chunk`` uint32 words, so that a delta capture copies only the dirty chunks
of a leaf to the host.  The words are a flat buffer whose last row may be
ragged; a gathered ragged row is zero-filled past the buffer's end.  The
indices come from the host, and they stay there: the wrapper checks them
and refuses any outside ``[0, rows)``, then hands the kernel's C entry point
a host pointer to them, which copies them into the launch parameters (the
TPU's scalar prefetch becomes Hopper's parameter space).  No index tensor
is made on the card and nothing is copied from host to device.  One launch
takes at most ``MAX_INDICES`` indices; ``launch_groups`` cuts a longer list
into launches.  A CUDA tensor goes through the kernel; a CPU tensor goes
through the plain version, ``ref.gather_rows_ref``, in one call.
The TPU wrapper's padding of the index vector to a power of two (which
bounds jit retraces) is not carried over: the port has no jit, so exactly
``len(idx)`` rows move.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blockhash import _flat_words, _padded
from repro_torch.kernels.ref import gather_rows_ref

#: launches of the CUDA kernel (the plain CPU version does not count)
LAUNCHES = _build.LaunchCount("gather_rows")

#: indices one launch carries in its parameters (``kMaxIndices`` in
#: csrc/gather_rows.cu)
MAX_INDICES = 8000

#: int veloc_gather_rows(x, n_words, chunk, idx (host), n_out, out, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]


def launch_groups(n: int, cap: int = MAX_INDICES) -> list[tuple[int, int]]:
    """``[start, stop)`` of each launch that gathers ``n`` indices, at most
    ``cap`` a launch, in order."""
    return [(s, min(s + cap, n)) for s in range(0, n, cap)]


def gather_rows(x: torch.Tensor, idx, chunk: int = None) -> torch.Tensor:
    """x: flat int32/uint32 words (``chunk`` given) or (rows, chunk);
    idx: host row indices (sequence, numpy array or CPU tensor) ->
    (len(idx), chunk) int32 on x's device."""
    x, chunk, rows = _flat_words(x, chunk, "gather_rows")
    if isinstance(idx, torch.Tensor):
        if idx.device.type != "cpu":
            raise ValueError("gather_rows: the indices must be on the host")
        idx = idx.numpy()
    idx = np.asarray(idx).reshape(-1)
    if idx.size and (idx.dtype.kind not in "iu" or int(idx.min()) < 0
                     or int(idx.max()) >= rows):
        raise ValueError(f"gather_rows: indices must be integers in "
                         f"[0, {rows})")
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    if x.device.type == "cpu":
        return gather_rows_ref(_padded(x, chunk, rows), torch.from_numpy(idx))
    out = torch.empty((idx.shape[0], chunk), dtype=torch.int32,
                      device=x.device)
    with torch.cuda.device(x.device):
        for s, e in launch_groups(idx.shape[0]):  # on the current stream
            launch(x, chunk, idx[s:e], out[s:e])
    return out


def launch(x: torch.Tensor, chunk: int, idx: np.ndarray,
           out: torch.Tensor) -> None:
    """The kernel alone: flat CUDA words ``x``, 1 to ``MAX_INDICES`` int32
    row indices ``idx`` in a contiguous host array, checked to lie in
    ``[0, rows)``, and ``out`` of shape (len(idx), chunk) int32 on x's
    device.  What ``gather_rows`` costs beyond this call is its host work:
    the index checks and the split into launches."""
    fn = _build.function("gather_rows", "veloc_gather_rows", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), x.shape[0], chunk, idx.ctypes.data, idx.shape[0],
            out.data_ptr(), stream)
    _build.check(rc, "gather_rows kernel launch")
    LAUNCHES.add()
