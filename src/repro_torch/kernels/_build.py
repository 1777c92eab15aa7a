"""Build and load the port's CUDA kernels.

Each source in ``repro_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which the
wrappers load with ``ctypes``: no PyTorch headers, so a build takes seconds.
Libraries go to ``build/repro_torch/`` at the root of the checkout (or
``$REPRO_TORCH_BUILD_DIR``), named by a hash of the source and the flags, so
a changed source is rebuilt and an unchanged one is reused.  Nothing builds
at import time: the first launch builds what it needs, and ``build()``
starts every missing build at once (one ``nvcc`` per source, in parallel).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.core import concurrency

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("checksum", "xor_parity")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = concurrency.TrackedLock("kernels._build_lock", concurrency.RANK_KERNEL)
_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict = {}  # symbol -> declared ctypes function


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH, $CUDA_HOME or /usr/local/cuda)")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every missing library of ``names`` in parallel; returns the
    seconds each build took (0.0 when it was already built).  Raises with
    the compiler's output when a build fails."""
    with _lock:
        return _build_locked(names)


def _build_locked(names) -> dict[str, float]:
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a racing process sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def function(name: str, symbol: str, argtypes: list):
    """C entry point ``symbol`` of kernel ``name``'s library, declared as
    ``int symbol(*argtypes)``; the library is built and loaded on first
    use."""
    with _lock:
        fn = _functions.get(symbol)
        if fn is None:
            lib = _loaded.get(name)
            if lib is None:
                _build_locked((name,))
                lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[symbol] = fn
        return fn


def check(rc: int, what: str):
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


class LaunchCount:
    """Launches of one kernel, counted where the wrapper launches it."""

    def __init__(self, name: str):
        self._n = 0
        self._lock = concurrency.TrackedLock(f"kernels.{name}.launches",
                                             concurrency.RANK_KERNEL)

    def add(self):
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self):
        with self._lock:
            self._n = 0
