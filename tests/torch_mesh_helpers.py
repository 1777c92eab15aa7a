"""Launchers for the port's multi-rank tests on the CPU.

``run_ranks`` runs one script in ``n`` processes, one rank each of a gloo
process group (``init_method="file://..."`` under the test's tmp dir, so
no port is taken and parallel test workers never collide): the port's
stand-in for ``tests/test_multidevice.py``'s 8 fake XLA devices.  Each rank
runs with the port's test settings (``ops.set_device("cpu")``, the lock
checker in raise mode, asserted clean at the end) and one intra-op thread.
A hung collective fails the test at ``timeout``: every rank is killed.

``run_jax`` runs a JAX script in a subprocess with 8 fake host devices
(the device count is fixed at jax's start), as ``test_multidevice.py``
does.  Both pass the output directory as ``OUT``; results travel as
pickles of numpy arrays.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

_PRELUDE = """
import os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    OUT, "pg_init"), rank=RANK, world_size=WORLD)
from repro_torch.core import concurrency as tconc
from repro_torch.kernels import ops
ops.set_device("cpu")
tconc.reset()
tconc.enable("raise")


def dump(name, obj):
    with open(os.path.join(OUT, f"{name}.rank{RANK}.pkl"), "wb") as f:
        pickle.dump(obj, f)

"""

_EPILOGUE = """
assert not tconc.violations(), tconc.violations()
dist.barrier()
dist.destroy_process_group()
"""


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_ranks(code: str, out: str, n: int = 8, timeout: float = 400.0):
    """Run ``code`` on ``n`` gloo ranks; returns {(name, rank): object}
    of what the ranks ``dump``ed."""
    os.makedirs(out, exist_ok=True)
    script = os.path.join(out, "ranks.py")
    with open(script, "w") as f:
        f.write(_PRELUDE + textwrap.dedent(code) + _EPILOGUE)
    logs = [open(os.path.join(out, f"rank{r}.log"), "w+") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, script, str(r), str(n), out],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=_env()) for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * n, "\n".join(
        f"--- rank {r} rc {rc} ---\n{t[-6000:]}"
        for r, (rc, t) in enumerate(zip(rcs, texts)) if rc != 0)
    got = {}
    for fname in os.listdir(out):
        if fname.endswith(".pkl") and ".rank" in fname:
            name, rank = fname[:-4].rsplit(".rank", 1)
            with open(os.path.join(out, fname), "rb") as f:
                got[(name, int(rank))] = pickle.load(f)
    return got


def run_jax(code: str, out: str, timeout: float = 500.0) -> dict:
    """Run a JAX script with 8 fake host devices; it writes ``OUT/jax.pkl``
    (any picklable object), which is returned."""
    os.makedirs(out, exist_ok=True)
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env.pop("OMP_NUM_THREADS")
    r = subprocess.run(
        [sys.executable, "-c", "OUT = " + repr(out) + "\n"
         + textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with open(os.path.join(out, "jax.pkl"), "rb") as f:
        return pickle.load(f)
