"""Package rules of the PyTorch port: it imports neither ``jax`` nor the
JAX package, ``chip_smoke.py`` neither, a CUDA device with no GPU raises
instead of falling back to the plain versions, and the port passes the
repo's concurrency lint."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core import concurrency as tconc
from repro_torch.kernels import ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import check_concurrency as lint  # noqa: E402


@pytest.fixture(autouse=True)
def port_env():
    """The port on its plain CPU versions, under its own lock checker."""
    prev = ops.get_device()
    ops.set_device("cpu")
    tconc.reset()
    tconc.enable("raise")
    yield
    leftovers = tconc.violations()
    tconc.disable()
    tconc.reset()
    ops.set_device(prev)
    assert not leftovers, "\n".join(leftovers)


_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:  # each module first in a fresh package: no import cycle
    for m in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[m]
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
assert not bad, bad
print("ok", len(names))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_import_walk_covers_the_workload_modules():
    """The walk above reaches the training workload's modules, the
    recurrent blocks, the encoder-decoder and the predictors (each
    subpackage has an ``__init__``)."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.models.layers", "repro_torch.models.transformer",
            "repro_torch.models.recurrent",
            "repro_torch.configs.xlstm_1_3b",
            "repro_torch.configs.recurrentgemma_2b",
            "repro_torch.models.encdec",
            "repro_torch.configs.whisper_medium",
            "repro_torch.configs.phi3_vision_4_2b",
            "repro_torch.models.model", "repro_torch.train.optimizer",
            "repro_torch.train.data", "repro_torch.train.steps",
            "repro_torch.launch.train", "repro_torch.core.phases",
            "repro_torch.core.interval", "repro_torch.examples.quickstart",
            "repro_torch.examples.incremental", "repro_torch.examples.serve",
            "repro_torch.examples.branch_explore",
            "repro_torch.examples.train_resilient"} <= names


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_neither_jax_nor_repro():
    roots = _imported_roots(os.path.join(REPO, "chip_smoke.py"))
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda device is usable here")
    ops.set_device("cuda")
    with pytest.raises(RuntimeError, match="no GPU"):
        ops.digest(b"x")
    with pytest.raises(RuntimeError, match="no GPU"):
        ops.xor_reduce(torch.ones((2, 3), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="no GPU"):
        ops.block_fingerprints(b"x" * 8, 4)
    with pytest.raises(RuntimeError, match="no GPU"):
        ops.quantize(torch.ones(300))
    with pytest.raises(RuntimeError, match="no GPU"):
        ops.xor_pair(torch.ones(4, dtype=torch.int32),
                     torch.ones(4, dtype=torch.int32))
    assert ops.digest(b"") == "000000000000000000000000"  # nothing to launch


def test_concurrency_lint_clean_on_port():
    vs = lint.check_paths([os.path.join(REPO, "src", "repro_torch")])
    assert vs == [], "\n".join(str(v) for v in vs)
