"""The examples of the port, one module each, the counterparts of the JAX
package's scripts under ``examples/``:

  python -m repro_torch.examples.quickstart      the v2 API
  python -m repro_torch.examples.incremental     delta chains
  python -m repro_torch.examples.serve           the live clone of a server
  python -m repro_torch.examples.branch_explore  DataStates branches
  python -m repro_torch.examples.train_resilient the trainer through a failure

Each runs on the GPU (``--device cuda``, the default; without a GPU it
raises) or, asked with ``--device cpu``, on the CPU with the kernels' plain
versions.  ``--scratch`` defaults to ``veloc_<name>_torch`` in the
temporary directory.  ``main(argv)`` does all the work, keeps the script's
assertions and returns what it printed and asserted.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.kernels import ops


def parse_args(name: str, argv=None, doc: str = "", extra=None):
    """``--device`` and ``--scratch`` (plus what ``extra(ap)`` adds)."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the state and the kernels run (cpu: the "
                         "kernels' plain versions)")
    ap.add_argument("--scratch", default=os.path.join(
        tempfile.gettempdir(), f"veloc_{name}_torch"),
        help="checkpoint directory (emptied first)")
    if extra is not None:
        extra(ap)
    return ap.parse_args(argv)


def prepare(args) -> torch.device:
    """The run's device (the package's device from now on) and an empty
    scratch directory."""
    device = ops.check_device(args.device)
    ops.set_device(device.type)
    shutil.rmtree(args.scratch, ignore_errors=True)
    return device
