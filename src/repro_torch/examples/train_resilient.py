"""End-to-end driver: train the ~100M demo LM with full VELOC checkpointing,
kill it mid-run, and recover (the port of ``examples/train_resilient.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_resilient          # quick
    PYTHONPATH=src python -m repro_torch.examples.train_resilient --full   # few hundred steps

Internally this is ``repro_torch.launch.train`` with the failure simulator
armed; ``VELOC_SMOKE`` set in the environment runs the reduced smoke config.
"""
from __future__ import annotations

import os

from repro_torch.examples import parse_args, prepare
from repro_torch.launch import train


def main(argv=None) -> train.TrainRun:
    args = parse_args(
        "resilient", argv, __doc__,
        extra=lambda ap: ap.add_argument("--full", action="store_true"))
    prepare(args)  # an empty scratch: recovery must find this run's versions
    full = args.full
    steps = "300" if full else "60"
    targs = ["--arch", "veloc-demo-100m", "--steps", steps,
             "--seq-len", "128", "--batch", "8",
             "--ckpt-every", "10", "--mode", "async", "--capture", "fused",
             "--phase-predictor", "ema",
             "--fail-at", "35" if not full else "150",
             "--scratch", args.scratch, "--device", args.device]
    if not full:
        targs += ["--smoke"] if os.environ.get("VELOC_SMOKE") else []
    run = train.main(targs)
    assert run.losses[-1] < run.losses[0], "loss should decrease"
    print("resilient training example OK")
    return run


if __name__ == "__main__":
    main()
