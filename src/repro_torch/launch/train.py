"""End-to-end resilient trainer with VELOC integrated first-class,
the port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch veloc-demo-100m \\
      --steps 300 --ckpt-every 20 --mode async --capture fused

It runs on the GPU (``--device cuda``, the default; without a GPU it
raises) or, asked with ``--device cpu``, on the CPU with the kernels' plain
versions.  Features exercised for real:
  - deterministic seekable data stream (restart-exact);
  - fused L1 capture (the step's device snapshot of the fresh state);
  - async multi-level pipeline (local write + external flush, one rank);
  - phase-predictor-gated, rate-limited background flushing;
  - automatic restart from the newest restorable level (--resume);
  - simulated node failure (--fail-at N) followed by recovery;
  - DataStates lineage recording per checkpoint.

The step is eager PyTorch (no ``torch.compile``).  ``main()`` returns a
``TrainRun``: the losses, and the times a caller measuring the checkpoint
overhead needs.
"""
import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.configs.base import ShapeCfg, get_config, smoke_config
from repro_torch.core import (Cluster, DataStates, ModuleSpec, PipelineSpec,
                              TierTopology, VelocClient)
from repro_torch.core.capture import snapshot_device
from repro_torch.kernels import ops
from repro_torch.train.data import SyntheticStream
from repro_torch.train.steps import (check_device, init_train_state,
                                     make_train_step)


@dataclass
class TrainRun:
    """What one run of the trainer did.  Times are host-clock seconds; a
    step's time ends with reading its loss, which waits for the device."""

    losses: list = field(default_factory=list)
    #: per step: batch, train step, loss read and checkpoint call (the
    #: failure simulation's recovery is in ``restart_s`` instead)
    step_s: list = field(default_factory=list)
    #: per step: the two ``client.tick`` calls (the phase gate's update on
    #: the loop's thread)
    tick_s: list = field(default_factory=list)
    #: per checkpoint call, ``results["app_blocking_s"]``
    app_blocking_s: list = field(default_factory=list)
    #: per checkpoint call, its future's ``results`` (the backend fills in
    #: each stage's status and ``<stage>.done_at`` time as it runs)
    ckpt_results: list = field(default_factory=list)
    #: from the end of the loop until the backend has drained
    drain_s: Optional[float] = None
    #: per ``restart_latest`` call (``--resume``, ``--fail-at``)
    restart_s: list = field(default_factory=list)
    #: ``--fail-at``: the wait for the pipeline to drain before recovery
    failure_wait_s: Optional[float] = None
    resumed_from: Optional[int] = None
    #: ``--resume``: a device copy of the state as resumed, before training
    #: went on
    resumed_state: Any = None
    #: ``--fail-at``: the version recovered and a device copy of the state
    #: as recovered, before training went on
    recovered_version: Optional[int] = None
    recovered_state: Any = None
    #: the state after the last step
    state: Any = None


def build(arch: str, smoke: bool, seq_len: int, batch: int):
    cfg = smoke_config(arch) if smoke else get_config(arch)
    shape = ShapeCfg("cli", seq_len, batch, "train")
    return cfg, shape


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="veloc-demo-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config of the arch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and the kernels run (cpu: the "
                         "kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mode", default="async", choices=["async", "sync", "off"])
    ap.add_argument("--capture", default="fused", choices=["fused", "standalone"])
    ap.add_argument("--encoding", default="raw", choices=["raw", "q8", "zlib"])
    ap.add_argument("--delta", action="store_true",
                    help="incremental checkpoints: ship only dirty chunks")
    ap.add_argument("--delta-chunk-kb", type=int, default=64)
    ap.add_argument("--delta-max-chain", type=int, default=8)
    ap.add_argument("--device-delta", action="store_true",
                    help="fingerprint-diff in device memory and gather only "
                         "dirty chunks to the host (requires --delta)")
    ap.add_argument("--interval-s", type=float, default=None)
    ap.add_argument("--phase-predictor", default="ema",
                    choices=["none", "ema", "gru"])
    ap.add_argument("--scratch", default="/tmp/veloc_train")
    ap.add_argument("--keep-versions", type=int, default=0,
                    help="retain only the newest N checkpoints (0 = all)")
    ap.add_argument("--max-age-s", type=float, default=None,
                    help="retire checkpoints older than this many seconds")
    ap.add_argument("--lane-weight", type=float, default=1.0,
                    help="fair-share weight of this job's backend lane "
                         "when the scratch/backend is shared")
    ap.add_argument("--lane-rate-share", type=float, default=None,
                    help="fraction (0,1] of the cluster flush budget "
                         "this job's lane may use")
    ap.add_argument("--admit-max-queued", type=int, default=None,
                    help="admission high-water mark: over this many "
                         "queued+running checkpoints, new ones skip")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="simulate node failure after this step")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.fail_at > 0 and args.mode == "off":
        ap.error("--fail-at needs checkpoints (--mode async or sync)")
    return args


def make_pipeline(args) -> PipelineSpec:
    """Single-host run, one rank: local write + external flush, no
    partner or XOR group."""
    modules = [ModuleSpec("interval", {"interval_s": args.interval_s}),
               ModuleSpec("serialize", {"encoding": args.encoding}),
               ModuleSpec("local"),
               ModuleSpec("flush")]
    if args.delta:
        modules.insert(1, ModuleSpec("delta", {
            "chunk_bytes": args.delta_chunk_kb * 1024,
            "max_chain": args.delta_max_chain}))
    return PipelineSpec(
        name=f"train-{args.arch}",
        mode="sync" if args.mode == "sync" else "async",
        modules=modules,
        phase_predictor=args.phase_predictor,
        device_delta=args.device_delta,
        keep_versions=args.keep_versions,
        max_age_s=args.max_age_s,
        lane_weight=args.lane_weight,
        lane_rate_share=args.lane_rate_share,
        admit_max_queued=args.admit_max_queued,
    )


def _restart(client, state, run: TrainRun, device: torch.device):
    t0 = time.perf_counter()
    v, restored = client.restart_latest(state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.restart_s.append(time.perf_counter() - t0)
    return v, restored


def _backlog(client) -> dict:
    """What the backend still holds: queued and running tasks."""
    if client.backend is None:
        return {}
    st = client.backend.status()
    return {k: st[k] for k in ("queued", "maintenance", "running")}


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    device = check_device(args.device)
    ops.set_device(device.type)
    cfg, shape = build(args.arch, args.smoke, args.seq_len, args.batch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    stream = SyntheticStream(cfg, shape, seed=1234, device=device)

    client = None
    if args.mode != "off":
        client = VelocClient(make_pipeline(args),
                             Cluster(TierTopology(scratch=args.scratch)))
    ds = DataStates(client.cluster) if client else None

    run = TrainRun()
    state = init_train_state(cfg, generator=gen, device=device)
    start_step = 0
    if args.resume and client is not None:
        v, restored = _restart(client, state, run, device)
        if v is not None:
            state, start_step = restored, v
            run.resumed_from = v
            run.resumed_state = snapshot_device(state).tree
            print(f"[veloc] resumed from checkpoint v{v}")
        else:
            print("[veloc] no checkpoint found; cold start")
            for d in client.restart_diagnostics:
                print(f"[veloc]   v{d['version']} ({d['level']}) skipped: "
                      f"{d['error']}")

    capture = args.capture == "fused" and args.mode != "off"
    step_fn = make_train_step(cfg, lr=args.lr, capture=capture)

    t_start = time.perf_counter()
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        if client:
            client.tick("step_begin")
            tick = time.perf_counter() - t0
        batch = stream.batch(step)
        if capture:
            state, snap, metrics = step_fn(state, batch)
        else:
            state, metrics = step_fn(state, batch)
            snap = None
        if client:
            t1 = time.perf_counter()
            client.tick("step_end")
            run.tick_s.append(tick + time.perf_counter() - t1)
        loss = float(metrics["loss"])
        run.losses.append(loss)
        if client and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            fut = client.checkpoint(state, version=step + 1, snap=snap,
                                    meta={"step": step + 1, "loss": loss})
            blocking = fut.results.get("app_blocking_s", 0)
            run.app_blocking_s.append(blocking)
            run.ckpt_results.append(fut.results)
            if ds and not fut.skipped:
                ds.record(step + 1, metrics={"loss": loss})
            print(f"step {step+1}: loss={loss:.4f} "
                  f"ckpt_blocking={blocking*1e3:.1f}ms"
                  f"{' (skipped)' if fut.skipped else ''}")
        elif (step + 1) % 10 == 0:
            print(f"step {step+1}: loss={loss:.4f}")
        run.step_s.append(time.perf_counter() - t0)

        if args.fail_at == step + 1:
            print(f"[failure-sim] killing node state at step {step+1}; "
                  f"restarting from newest checkpoint")
            t0 = time.perf_counter()
            if not client.wait(timeout=60):
                print(f"[veloc] pipeline not drained after 60 s: "
                      f"{_backlog(client)}")
            run.failure_wait_s = time.perf_counter() - t0
            v, restored = _restart(client, state, run, device)
            if v is None:
                raise RuntimeError("no restorable checkpoint!")
            state = restored
            run.recovered_version = v
            run.recovered_state = snapshot_device(state).tree
            print(f"[failure-sim] recovered at v{v}")

    dt = time.perf_counter() - t_start
    print(f"done: {args.steps - start_step} steps in {dt:.1f}s "
          f"({(args.steps - start_step) / max(dt, 1e-9):.2f} steps/s); "
          f"loss {run.losses[0]:.4f} -> {run.losses[-1]:.4f}")
    if client:
        t0 = time.perf_counter()
        if not client.wait(timeout=120):
            print(f"[veloc] pipeline not drained after 120 s: "
                  f"{_backlog(client)}")
        run.drain_s = time.perf_counter() - t0
        errs = client.backend.errors() if client.backend else []
        if errs:
            print("[veloc] backend errors:", errs[0][:400])
        client.shutdown()
    run.state = state
    return run


if __name__ == "__main__":
    main()
