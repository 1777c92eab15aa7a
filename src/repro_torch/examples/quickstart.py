"""Quickstart: the VELOC v2 API in 50 lines (the port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The pipeline and the storage layout are *declarative*: a PipelineSpec lists
registered resilience modules + options, a TierTopology lists the storage
tiers, and checkpoint() returns a CheckpointFuture completion handle.
"""
from __future__ import annotations

import torch

from repro_torch.core import (Cluster, ModuleSpec, PipelineSpec, TierTopology,
                              VelocClient)
from repro_torch.examples import parse_args, prepare


def main(argv=None, *, w=None) -> dict:
    """``w``: the (256, 256) weight (default: a normal draw from a seeded
    ``torch.Generator`` on the device)."""
    args = parse_args("quickstart", argv, __doc__)
    device = prepare(args)

    # 1. declare the pipeline (async multi-level: L1 local write + L3
    #    external flush, zlib compression) and the tier layout (default DRAM
    #    + node SSD + shared PFS); new modules/tiers plug in via the
    #    registries.
    pipeline = PipelineSpec(name="quickstart", mode="async", modules=[
        ModuleSpec("serialize", {"encoding": "zlib"}),
        ModuleSpec("local"),
        ModuleSpec("flush"),
    ])
    client = VelocClient(pipeline, Cluster(TierTopology(scratch=args.scratch)))

    # 2. your application state: any tree of tensors
    if w is None:
        w = torch.randn((256, 256), device=device,
                        generator=torch.Generator(device).manual_seed(0))
    state = {
        "params": {"w": w.to(device),
                   "b": torch.zeros((256,), device=device)},
        "step": torch.tensor(0, dtype=torch.int32, device=device),
    }

    # 3. checkpoint: blocks only for the on-device snapshot; serialization,
    #    compression, checksumming and the external flush drain in the
    #    backend.  The returned CheckpointFuture tracks the in-flight
    #    pipeline.
    futures, blocking_ms = [], []
    for step in range(1, 4):
        state["step"] = torch.tensor(step, dtype=torch.int32, device=device)
        fut = client.checkpoint(state, version=step, meta={"step": step})
        futures.append(fut)
        blocking_ms.append(fut.results["app_blocking_s"] * 1e3)
        print(f"v{step}: app blocked {blocking_ms[-1]:.2f} ms")

    # join per level or whole-pipeline; result() surfaces backend errors
    assert futures[-1].wait_level("L1", timeout=60)  # local copy durable
    futures[-1].result(timeout=60)                   # whole pipeline drained
    levels = {"L1": futures[-1].level_event("L1").is_set(),
              "L3": futures[-1].level_event("L3").is_set()}
    print(f"v3 done={futures[-1].done()} levels: "
          f"L1={levels['L1']} L3={levels['L3']}")

    # 4. restart: newest restorable version, checksums verified on read
    version, restored = client.restart_latest(state)
    print(f"restored v{version}; step={int(restored['step'])}")
    assert version == 3 and int(restored["step"]) == 3

    # 5. the low-level VELOC-style API is also available
    client.protect("w", state["params"]["w"])
    client.checkpoint_begin(4)
    client.checkpoint_mem()
    client.checkpoint_end().result(timeout=60)
    print("low-level API checkpoint v4 done")
    client.shutdown()
    print("quickstart example OK")
    return {"blocking_ms": blocking_ms, "levels": levels, "version": version,
            "restored": restored}


if __name__ == "__main__":
    main()
