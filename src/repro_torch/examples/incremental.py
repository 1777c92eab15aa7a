"""Incremental (differential) checkpointing in one page (the port of
``examples/incremental.py``).

    PYTHONPATH=src python -m repro_torch.examples.incremental [--device cpu]

A training loop that touches ~1% of its state per step checkpoints every
step; the "delta" pipeline module fingerprints 64 KiB chunks with the
block-hash kernel and ships only the dirty ones.  The demo shows the
per-checkpoint bytes collapsing after the base version, a restart that
rebuilds the newest state by walking the delta chain (base + overlays,
per-chunk digests verified), and ``compact()`` folding the chain back into
a full shard so old versions can be garbage-collected.  The state is numpy,
as in the JAX package's script, so every shard is the same bytes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import VelocClient, VelocConfig
from repro_torch.core import restart as rst
from repro_torch.examples import parse_args, prepare


def main(argv=None) -> dict:
    args = parse_args("incremental", argv, __doc__)
    prepare(args)

    # delta=True slots the "delta" module between "interval" and
    # "serialize"; max_chain bounds restart latency: after 4 deltas the
    # next shard is full.
    client = VelocClient(VelocConfig(
        name="incr", scratch=args.scratch, mode="sync", delta=True,
        delta_chunk_bytes=64 * 1024, delta_max_chain=4,
        partner=False, xor_group=0, flush=True, keep_versions=10))

    rng = np.random.default_rng(0)
    state = {"w": rng.standard_normal(2 << 20).astype(np.float32),  # 8 MB
             "step": np.asarray(0)}

    table = []
    print(f"{'ver':>4} {'kind':>6} {'shard bytes':>12} {'dirty':>7}")
    for step in range(1, 8):
        # a step that dirties ~1% of the parameters
        w = state["w"].copy()
        lo = (step * 97_003) % (w.size - w.size // 100)
        w[lo:lo + w.size // 100] += 0.01
        state = {"w": w, "step": np.asarray(step)}
        fut = client.checkpoint(state, version=step, device_snapshot=False)
        r = fut.results
        table.append((step, r["delta_kind"], r["shard_bytes"],
                      r.get("delta_dirty_ratio", 1.0)))
        print(f"{step:>4} {r['delta_kind']:>6} {r['shard_bytes']:>12,} "
              f"{r.get('delta_dirty_ratio', 1.0):>7.2%}")

    # restart walks the chain: newest full base, overlay each delta, verify
    version, restored = client.restart_latest(state)
    assert restored["w"].numpy().tobytes() == state["w"].tobytes()
    chain = rst.chain_versions(client.cluster, "incr", version)
    print(f"\nrestored v{version} byte-identical via chain {chain}")

    # compaction folds the live chain into a full shard: restart latency
    # back to one read, ancestors become garbage-collectable
    client.compact()
    compacted = rst.chain_versions(client.cluster, "incr", version)
    print(f"after compact: chain {compacted}")
    client.cluster.gc("incr", 1)
    version2, restored2 = client.restart_latest(state)
    assert version2 == version
    assert restored2["w"].numpy().tobytes() == state["w"].tobytes()
    print(f"gc(keep=1) done; v{version2} still restores byte-identical")
    client.shutdown()
    print("incremental example OK")
    return {"table": table, "version": version, "chain": chain,
            "compacted": compacted, "version2": version2}


if __name__ == "__main__":
    main()
