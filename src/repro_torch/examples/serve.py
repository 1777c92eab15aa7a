"""Serve a small LM with batched greedy decoding + DeepClone-style live
state replication: the serving state (params + KV caches mid-flight) is
checkpointed asynchronously and re-hydrated into a "replica server" without
stopping request processing (paper §3, DeepClone [5]).  The port of
``examples/serve.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve [--device cpu]

Decode returns new cache tensors and never writes the params, so the state
handed to the checkpoint is not changed by the steps that follow it.  The
replica's template holds no memory: ``meta`` tensors, whose restored leaves
land on the package's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import ModuleSpec, PipelineSpec, VelocClient
from repro_torch.examples import parse_args, prepare
from repro_torch.models.model import cache_init, init_model, make_decode_fn

CLONE_POS = 11
STEPS = 24


def config():
    return get_config("veloc-demo-100m").replace(
        num_layers=4, d_model=256, d_ff=1024, vocab_size=8000)


def main(argv=None, *, params=None) -> dict:
    """``params``: the model's parameters (default: a seeded
    initialisation on the device)."""
    args = parse_args("serve", argv, __doc__)
    device = prepare(args)

    cfg = config()
    B, S = 4, 64
    if params is None:
        params = init_model(cfg, device=device,
                            generator=torch.Generator(device).manual_seed(0))
    decode = make_decode_fn(cfg)
    cache = cache_init(cfg, B, S, device=device)

    client = VelocClient(PipelineSpec(name="serve", mode="async", modules=[
        ModuleSpec("serialize"), ModuleSpec("local"), ModuleSpec("flush")]),
        scratch=args.scratch)

    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))
                           .astype(np.int32)).to(device)
    outputs, logits_rows = [tok], []
    with torch.no_grad():
        for pos in range(STEPS):
            logits, cache = decode(params, cache, tok, pos)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            outputs.append(tok)
            logits_rows.append(logits)
            if pos == CLONE_POS:
                # live replication: snapshot the FULL serving state
                # (weights + the in-flight KV caches) without pausing the
                # decode loop
                clone_fut = client.checkpoint(
                    {"params": params, "cache": cache, "tok": tok,
                     "pos": torch.tensor(pos, dtype=torch.int32,
                                         device=device)},
                    version=1, meta={"pos": pos})
                blocked_ms = clone_fut.results["app_blocking_s"] * 1e3
                print(f"cloned serving state @pos={pos} "
                      f"(blocked {blocked_ms:.2f} ms)")

        primary = torch.cat(outputs, dim=1)
        clone_fut.result(timeout=120)  # join the replication pipeline

        # --- replica server re-hydrates and continues the same streams ----
        template = {"params": init_model(cfg, device="meta",
                                         generator=torch.Generator()),
                    "cache": cache_init(cfg, B, S, device="meta"),
                    "tok": torch.empty((B, 1), dtype=torch.int32,
                                       device="meta"),
                    "pos": torch.empty((), dtype=torch.int32, device="meta")}
        v, snap = client.restart_latest(template)
        assert v == 1
        r_cache, r_tok = snap["cache"], snap["tok"]
        replica_out, replica_logits = [r_tok], []
        for pos in range(int(snap["pos"]) + 1, STEPS):
            logits, r_cache = decode(snap["params"], r_cache, r_tok, pos)
            r_tok = logits.argmax(-1)[:, None].to(torch.int32)
            replica_out.append(r_tok)
            replica_logits.append(logits)

    replica = torch.cat(replica_out, dim=1)
    # replica_out[0] is the token primary emitted at pos=11 (= primary[:, 12])
    np.testing.assert_array_equal(primary[:, 12:].cpu().numpy(),
                                  replica.cpu().numpy())
    print(f"replica continued {replica.shape[1]} tokens identically to "
          f"primary")
    client.shutdown()
    print("serve example OK")
    return {"primary": primary.cpu().numpy(),
            "replica": replica.cpu().numpy(),
            "logits": torch.stack(logits_rows, 1).float().cpu().numpy(),
            "replica_logits": torch.stack(replica_logits, 1).float().cpu()
            .numpy(),
            "blocked_ms": blocked_ms, "version": v}


if __name__ == "__main__":
    main()
