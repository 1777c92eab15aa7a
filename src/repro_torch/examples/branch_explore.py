"""Productive checkpointing (paper §3): guided model exploration (the port
of ``examples/branch_explore.py``).

    PYTHONPATH=src python -m repro_torch.examples.branch_explore [--device cpu]

Training variations "share a common training path up until a point when they
begin to diverge" — checkpoint the trunk once, clone it into branches with
different hyper-parameters, train each from the shared snapshot, and use the
DataStates lineage to find and continue the best branch.

The port's train step updates its state in place, so every branch starts
from a tree freshly restored from the trunk's checkpoint, with a step of its
own learning rate.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ShapeCfg, get_config
from repro_torch.core import DataStates, ModuleSpec, PipelineSpec, VelocClient
from repro_torch.examples import parse_args, prepare
from repro_torch.train.data import SyntheticStream
from repro_torch.train.steps import init_train_state, make_train_step

LRS = (1e-4, 3e-4, 1e-3)


def config():
    return get_config("veloc-demo-100m").replace(
        num_layers=4, d_model=256, d_ff=1024, vocab_size=8000)


def main(argv=None, *, state=None) -> dict:
    """``state``: the trunk's initial train state (default: a seeded
    initialisation on the device); it is trained in place."""
    args = parse_args("branch", argv, __doc__)
    device = prepare(args)

    cfg = config()
    shape = ShapeCfg("ex", 128, 8, "train")
    stream = SyntheticStream(cfg, shape, seed=5, device=device)

    client = VelocClient(PipelineSpec(
        name="explore", mode="sync", keep_versions=20,
        modules=[ModuleSpec("serialize"), ModuleSpec("local"),
                 ModuleSpec("flush")]), scratch=args.scratch)
    ds = DataStates(client.cluster)

    def train(state, lr, start, steps):
        step_fn = make_train_step(cfg, lr=lr)
        loss = None
        for s in range(start, start + steps):
            state, m = step_fn(state, stream.batch(s))
            loss = float(m["loss"])
        return state, loss

    # --- trunk: shared training path ---------------------------------------
    if state is None:
        state = init_train_state(
            cfg, device=device,
            generator=torch.Generator(device).manual_seed(0))
    state, loss = train(state, 3e-4, 0, 8)
    trunk_loss = loss
    client.checkpoint(state, version=8, defensive=False,
                      meta={"phase": "trunk"})
    trunk = ds.record(8, metrics={"loss": loss})
    print(f"trunk @8 loss={loss:.4f}")

    # --- branches: clone the snapshot, vary the learning rate --------------
    template = init_train_state(cfg, device="meta",
                                generator=torch.Generator())
    results = {}
    for lr in LRS:
        branch = f"lr={lr:g}"
        ds.clone(trunk.id, branch)
        _, base = client.restart_latest(template)  # re-hydrate the trunk
        st, loss = train(base, lr, 8, 8)
        v = int(1000 * lr) + 100
        client.checkpoint(st, version=v, defensive=False,
                          meta={"branch": branch})
        ds.record(v, branch=branch, metrics={"loss": loss})
        results[branch] = loss
        print(f"branch {branch}: loss={loss:.4f}")

    # --- pick the winner via the lineage ------------------------------------
    best = ds.best("loss")
    print(f"best branch: {best.branch} (loss={best.metrics['loss']:.4f})")
    lineage = [f"{s.branch}@v{s.version}" for s in ds.lineage(best.id)]
    print("lineage:", " -> ".join(lineage))
    assert best.branch == min(results, key=results.get)
    client.shutdown()
    print("branch/explore example OK")
    return {"trunk_loss": trunk_loss, "results": results,
            "best": best.branch, "lineage": lineage}


if __name__ == "__main__":
    main()
