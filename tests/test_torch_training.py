"""End-to-end behaviour of the port's training workload with VELOC, on the
CPU: the JAX package's ``tests/test_system.py`` with its imports swapped
(restart exactness, async equals sync, small blocking, q8 restores close,
productive branching, the low-level API), plus the trainer
``repro_torch.launch.train`` through a simulated failure and ``--resume``,
and the fused capture's snapshot against the next step's in-place update.
The recurrent family: one xlstm-1.3b smoke train step against a jitted JAX
step, the trainer with ``--arch xlstm-1.3b`` through a failure and
``--resume``, and a recurrentgemma-2b train state (bf16 parameters, the
RG-LRU's f32 ``lam``) checkpointed by either package and restored by the
other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import smoke_config as jax_smoke_config
from repro.train import steps as jsteps

from repro_torch.configs.base import ShapeCfg, smoke_config
import repro_torch.core as sys_core
from repro_torch.core import DataStates, VelocClient, VelocConfig
from repro_torch.core import concurrency as tconc
from repro_torch.core import restart as rst
from repro_torch.core.capture import (leaves_with_paths, snapshot_device,
                                      tree_from_regions)
from repro_torch.kernels import ops
from repro_torch.launch import train as trainer
from repro_torch.train.data import SyntheticStream
from repro_torch.train.steps import (init_train_state, make_train_step,
                                     state_from_numpy, state_to_numpy)

SHAPE = ShapeCfg("sys", 64, 4, "train")


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


def _init(cfg, seed=0):
    return init_train_state(cfg, generator=torch.Generator().manual_seed(seed),
                            device="cpu")


def _run(cfg, client, steps, start_state=None, start=0, stream_seed=7,
         capture=True):
    stream = SyntheticStream(cfg, SHAPE, seed=stream_seed, device="cpu")
    state = start_state if start_state is not None else _init(cfg)
    step_fn = make_train_step(cfg, capture=capture)
    losses = []
    for s in range(start, steps):
        if capture:
            state, snap, m = step_fn(state, stream.batch(s))
        else:
            state, m = step_fn(state, stream.batch(s))
            snap = None
        losses.append(float(m["loss"]))
        if client is not None and (s + 1) % 3 == 0:
            client.checkpoint(state, version=s + 1, snap=snap,
                              meta={"step": s + 1})
    return state, losses


def _leaves(tree):
    return [t for _, t in leaves_with_paths(tree)]


def _assert_bitwise_equal(a, b):
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_restart_is_bitwise_exact(tmp_path):
    """Train 9 steps with checkpoints; resume from v6 and recompute 7..9;
    final params must equal the uninterrupted run bitwise (deterministic
    stream + deterministic step on the CPU)."""
    cfg = smoke_config("veloc-demo-100m")
    vc = VelocConfig(scratch=str(tmp_path), mode="sync", partner=False,
                     xor_group=0, keep_versions=10)
    client = VelocClient(vc)
    final, _ = _run(cfg, client, steps=9)

    template = _init(cfg)
    v, resumed = client.restart_latest(template)
    assert v == 9
    _assert_bitwise_equal(resumed, final)

    regs6 = rst.load_rank_regions(client.cluster, vc.name, 6, 0)
    state6 = tree_from_regions(template, regs6)
    replay, _ = _run(cfg, None, steps=9, start_state=state6, start=6)
    _assert_bitwise_equal(final["params"], replay["params"])


def test_async_checkpoint_equals_sync(tmp_path):
    """The async pipeline must persist exactly the same bytes as sync."""
    cfg = smoke_config("veloc-demo-100m")
    state = _init(cfg, 3)
    outs = {}
    for mode in ("sync", "async"):
        vc = VelocConfig(scratch=str(tmp_path / mode), mode=mode,
                         partner=False, xor_group=0)
        c = VelocClient(vc)
        c.checkpoint(state, version=1)
        assert c.wait(1, timeout=60)
        if c.backend:
            assert not c.backend.errors()
        blob = c.cluster.fetch_shard(vc.name, 1, 0)
        assert blob is not None
        outs[mode] = blob
        c.shutdown()
    assert outs["sync"] == outs["async"]


def test_async_blocking_time_is_small(tmp_path):
    """VELOC semantics: the app blocks for the L1 snapshot only."""
    cfg = smoke_config("veloc-demo-100m")
    state = _init(cfg, 1)
    vc = VelocConfig(scratch=str(tmp_path), mode="async", partner=False,
                     xor_group=0, encoding="zlib")
    c = VelocClient(vc)
    snap = snapshot_device(state)  # what the fused capture hands over
    ctx = c.checkpoint(state, version=1, snap=snap)
    blocking = ctx.results["app_blocking_s"]
    assert c.wait(1, timeout=60)
    assert blocking < 0.5  # serialize+compress+write happen in the backend
    c.shutdown()


def test_quantized_checkpoint_restores_close(tmp_path):
    cfg = smoke_config("veloc-demo-100m")
    state = _init(cfg, 2)
    vc = VelocConfig(scratch=str(tmp_path), mode="sync", partner=False,
                     xor_group=0, encoding="q8")
    c = VelocClient(vc)
    c.checkpoint(state, version=1)
    v, restored = c.restart_latest(state)
    assert v == 1
    for a, b in zip(_leaves(state["params"]), _leaves(restored["params"])):
        a, b = a.float().numpy(), b.float().numpy()
        scale = max(np.abs(a).max(), 1e-6)
        assert np.abs(a - b).max() / scale < 0.02


def test_productive_branching(tmp_path):
    """DataStates branch/explore: clone a snapshot, train two branches, the
    lineage records both and best() finds the better one."""
    cfg = smoke_config("veloc-demo-100m")
    vc = VelocConfig(scratch=str(tmp_path), mode="sync", partner=False,
                     xor_group=0, keep_versions=20)
    client = VelocClient(vc)
    ds = DataStates(client.cluster)
    state, losses = _run(cfg, client, steps=3)
    root = ds.record(3, metrics={"loss": losses[-1]})

    _, base = client.restart_latest(_init(cfg))
    for branch, seed in (("lr-a", 11), ("lr-b", 12)):
        ds.clone(root.id, branch)
        start = snapshot_device(base).tree  # each branch trains in place
        st, ls = _run(cfg, None, steps=6, start_state=start, start=3,
                      stream_seed=seed)
        client.checkpoint(st, version=100 + seed, defensive=False)
        ds.record(100 + seed, branch=branch, metrics={"loss": ls[-1]})
    best = ds.best("loss")
    assert best is not None
    tips = ds.search(lambda s: s.branch == "lr-a" and "clone" not in s.tags)
    assert len(tips) == 1
    assert len(ds.lineage(tips[0].id)) == 3  # root -> clone -> tip
    assert ds.lineage(tips[0].id)[0].branch == "main"


def test_low_level_veloc_api(tmp_path):
    """The paper's C-style API: protect / checkpoint_begin / mem / end."""
    vc = VelocConfig(scratch=str(tmp_path), mode="sync", partner=False,
                     xor_group=0)
    c = VelocClient(vc)
    w = torch.arange(100, dtype=torch.float32)
    b = torch.ones((5,), dtype=torch.float32)
    c.protect("w", w)
    c.protect("b", b)
    c.checkpoint_begin(1)
    c.checkpoint_mem()
    ctx = c.checkpoint_end()
    assert not ctx.skipped
    regs = rst.load_rank_regions(c.cluster, vc.name, 1, 0)
    np.testing.assert_array_equal(regs["w/"], w.numpy())
    np.testing.assert_array_equal(regs["b/"], b.numpy())


def test_snapshot_holds_step_k_while_step_k1_updates_in_place(tmp_path):
    """The fused capture's snapshot of step k keeps step k's bytes while
    step k+1 updates the live state in place, and the async checkpoint of
    that snapshot, drained after step k+1, persists step k's bytes."""
    cfg = smoke_config("veloc-demo-100m")
    stream = SyntheticStream(cfg, SHAPE, seed=5, device="cpu")
    state = _init(cfg, 4)
    step_fn = make_train_step(cfg, capture=True)
    state, snap, _ = step_fn(state, stream.batch(0))
    k_bytes = [t.clone() for t in _leaves(state)]
    live = _leaves(state)
    vc = VelocConfig(scratch=str(tmp_path), mode="async", partner=False,
                     xor_group=0)
    c = VelocClient(vc)
    fut = c.checkpoint(state, version=1, snap=snap)
    state, snap2, _ = step_fn(state, stream.batch(1))
    # the live tensors were updated in place: same storage, new bytes
    assert all(a is b for a, b in zip(live, _leaves(state)))
    assert not torch.equal(live[0], k_bytes[0])
    for want, got in zip(k_bytes, _leaves(snap.tree)):
        assert torch.equal(want, got)
    assert c.wait(1, timeout=60) and fut.done()
    v, restored = c.restart_latest(state)
    assert v == 1
    for want, got in zip(k_bytes, _leaves(restored)):
        assert torch.equal(want, got)
    assert int(restored["opt"]["step"]) == 1
    c.shutdown()


def test_trainer_recovers_and_resumes(tmp_path, capsys):
    """``launch.train`` on the CPU: checkpoints every 4 steps, a simulated
    failure after step 10 recovers v8 (equal to v8 read back by a fresh
    client), and ``--resume`` picks up the newest version."""
    common = ["--arch", "veloc-demo-100m", "--smoke", "--device", "cpu",
              "--ckpt-every", "4", "--scratch", str(tmp_path),
              "--seq-len", "32", "--batch", "2"]
    run = trainer.main(common + ["--steps", "12", "--fail-at", "10"])
    out = capsys.readouterr().out
    assert "[failure-sim] recovered at v8" in out
    assert len(run.losses) == 12 and np.isfinite(run.losses).all()
    assert len(run.step_s) == 12 and len(run.app_blocking_s) == 3
    assert run.recovered_version == 8 and len(run.restart_s) == 1
    assert run.drain_s is not None

    args = trainer.parse_args(common)
    fresh = VelocClient(trainer.make_pipeline(args),
                        trainer.Cluster(trainer.TierTopology(
                            scratch=str(tmp_path))))
    regs = rst.load_rank_regions(fresh.cluster, fresh.name, 8, 0)
    _assert_bitwise_equal(run.recovered_state,
                          tree_from_regions(run.state, regs))
    v, latest = fresh.restart_latest(run.state)
    assert v == 12
    _assert_bitwise_equal(latest, run.state)
    # v8 was restored after step 10 and steps 11-12 ran on it, as the JAX
    # trainer does: v12 holds 10 optimizer steps
    assert int(latest["opt"]["step"]) == 10
    fresh.shutdown()

    resumed = trainer.main(common + ["--steps", "14", "--resume"])
    assert "[veloc] resumed from checkpoint v12" in capsys.readouterr().out
    assert resumed.resumed_from == 12 and len(resumed.losses) == 2
    _assert_bitwise_equal(resumed.resumed_state, latest)
    assert int(resumed.state["opt"]["step"]) == 12


def test_trainer_off_mode_matches_checkpointed_losses(tmp_path):
    """Checkpointing does not perturb training: the same steps with and
    without checkpoints give bitwise equal losses on the CPU."""
    common = ["--arch", "veloc-demo-100m", "--smoke", "--device", "cpu",
              "--steps", "6", "--ckpt-every", "2", "--seq-len", "32",
              "--batch", "2", "--scratch", str(tmp_path)]
    on = trainer.main(common + ["--mode", "async"])
    off = trainer.main(common + ["--mode", "off"])
    assert on.losses == off.losses
    assert off.app_blocking_s == [] and off.drain_s is None
    with pytest.raises(SystemExit):
        trainer.parse_args(common + ["--mode", "off", "--fail-at", "3"])


def test_trainer_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda device is usable here")
    with pytest.raises(RuntimeError, match="no GPU"):
        trainer.main(["--smoke", "--steps", "1", "--scratch", str(tmp_path)])


def test_trainer_gru_phase_predictor_raises(tmp_path, capsys):
    """``--phase-predictor gru`` trains the GRU gate on the trainer's
    device: on the CPU the run recovers from its simulated failure; a CUDA
    device with no GPU raises, in the trainer and in the predictor."""
    run = trainer.main(["--arch", "veloc-demo-100m", "--smoke", "--device",
                        "cpu", "--phase-predictor", "gru", "--steps", "12",
                        "--ckpt-every", "4", "--fail-at", "10",
                        "--seq-len", "32", "--batch", "2",
                        "--scratch", str(tmp_path)])
    assert "[failure-sim] recovered at v8" in capsys.readouterr().out
    assert run.recovered_version == 8 and np.isfinite(run.losses).all()
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no GPU"):
        trainer.main(["--smoke", "--steps", "1", "--phase-predictor", "gru",
                      "--scratch", str(tmp_path / "cuda")])
    from repro_torch.core.phases import GRUPhasePredictor
    with pytest.raises(RuntimeError, match="no GPU"):
        GRUPhasePredictor(device="cuda")


# ---------------------------------------------------------------------------
# the recurrent family
# ---------------------------------------------------------------------------


def test_xlstm_train_step_matches_jax_step():
    """One port train step from the JAX state equals one jitted JAX step,
    xlstm-1.3b smoke in f32.  The stacked mLSTM blocks magnify rounding
    (``test_torch_models``): gradients agree within 1e-3 of a leaf's
    largest element, so m within that times (1 - b1), v = (1 - b2) g^2
    within 2 (1 - b2) |g| times that, and the parameters, which Adam's first step moves by lr * g / (|g| +
    eps) ~ lr * sign(g), within rtol 1e-5 where |g| exceeds 1e-2 of the
    leaf's largest gradient and within the update's bound (2 * lr)
    everywhere."""
    jcfg = jax_smoke_config("xlstm-1.3b").replace(compute_dtype="float32")
    tcfg = smoke_config("xlstm-1.3b").replace(compute_dtype="float32")
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jnew, jm = jax.jit(jsteps.make_train_step(jcfg, lr=1e-3))(
        jstate, {"tokens": jnp.asarray(toks)})
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    tnew, tm = make_train_step(tcfg, lr=1e-3)(
        tstate, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    got = dict(leaves_with_paths(state_to_numpy(tnew)))
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jnew)))
    assert sorted(got) == sorted(want)
    assert int(got["opt/step"]) == int(want["opt/step"]) == 1
    for name, w in want.items():
        if not name.startswith("params/"):
            continue
        m = want["opt/m/" + name[len("params/"):]]
        g = np.abs(m) / 0.1  # the first m is (1 - b1) * g
        gmax = g.max()
        np.testing.assert_allclose(got["opt/m/" + name[7:]], m, rtol=1e-3,
                                   atol=1e-4 * gmax, err_msg=name)
        np.testing.assert_allclose(got["opt/v/" + name[7:]],
                                   want["opt/v/" + name[7:]], rtol=2e-3,
                                   atol=1e-4 * gmax ** 2, err_msg=name)
        big = g > 1e-2 * gmax
        np.testing.assert_allclose(got[name][big], w[big], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(got[name], w, rtol=0, atol=2e-3,
                                   err_msg=name)


def test_xlstm_trainer_recovers_and_resumes(tmp_path, capsys):
    """``launch.train --arch xlstm-1.3b --smoke --device cpu``: a failure
    after step 5 recovers v4, equal to v4 as a fresh client reads it, and
    ``--resume`` picks up v6."""
    common = ["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu",
              "--ckpt-every", "2", "--scratch", str(tmp_path),
              "--seq-len", "16", "--batch", "2"]
    run = trainer.main(common + ["--steps", "6", "--fail-at", "5"])
    assert "[failure-sim] recovered at v4" in capsys.readouterr().out
    assert run.recovered_version == 4 and np.isfinite(run.losses).all()
    fresh = VelocClient(trainer.make_pipeline(trainer.parse_args(common)),
                        trainer.Cluster(trainer.TierTopology(
                            scratch=str(tmp_path))))
    regs = rst.load_rank_regions(fresh.cluster, fresh.name, 4, 0)
    _assert_bitwise_equal(run.recovered_state,
                          tree_from_regions(run.state, regs))
    v, latest = fresh.restart_latest(run.state)
    assert v == 6
    _assert_bitwise_equal(latest, run.state)
    fresh.shutdown()
    resumed = trainer.main(common + ["--steps", "7", "--resume"])
    assert "[veloc] resumed from checkpoint v6" in capsys.readouterr().out
    assert resumed.resumed_from == 6 and len(resumed.losses) == 1
    _assert_bitwise_equal(resumed.resumed_state, latest)


_CORE = {"jax": jcore, "torch": sys_core}


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_recurrentgemma_state_crosses_packages(tmp_path, writer, reader):
    """A recurrentgemma-2b smoke train state with bf16 parameters (the
    RG-LRU block nested under ``mix``, its ``lam`` f32) checkpointed by one
    package restores through the other in a fresh cluster, leaf for leaf
    and bit for bit, and both packages write the same shard bytes."""
    cfg = jax_smoke_config("recurrentgemma-2b").replace(
        param_dtype="bfloat16")
    jstate = jax.tree.map(np.asarray,
                          jsteps.init_train_state(jax.random.PRNGKey(3), cfg))
    lam = jstate["params"]["blocks"][0]["mix"]["lam"]
    assert lam.dtype == np.float32
    assert str(jstate["params"]["emb"].dtype) == "bfloat16"
    inputs = {"jax": jstate, "torch": state_from_numpy(jstate, "cpu")}
    shards = {}
    for pkg in (writer, reader):
        core = _CORE[pkg]
        vc = core.VelocConfig(scratch=str(tmp_path / pkg), mode="sync",
                              partner=False, xor_group=0)
        c = core.VelocClient(vc)
        c.checkpoint(inputs[pkg], version=1)
        shards[pkg] = c.cluster.fetch_shard(vc.name, 1, 0)
        c.shutdown()
    assert shards[writer] is not None and shards[writer] == shards[reader]
    core = _CORE[reader]
    vc = core.VelocConfig(scratch=str(tmp_path / writer), mode="sync",
                          partner=False, xor_group=0)
    c = core.VelocClient(vc)
    v, restored = c.restart_latest(inputs[reader])
    c.shutdown()
    assert v == 1, c.restart_diagnostics
    got = state_to_numpy(restored) if reader == "torch" else \
        jax.tree.map(np.asarray, restored)
    want = dict(leaves_with_paths(jstate))
    got = dict(leaves_with_paths(got))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8), name)
