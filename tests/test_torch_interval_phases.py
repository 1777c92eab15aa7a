"""Interval optimization (Young/Daly + simulator + ML) and phase predictors.

The JAX package's ``tests/test_interval_phases.py`` run against
``repro_torch``, its imports swapped, with the port's own initialisation
(its generator, not ``jax.random``), on the CPU.  Below them the port is held
against ``repro`` on the same inputs: the closed form, the simulator and the
k-NN baseline to the bit; the GRU predictor and the interval MLP with the
JAX parameters carried across (``train.steps.gru_params_from_numpy``,
``interval_params_from_numpy``), within the tolerances stated there."""
import math

import numpy as np
import pytest

from repro_torch.core import concurrency as tconc
from repro_torch.core.interval import (KNNIntervalBaseline, LevelCfg,
                                       MLIntervalOptimizer,
                                       MultiLevelSimulator, ScenarioCfg,
                                       young_daly)
from repro_torch.core.phases import EMAPhasePredictor, GRUPhasePredictor
from repro_torch.kernels import ops


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


def test_young_daly():
    assert young_daly(10, 3600) == pytest.approx(math.sqrt(2 * 10 * 3600))
    assert young_daly(40, 3600) > young_daly(10, 3600)


def _scenario(mtbf=20_000.0):
    return ScenarioCfg(levels=[
        LevelCfg("L1", write_s=2.0, blocking_frac=1.0, mtbf_s=mtbf,
                 recovery_s=30.0),
        LevelCfg("L3", write_s=60.0, blocking_frac=0.05, mtbf_s=mtbf * 8,
                 recovery_s=300.0),
    ])


def test_simulator_efficiency_shape():
    """Efficiency must drop at both extreme intervals (checkpoint storms vs
    huge rollback losses) and peak somewhere in between."""
    sim = MultiLevelSimulator(_scenario(), horizon_s=100_000, seed=1)
    e_tiny = sim.efficiency(5.0, trials=8)
    e_best, _ = sim.best_interval(grid=np.geomspace(50, 10000, 10), trials=8)
    e_mid = sim.efficiency(e_best, trials=8)
    e_huge = sim.efficiency(90_000.0, trials=8)
    assert e_mid > e_tiny
    assert e_mid > e_huge
    assert 0.3 < e_mid <= 1.0


def test_simulator_more_failures_lower_efficiency():
    sim_good = MultiLevelSimulator(_scenario(mtbf=50_000), horizon_s=50_000, seed=2)
    sim_bad = MultiLevelSimulator(_scenario(mtbf=2_000), horizon_s=50_000, seed=2)
    assert sim_good.efficiency(1000, trials=8) > sim_bad.efficiency(1000, trials=8)


def _samples(n_scen=10, n_int=8, seed=0):
    rng = np.random.default_rng(seed)
    samples, scens = [], []
    for _ in range(n_scen):
        sc = _scenario(mtbf=float(rng.uniform(3_000, 60_000)))
        scens.append(sc)
        sim = MultiLevelSimulator(sc, horizon_s=60_000, seed=int(rng.integers(1e6)))
        for iv in np.geomspace(60, 15_000, n_int):
            samples.append((sc, float(iv), sim.efficiency(iv, trials=4)))
    return samples, scens


def test_ml_interval_learns_and_beats_knn():
    samples, scens = _samples()
    ml = MLIntervalOptimizer(hidden=48, seed=0)
    ml.fit(samples, epochs=500, lr=5e-3)
    knn = KNNIntervalBaseline(k=3)
    knn.fit(samples)
    # held-out scenario
    sc = _scenario(mtbf=17_000)
    sim = MultiLevelSimulator(sc, horizon_s=60_000, seed=99)
    grid = np.geomspace(60, 15_000, 16)
    truth_best, truth_eff = sim.best_interval(grid=grid, trials=6)
    ml_eff = sim.efficiency(ml.best_interval(sc, grid=grid), trials=6)
    knn_eff = sim.efficiency(knn.best_interval(sc, grid=grid), trials=6)
    # the ML pick must land within a few points of the simulated optimum
    assert ml_eff > truth_eff - 0.10, (ml_eff, truth_eff)
    assert ml_eff >= knn_eff - 0.05  # >= baseline (paper: NN > RF)


# ---------------------------------------------------------------------------
# phase predictors
# ---------------------------------------------------------------------------


def _drive(pred, durations, gap, n=30):
    t = 0.0
    for i in range(n):
        d = durations(i)
        pred.tick("step_begin", t)
        pred.tick("step_end", t + d)
        t += d + gap
    return t


def test_ema_predictor_periodic():
    p = EMAPhasePredictor(clock=lambda: 0.0)
    t = _drive(p, lambda i: 1.0, gap=0.5)
    assert p.predict_next_duration() == pytest.approx(1.0, abs=0.05)
    assert p.period == pytest.approx(1.5, abs=0.05)
    # right after a step begins -> busy, wait ~1s; inside the gap -> 0
    p.tick("step_begin", t)
    assert p.idle_wait(t + 0.1) == pytest.approx(0.9, abs=0.1)
    assert p.idle_wait(t + 1.2) == 0.0


def test_gru_predictor_tracks_alternating_pattern():
    """Alternating long/short steps: the GRU should beat plain EMA."""
    gru = GRUPhasePredictor(hidden=8, window=4, lr=0.08, clock=lambda: 0.0, seed=0)
    ema = EMAPhasePredictor(clock=lambda: 0.0)
    pat = lambda i: 2.0 if i % 2 == 0 else 0.5
    t = 0.0
    gru_err, ema_err = [], []
    for i in range(120):
        d = pat(i)
        for p in (gru, ema):
            p.tick("step_begin", t)
        pg = gru.predict_next_duration()
        pe = ema.predict_next_duration()
        if i > 60 and pg is not None and pe is not None:
            gru_err.append(abs(pg - d))
            ema_err.append(abs(pe - d))
        for p in (gru, ema):
            p.tick("step_end", t + d)
        t += d + 0.2
    assert np.mean(gru_err) < np.mean(ema_err)


# ---------------------------------------------------------------------------
# parity with the JAX package (same inputs, parameters carried across)
# ---------------------------------------------------------------------------

from repro.core import interval as jint  # noqa: E402
from repro.core import phases as jph  # noqa: E402
from repro_torch.core import interval as tint  # noqa: E402
from repro_torch.train.steps import (gru_params_from_numpy,  # noqa: E402
                                     interval_params_from_numpy)


def _numpy_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _pair_scenarios(seed=3, n=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mtbf = float(rng.uniform(2_000, 80_000))
        levels = [(f"L{j}", float(rng.uniform(0.5, 90)),
                   float(rng.uniform(0, 1)), mtbf * float(rng.uniform(1, 9)),
                   float(rng.uniform(5, 400))) for j in range(3)]
        interference = float(rng.uniform(0, 0.1))
        out.append(
            (jint.ScenarioCfg([jint.LevelCfg(*lv) for lv in levels],
                              interference),
             tint.ScenarioCfg([tint.LevelCfg(*lv) for lv in levels],
                              interference)))
    return out


def test_young_daly_and_simulator_equal_to_the_bit():
    for c, m in [(10, 3600), (2.5, 86_400), (60, 1e6)]:
        assert tint.young_daly(c, m) == jint.young_daly(c, m)
    for i, (jsc, tsc) in enumerate(_pair_scenarios()):
        js = jint.MultiLevelSimulator(jsc, horizon_s=40_000, seed=i)
        ts = tint.MultiLevelSimulator(tsc, horizon_s=40_000, seed=i)
        for iv in (0.0, 7.5, 333.0, 4_000.0, 50_000.0):
            assert ts.efficiency(iv, trials=3) == js.efficiency(iv, trials=3)
        grid = np.geomspace(40, 12_000, 7)
        assert ts.best_interval(grid=grid, trials=2) == \
            js.best_interval(grid=grid, trials=2)


def _parity_samples(seed=0):
    jsamples, tsamples = [], []
    for k, (jsc, tsc) in enumerate(_pair_scenarios(seed, n=6)):
        sim = jint.MultiLevelSimulator(jsc, horizon_s=30_000, seed=k)
        for iv in np.geomspace(60, 15_000, 8):
            e = sim.efficiency(iv, trials=2)
            jsamples.append((jsc, float(iv), e))
            tsamples.append((tsc, float(iv), e))
    return jsamples, tsamples


def test_knn_baseline_equal_to_the_bit():
    jsamples, tsamples = _parity_samples()
    jk, tk = jint.KNNIntervalBaseline(k=3), tint.KNNIntervalBaseline(k=3)
    jk.fit(jsamples)
    tk.fit(tsamples)
    (jsc, tsc), = _pair_scenarios(seed=11, n=1)
    for iv in np.geomspace(30, 20_000, 9):
        assert tk.predict_eff(tsc, iv) == jk.predict_eff(jsc, iv)
    assert tk.best_interval(tsc) == jk.best_interval(jsc)


def test_ml_interval_optimizer_matches_jax_after_fit():
    """A 20-epoch fit from the JAX initial parameters, with the same epoch
    permutations: ``predict_eff`` within 1e-4 absolute (measured on the CPU:
    at most 1.2e-7), the fitted loss within 1e-5 (measured: 4.5e-8), and
    ``best_interval``
    on the same grid point wherever the top two predictions differ by more
    than 1e-4."""
    jsamples, tsamples = _parity_samples()
    jml = jint.MLIntervalOptimizer(hidden=32, seed=5)
    tml = tint.MLIntervalOptimizer(hidden=32, seed=5, device="cpu")
    interval_params_from_numpy(tml, _numpy_params(jml.params))
    jl = jml.fit(jsamples, epochs=20, lr=5e-3, batch=16, seed=2)
    tl = tml.fit(tsamples, epochs=20, lr=5e-3, batch=16, seed=2)
    assert tl == pytest.approx(jl, abs=1e-5)
    for jsc, tsc in _pair_scenarios(seed=21, n=3):
        grid = np.geomspace(30, 20_000, 32)
        j = np.array([jml.predict_eff(jsc, g) for g in grid])
        t = np.array([tml.predict_eff(tsc, g) for g in grid])
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)
        top2 = np.sort(j)[-2:]
        if top2[1] - top2[0] > 1e-4:
            assert tml.best_interval(tsc, grid=grid) == \
                jml.best_interval(jsc, grid=grid)


def _duration_stream(n, seed=4):
    """Step durations (s): a two-phase pattern with noise and a few
    stalls, as a training loop with periodic evaluation shows."""
    rng = np.random.default_rng(seed)
    base = np.where(np.arange(n) % 5 == 4, 0.9, 0.3)
    noise = rng.normal(0, 0.02, n)
    stalls = np.where(rng.random(n) < 0.05, rng.uniform(0.5, 2.0, n), 0)
    return base + noise + stalls


def test_gru_predictor_matches_jax_tick_by_tick():
    """After each of 64 steps: ``predict_next_duration`` and ``idle_wait``
    at three instants within rtol 1e-4 of the JAX predictor's (measured on
    the CPU: at most 3.0e-7 for the prediction, 1.7e-5 for a wait, where
    the instant falls just short of the predicted end), from the same
    parameters and durations;
    the EMA fallback before the ninth duration is equal to the bit."""
    jg = jph.GRUPhasePredictor(seed=3, clock=lambda: 0.0)
    tg = GRUPhasePredictor(seed=3, clock=lambda: 0.0, device="cpu")
    gru_params_from_numpy(tg, _numpy_params(jg.params))
    t, gap = 0.0, 0.05
    for i, d in enumerate(_duration_stream(64)):
        for p in (jg, tg):
            p.tick("step_begin", t)
            p.tick("step_end", t + d)
        jd, td = jg.predict_next_duration(), tg.predict_next_duration()
        if i < jg.window:
            assert td == jd  # the EMA, before the GRU has a window
        else:
            assert td == pytest.approx(jd, rel=1e-4)
        for dt in (0.0, 0.1, d + gap / 2):
            assert tg.idle_wait(t + dt) == \
                pytest.approx(jg.idle_wait(t + dt), rel=1e-4, abs=0)
        t += d + gap
    assert len(tg._durs) == 64


def test_gru_parameters_after_ticks_match_jax():
    """The online SGD itself: after 40 steps the port's parameters are
    within 1e-5 of the JAX predictor's (measured on the CPU: 6.0e-7; the
    same replay windows: both draw them
    from ``np.random.default_rng(seed)``)."""
    jg = jph.GRUPhasePredictor(hidden=8, window=4, lr=0.08, seed=1,
                               clock=lambda: 0.0)
    tg = GRUPhasePredictor(hidden=8, window=4, lr=0.08, seed=1,
                           clock=lambda: 0.0, device="cpu")
    gru_params_from_numpy(tg, _numpy_params(jg.params))
    t = 0.0
    for d in _duration_stream(40, seed=9):
        for p in (jg, tg):
            p.tick("step_begin", t)
            p.tick("step_end", t + d)
        t += d + 0.1
    for k, v in _numpy_params(jg.params).items():
        np.testing.assert_allclose(tg.params[k].detach().numpy(), v,
                                   rtol=0, atol=1e-5)


def test_predictors_refuse_cuda_without_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda device is usable here")
    with pytest.raises(RuntimeError, match="no GPU"):
        GRUPhasePredictor(device="cuda")
    with pytest.raises(RuntimeError, match="no GPU"):
        MLIntervalOptimizer(device="cuda")
    ops.set_device("cuda")
    with pytest.raises(RuntimeError, match="no GPU"):
        GRUPhasePredictor()  # the package's device by default


def test_gru_reads_race_ticks_safely():
    """The backend's threads call ``idle_wait`` while the loop ticks: reads
    take the prediction the newest tick left (never the history itself),
    so 4 readers against 30 ticks see no error and only finite waits."""
    import sys
    import threading
    import time

    g = GRUPhasePredictor(hidden=8, window=4, clock=lambda: 0.0,
                          device="cpu")
    durs = _duration_stream(30, seed=5)
    stop = threading.Event()
    errors, waits = [], []

    def reader():
        try:
            while not stop.is_set():
                waits.append(g.idle_wait(1.0))
                g.predict_next_duration()
                time.sleep(1e-4)  # let the ticking thread run too
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    threads = [threading.Thread(target=reader) for _ in range(4)]
    try:
        for th in threads:
            th.start()
        t = 0.0
        for d in durs:
            g.tick("step_begin", t)
            g.tick("step_end", t + d)
            t += d + 0.05
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert waits and np.isfinite(waits).all() and min(waits) >= 0
