"""Checkpoint-interval optimization (paper §2, "ML-Optimized Checkpoint
Intervals", ref [1]).

Three estimators of the optimal defensive-checkpoint interval:

  young_daly            — closed form sqrt(2*C*M); exact only for single-
                          level blocking checkpoints (the paper's point is
                          that async multi-level breaks it).
  MultiLevelSimulator   — event simulation of a multi-level async run:
                          per-level checkpoint costs/blocking fractions,
                          per-level failure rates and recovery costs;
                          returns expected efficiency (useful/total time).
  MLIntervalOptimizer   — samples (config, interval) -> efficiency pairs
                          from the simulator, fits a small MLP (an
                          ``nn.Module`` on an explicit device, SGD with
                          ``torch.autograd``), and searches the model
                          instead of the simulator — filling the
                          scenario-space gaps, as ref [1]'s neural model
                          does (reported to beat random forests; a k-NN
                          baseline is below).

The closed form, the simulator and the k-NN baseline are numpy, exactly as
the JAX package computes them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops


def young_daly(ckpt_cost_s: float, mtbf_s: float) -> float:
    return math.sqrt(2.0 * ckpt_cost_s * mtbf_s)


@dataclass
class LevelCfg:
    """One resilience level in the simulator."""
    name: str
    write_s: float          # total time to make this level durable
    blocking_frac: float    # fraction of write_s the app is blocked
    mtbf_s: float           # mean time between failures this level absorbs
    recovery_s: float       # restart cost when recovering from this level


@dataclass
class ScenarioCfg:
    levels: list[LevelCfg]
    interference: float = 0.02  # app slowdown while background I/O active


class MultiLevelSimulator:
    """Expected efficiency of an async multi-level checkpointing run."""

    def __init__(self, scenario: ScenarioCfg, horizon_s: float = 200_000.0,
                 seed: int = 0):
        self.sc = scenario
        self.horizon = horizon_s
        self.seed = seed

    def efficiency(self, interval_s: float, trials: int = 24) -> float:
        if interval_s <= 0:
            return 0.0
        rng = np.random.default_rng((self.seed, int(interval_s * 1000) & 0xFFFF))
        effs = []
        for _ in range(trials):
            effs.append(self._one(interval_s, rng))
        return float(np.mean(effs))

    def _one(self, interval: float, rng) -> float:
        sc = self.sc
        t = 0.0
        useful = 0.0
        # independent exponential failure streams per level
        next_fail = [t + rng.exponential(lv.mtbf_s) for lv in sc.levels]
        last_ckpt = 0.0  # useful-work timestamp of the newest durable ckpt
        pending: list[tuple[float, int, float]] = []  # (done_at, level, work_mark)
        while t < self.horizon:
            # advance one checkpoint period
            block = sum(lv.write_s * lv.blocking_frac for lv in sc.levels)
            bg = sum(lv.write_s * (1 - lv.blocking_frac) for lv in sc.levels)
            seg = interval + block + bg * sc.interference
            seg_end = t + seg
            nf = min(next_fail)
            li = next_fail.index(nf)
            if nf >= seg_end:
                # period completes; async levels become durable shortly after
                work_mark = useful + interval
                done = seg_end + bg
                pending.append((done, li, work_mark))
                pending = [(d, l, w) for d, l, w in pending if d > t] or pending
                # retire completed async work
                newly = [w for d, l, w in pending if d <= seg_end]
                if newly:
                    last_ckpt = max([last_ckpt] + newly)
                pending = [(d, l, w) for d, l, w in pending if d > seg_end]
                useful += interval
                t = seg_end
            else:
                # failure mid-period: roll back to newest durable checkpoint
                newly = [w for d, l, w in pending if d <= nf]
                if newly:
                    last_ckpt = max([last_ckpt] + newly)
                pending = []
                lv = sc.levels[min(li, len(sc.levels) - 1)]
                t = nf + lv.recovery_s
                useful = last_ckpt
                next_fail[li] = t + rng.exponential(sc.levels[li].mtbf_s)
        return max(useful, 0.0) / self.horizon

    def best_interval(self, grid=None, trials: int = 24) -> tuple[float, float]:
        grid = grid if grid is not None else np.geomspace(30, 20_000, 24)
        best = max(((self.efficiency(g, trials), g) for g in grid))
        return best[1], best[0]


# ---------------------------------------------------------------------------
# ML interval predictor
# ---------------------------------------------------------------------------


def _scenario_features(sc: ScenarioCfg, interval: float) -> np.ndarray:
    f = [math.log(interval)]
    for lv in sc.levels[:3]:
        f += [math.log(max(lv.write_s, 1e-3)), lv.blocking_frac,
              math.log(lv.mtbf_s), math.log(max(lv.recovery_s, 1e-3))]
    while len(f) < 1 + 3 * 4:
        f.append(0.0)
    f.append(sc.interference)
    return np.asarray(f, np.float32)


class _MLP(nn.Module):
    """14 -> hidden -> hidden -> 1: tanh, tanh, sigmoid."""

    def __init__(self, d_in: int, hidden: int, generator: torch.Generator,
                 device: torch.device):
        super().__init__()

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=device)

        self.w1 = nn.Parameter(normal(d_in, hidden) / math.sqrt(d_in))
        self.b1 = nn.Parameter(torch.zeros(hidden, device=device))
        self.w2 = nn.Parameter(normal(hidden, hidden) / math.sqrt(hidden))
        self.b2 = nn.Parameter(torch.zeros(hidden, device=device))
        self.w3 = nn.Parameter(normal(hidden, 1) / math.sqrt(hidden))
        self.b3 = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ self.w1 + self.b1)
        h = torch.tanh(h @ self.w2 + self.b2)
        return torch.sigmoid(h @ self.w3 + self.b3)[..., 0]


class MLIntervalOptimizer:
    """MLP regression efficiency(scenario, interval); trained on simulator
    samples, then searched on a dense interval grid.  The model lives on
    ``device`` (the package's device when None); a CUDA device with no GPU
    raises."""

    def __init__(self, hidden: int = 64, seed: int = 0, device=None):
        dev = self.device = ops.check_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.net = _MLP(1 + 3 * 4 + 1, hidden, gen, dev)
        self._mu = None
        self._sd = None

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.net.named_parameters())

    def fit(self, samples: list[tuple[ScenarioCfg, float, float]],
            epochs: int = 300, lr: float = 3e-3, batch: int = 64,
            seed: int = 0) -> float:
        X = np.stack([_scenario_features(sc, iv) for sc, iv, _ in samples])
        y = np.asarray([e for _, _, e in samples], np.float32)
        self._mu, self._sd = X.mean(0), X.std(0) + 1e-6
        Xn = torch.from_numpy((X - self._mu) / self._sd).to(self.device)
        yd = torch.from_numpy(y).to(self.device)
        params = list(self.net.parameters())
        rng = np.random.default_rng(seed)
        n = len(y)
        last = torch.zeros((), device=self.device)
        for _ in range(epochs):
            idx = torch.from_numpy(rng.permutation(n)).to(self.device)
            for i in range(0, n, batch):
                sl = idx[i:i + batch]
                with torch.enable_grad():
                    loss = torch.mean((self.net(Xn[sl]) - yd[sl]) ** 2)
                grads = torch.autograd.grad(loss, params)
                with torch.no_grad():
                    for p, g in zip(params, grads):
                        p.sub_(lr * g)
                last = loss.detach()
        return float(last)

    def _features(self, sc: ScenarioCfg, intervals) -> torch.Tensor:
        x = np.stack([_scenario_features(sc, iv) for iv in intervals])
        return torch.from_numpy((x - self._mu) / self._sd).to(self.device)

    def predict_eff(self, sc: ScenarioCfg, interval: float) -> float:
        with torch.no_grad():
            return float(self.net(self._features(sc, [interval]))[0])

    def best_interval(self, sc: ScenarioCfg, grid=None) -> float:
        """The grid point of the largest predicted efficiency (the first
        on a tie), from one batched forward over the grid."""
        grid = grid if grid is not None else np.geomspace(30, 20_000, 64)
        grid = [float(g) for g in grid]
        with torch.no_grad():
            effs = self.net(self._features(sc, grid))
        return grid[int(torch.argmax(effs))]


class KNNIntervalBaseline:
    """k-nearest-neighbour baseline (stand-in for the paper's non-NN
    baselines such as random forest)."""

    def __init__(self, k: int = 5):
        self.k = k
        self._X = None
        self._y = None

    def fit(self, samples):
        self._X = np.stack([_scenario_features(sc, iv) for sc, iv, _ in samples])
        self._mu, self._sd = self._X.mean(0), self._X.std(0) + 1e-6
        self._X = (self._X - self._mu) / self._sd
        self._y = np.asarray([e for _, _, e in samples], np.float32)

    def predict_eff(self, sc, interval):
        x = (_scenario_features(sc, interval) - self._mu) / self._sd
        d = np.linalg.norm(self._X - x, axis=1)
        idx = np.argsort(d)[: self.k]
        return float(self._y[idx].mean())

    def best_interval(self, sc, grid=None):
        grid = grid if grid is not None else np.geomspace(30, 20_000, 64)
        return float(max(grid, key=lambda g: self.predict_eff(sc, g)))
