"""Application-phase prediction for interference-free background I/O
(paper §2: iterative HPC apps are predictable; schedule background ops into
windows where they use resources the app does not).

Two predictors over the stream of (step_start, step_end) events the
training loop reports via ``tick()``:

  EMAPhasePredictor — exponential moving average of step duration + period;
      predicts the next compute-busy window.
  GRUPhasePredictor — tiny GRU trained online (SGD, ``torch.autograd``) on
      the normalized duration sequence; the paper's seq2seq-style predictor
      [6].  Falls back to the EMA until it has enough history.

``idle_wait()`` returns how long a background chunk transfer should wait to
land inside the predicted gap between steps — used as the ActiveBackend
phase gate.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops


class EMAPhasePredictor:
    def __init__(self, alpha: float = 0.2, clock=time.monotonic):
        self.alpha = alpha
        self._clock = clock
        self.step_dur = None  # busy time within a step
        self.period = None  # start-to-start
        self._last_start = None
        self._last_end = None

    def tick(self, phase: str, t: Optional[float] = None):
        """phase in {"step_begin", "step_end"}."""
        t = self._clock() if t is None else t
        if phase == "step_begin":
            if self._last_start is not None:
                p = t - self._last_start
                self.period = p if self.period is None else \
                    (1 - self.alpha) * self.period + self.alpha * p
            self._last_start = t
        elif phase == "step_end":
            if self._last_start is not None:
                d = t - self._last_start
                self.step_dur = d if self.step_dur is None else \
                    (1 - self.alpha) * self.step_dur + self.alpha * d
            self._last_end = t

    def predict_next_duration(self) -> Optional[float]:
        return self.step_dur

    def idle_wait(self, t: Optional[float] = None) -> float:
        """Seconds until the next predicted idle (gap) window.  0 = go now."""
        if None in (self.step_dur, self.period, self._last_start):
            return 0.0
        t = self._clock() if t is None else t
        into = (t - self._last_start) % max(self.period, 1e-9)
        if into >= self.step_dur:  # already in the gap
            return 0.0
        return self.step_dur - into


_GRU_KEYS = ("wz", "wr", "wh", "wo")


class _Prediction:
    """One tick's GRU output.  On the CPU it is a float already; on a CUDA
    device it lands in pinned memory behind ``event`` and is read once, by
    whichever thread asks first (the reads agree: each tick has its own
    buffer)."""

    def __init__(self, value=None, event=None, host=None, keep=None):
        self._value = value
        self._event = event
        self._host = host
        self._keep = keep  # the pinned input, alive until its copy is done

    def value(self) -> float:
        if self._value is None:
            self._event.synchronize()
            self._value = float(self._host[0])
            self._keep = None
        return self._value


class GRUPhasePredictor(EMAPhasePredictor):
    """Online GRU forecaster of step durations (ML-based phase prediction).

    Each ``step_end`` tick with more than ``window`` durations takes one SGD
    step per window, in sequence — the newest window, then ``replay``
    windows drawn by ``np.random.default_rng(seed)`` — and then predicts the
    next duration from the newest window.  Parameters and history change
    only in ``tick``, so the prediction is computed there, once, and every
    ``predict_next_duration``/``idle_wait`` until the next tick reads it.

    On the CPU the tick runs eagerly (the plain version).  On a CUDA device
    it runs on a stream of its own, as one CUDA graph per tick shape (one
    window, or ``1 + replay``), captured at construction: the loop's thread
    issues an input copy, the graph and an output copy, and never waits for
    the device; the first read of the prediction waits on its event."""

    def __init__(self, hidden: int = 16, window: int = 8, lr: float = 0.05,
                 replay: int = 6, clock=time.monotonic, seed: int = 0,
                 device=None):
        super().__init__(clock=clock)
        self.window = window
        self.hidden = hidden
        self.lr = lr
        self.replay = replay
        self.device = ops.check_device(device)
        self._rng = np.random.default_rng(seed)
        self._durs: deque[float] = deque(maxlen=256)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        s = 0.5 / math.sqrt(hidden)
        shapes = {"wz": (1 + hidden, hidden), "wr": (1 + hidden, hidden),
                  "wh": (1 + hidden, hidden), "wo": (hidden, 1)}
        self.params = {
            k: (torch.randn(shapes[k], generator=gen, device=self.device)
                * s).requires_grad_()
            for k in _GRU_KEYS}
        self._lr = torch.tensor(lr, dtype=torch.float32, device=self.device)
        self._scale = None
        self._pred: Optional[_Prediction] = None
        self._stream = None
        self._graphs: dict[int, tuple] = {}
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            for n in sorted({1, 1 + replay}):
                self._capture(n)

    @staticmethod
    def _forward(params, seq):
        h = seq.new_zeros(params["wo"].shape[0])
        for i in range(seq.shape[0]):
            x = seq[i:i + 1]
            xi = torch.cat([x, h])
            z = torch.sigmoid(xi @ params["wz"])
            r = torch.sigmoid(xi @ params["wr"])
            xi2 = torch.cat([x, r * h])
            cand = torch.tanh(xi2 @ params["wh"])
            h = (1 - z) * h + z * cand
        return (h @ params["wo"])[0]

    def _tick_body(self, buf: torch.Tensor, n: int) -> torch.Tensor:
        """``n`` SGD steps on the windows laid out in ``buf`` (each
        ``window`` inputs then the target), then the forward of the newest
        window (``buf``'s last ``window`` values)."""
        w = self.window
        params = [self.params[k] for k in _GRU_KEYS]
        with torch.enable_grad():
            for i in range(n):
                o = i * (w + 1)
                loss = (self._forward(self.params, buf[o:o + w])
                        - buf[o + w]) ** 2
                grads = torch.autograd.grad(loss, params)
                with torch.no_grad():
                    for p, g in zip(params, grads):
                        p.sub_(self._lr * g)
        with torch.no_grad():
            return self._forward(self.params, buf[n * (w + 1):])

    def _capture(self, n: int) -> None:
        """Capture the ``n``-window tick as a CUDA graph on the predictor's
        stream.  The warm-up steps move the parameters, so they are put
        back after."""
        buf = torch.zeros(n * (self.window + 1) + self.window,
                          device=self.device)
        saved = {k: p.detach().clone() for k, p in self.params.items()}
        s = self._stream
        s.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(s):
            for _ in range(3):
                self._tick_body(buf, n)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s,
                              capture_error_mode="thread_local"):
            out = self._tick_body(buf, n)
        with torch.cuda.stream(s), torch.no_grad():
            for k, p in self.params.items():
                p.copy_(saved[k])
        s.synchronize()
        self._graphs[n] = (graph, buf, out)

    def _run(self, n: int, inp: np.ndarray) -> _Prediction:
        if self._stream is None:  # eager, in the parameters' dtype
            buf = torch.from_numpy(inp).to(self.params["wo"].dtype)
            return _Prediction(value=float(self._tick_body(buf, n)))
        graph, buf, out = self._graphs[n]
        pinned = torch.from_numpy(inp).pin_memory()
        host = torch.empty(1, dtype=torch.float32, pin_memory=True)
        with torch.cuda.stream(self._stream):
            buf.copy_(pinned, non_blocking=True)
            graph.replay()
            host.copy_(out.reshape(1), non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Prediction(event=event, host=host, keep=pinned)

    def tick(self, phase, t=None):
        super().tick(phase, t)
        if phase == "step_end" and self._last_start is not None:
            d = (self._clock() if t is None else t) - self._last_start
            self._durs.append(d)
            if len(self._durs) > self.window:
                if self._scale is None:
                    self._scale = max(np.mean(self._durs), 1e-9)
                arr = np.asarray(self._durs, np.float32) / self._scale
                # online step on the newest window + a few replayed windows
                # (experience replay keeps the tiny GRU converging fast)
                starts = [len(arr) - self.window - 1]
                if len(arr) > self.window + 2:
                    starts += list(self._rng.integers(
                        0, len(arr) - self.window - 1, size=self.replay))
                rows = [arr[s:s + self.window + 1] for s in starts]
                inp = np.concatenate(rows + [arr[-self.window:]])
                self._pred = self._run(len(starts), inp.astype(np.float32))

    def predict_next_duration(self) -> Optional[float]:
        pred = self._pred
        if len(self._durs) <= self.window or self._scale is None \
                or pred is None:
            return super().predict_next_duration()
        value = pred.value()
        if not np.isfinite(value) or value <= 0:
            return super().predict_next_duration()
        return value * self._scale

    def idle_wait(self, t=None) -> float:
        if None in (self.period, self._last_start):
            return 0.0
        dur = self.predict_next_duration()
        if dur is None:
            return 0.0
        t = self._clock() if t is None else t
        into = (t - self._last_start) % max(self.period, 1e-9)
        if into >= dur:
            return 0.0
        return dur - into
