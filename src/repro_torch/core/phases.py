"""Application-phase prediction for interference-free background I/O
(paper §2: iterative HPC apps are predictable; schedule background ops into
windows where they use resources the app does not).

A predictor over the stream of (step_start, step_end) events the training
loop reports via ``tick()``:

  EMAPhasePredictor — exponential moving average of step duration + period;
      predicts the next compute-busy window.

The learned GRU predictor (the paper's seq2seq-style predictor) is not
ported yet; ``VelocClient`` refuses ``phase_predictor="gru"``.

``idle_wait()`` returns how long a background chunk transfer should wait to
land inside the predicted gap between steps — used as the ActiveBackend
phase gate.
"""
from __future__ import annotations

import time
from typing import Optional


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
