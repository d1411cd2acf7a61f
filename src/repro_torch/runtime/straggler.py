"""Straggler detection: an EMA step-time monitor with callbacks.

Port of ``repro/runtime/straggler.py``. The monitor keeps an exponential
moving average and variance of the step time (here: one engine chunk,
bracketed by ``begin_step``/``end_step``) and flags a step that exceeds both
``mean + z·std`` and ``ratio·mean``. Consumers register callbacks (log,
checkpoint and restart elsewhere). It runs on the host, measures wall time
between host syncs, and costs the device nothing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    mean: float
    std: float
    ratio: float


class StragglerMonitor:
    def __init__(self, *, ema_decay: float = 0.95, z_threshold: float = 4.0,
                 ratio_threshold: float = 2.0, warmup_steps: int = 5):
        self.decay = ema_decay
        self.z = z_threshold
        self.ratio = ratio_threshold
        self.warmup = warmup_steps
        self.mean = 0.0
        self.var = 0.0
        self.count = 0
        self.events: list[StragglerEvent] = []
        self._callbacks: list[Callable[[StragglerEvent], None]] = []
        self._last: float | None = None

    def on_straggler(self, fn: Callable[[StragglerEvent], None]) -> None:
        self._callbacks.append(fn)

    def begin_step(self) -> None:
        self._last = time.perf_counter()

    def end_step(self, step: int) -> float:
        if self._last is None:
            raise RuntimeError("end_step without begin_step")
        dt = time.perf_counter() - self._last
        self.observe(step, dt)
        return dt

    def observe(self, step: int, dt: float) -> bool:
        """Feed one step time; returns True if it is flagged as a straggler."""
        self.count += 1
        if self.count <= self.warmup:
            # seed the statistics without flagging
            self.mean = dt if self.count == 1 else (
                self.decay * self.mean + (1 - self.decay) * dt)
            return False
        std = max(self.var, 1e-12) ** 0.5
        is_slow = (dt > self.mean + self.z * std) and (
            dt > self.ratio * max(self.mean, 1e-9))
        if is_slow:
            ev = StragglerEvent(step=step, step_time=dt, mean=self.mean, std=std,
                                ratio=dt / max(self.mean, 1e-9))
            self.events.append(ev)
            for fn in self._callbacks:
                fn(ev)
        else:
            # straggler steps stay out of the EMA, so one hiccup does not
            # mask a second one
            delta = dt - self.mean
            self.mean += (1 - self.decay) * delta
            self.var = self.decay * (self.var + (1 - self.decay) * delta * delta)
        return is_slow
