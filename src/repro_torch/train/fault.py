"""Fault tolerance: supervised restarts, straggler detection, preemption;
plain Python, the port's own copy of the reference's
``repro/train/fault.py``.

  * ``run_with_restarts`` — the launcher's supervision loop: bounded
    restarts with exponential backoff; each restart resumes from the latest
    atomic checkpoint. Retryable exception types are listed in the policy;
    programming errors (TypeError etc.) re-raise at once.
  * ``StragglerMonitor`` — an EWMA of step wall time and its variance; a
    step slower than mean + k sigma (and a minimum ratio above the mean) is
    a straggler event, recorded and surfaced in the metrics.
  * ``PreemptionHandler`` — SIGTERM -> a final checkpoint at the next step
    boundary.
"""
from __future__ import annotations

import math
import signal
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple, Type


class Preempted(Exception):
    """Raised (or recorded) when a SIGTERM-initiated shutdown is requested."""


@dataclass
class RestartPolicy:
    max_restarts: int = 3
    backoff_s: float = 0.1
    backoff_factor: float = 2.0
    retryable: Tuple[Type[BaseException], ...] = (RuntimeError, OSError)


def run_with_restarts(make_fn: Callable[[int], Callable[[], object]],
                      policy: Optional[RestartPolicy] = None,
                      sleep=time.sleep):
    """Run ``make_fn(attempt)()`` under the restart policy.

    ``make_fn`` builds a fresh closure per attempt (so it can re-read the
    latest checkpoint). Returns the function's result. Raises the last
    error after exhausting restarts.
    """
    policy = policy or RestartPolicy()
    delay = policy.backoff_s
    last: Optional[BaseException] = None
    for attempt in range(policy.max_restarts + 1):
        try:
            return make_fn(attempt)()
        except policy.retryable as e:  # noqa: PERF203
            last = e
            if attempt == policy.max_restarts:
                break
            sleep(delay)
            delay *= policy.backoff_factor
    assert last is not None
    raise last


@dataclass
class StragglerMonitor:
    """EWMA mean/variance of step time; flags outlier steps."""
    alpha: float = 0.1
    k_sigma: float = 3.0
    min_ratio: float = 1.5       # must also be 1.5x the mean
    warmup_steps: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    events: List[dict] = field(default_factory=list)

    def observe(self, step: int, dt_s: float) -> bool:
        """Record one step duration; True if flagged as a straggler."""
        self.n += 1
        if self.n <= self.warmup_steps:
            # seed the statistics before judging
            if self.n == 1:
                self.mean = dt_s
            else:
                self.mean += (dt_s - self.mean) / self.n
                self.var += ((dt_s - self.mean) ** 2 - self.var) / self.n
            return False
        sigma = math.sqrt(max(self.var, 1e-12))
        is_straggler = (dt_s > self.mean + self.k_sigma * sigma
                        and dt_s > self.min_ratio * self.mean)
        if is_straggler:
            self.events.append({"step": step, "dt_s": dt_s,
                                "mean_s": self.mean, "sigma_s": sigma})
        else:
            # EWMA update only on healthy steps so stragglers don't poison it
            d = dt_s - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


class PreemptionHandler:
    """SIGTERM -> graceful final checkpoint at the next step boundary."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = None
        if install:
            try:
                self._prev = signal.signal(signal.SIGTERM, self._on_sigterm)
            except ValueError:  # non-main thread (tests)
                self._prev = None

    def _on_sigterm(self, signum, frame):
        self.requested = True

    def uninstall(self):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
