# copied from nuradiomc_tpu/utils/timing.py:1-77 (the logger's name is the
# port's); the port keeps its own copy and imports nothing of the JAX package
"""Wall-time accounting per pipeline stage.

Replaces NuRadioMC/simulation/time_logger.py:45-207 (named start/stop
counters with periodic ETA prints). For device work, remember that CUDA
launches are asynchronous: end a timed region with
``torch.cuda.synchronize()``, or use ``torch.profiler`` for in-depth traces
(the device-side analog of the reference's per-module timers,
base/module.py:105-112).
"""

from __future__ import annotations

import contextlib
import logging
import time


def pretty_time_delta(seconds: float) -> str:
    """Human-readable duration (time_logger.pretty_time_delta:4-20)."""
    seconds = int(seconds)
    days, seconds = divmod(seconds, 86400)
    hours, seconds = divmod(seconds, 3600)
    minutes, seconds = divmod(seconds, 60)
    if days:
        return f"{days}d{hours}h{minutes}m{seconds}s"
    if hours:
        return f"{hours}h{minutes}m{seconds}s"
    if minutes:
        return f"{minutes}m{seconds}s"
    return f"{seconds}s"


class TimeLogger:
    """Named stage timers with periodic status prints (timeLogger:45-207)."""

    def __init__(self, logger: logging.Logger | None = None,
                 update_interval: float = 60.0):
        self._logger = logger or logging.getLogger("nuradiomc_tpu_torch.timing")
        self._times: dict[str, float] = {}
        self._starts: dict[str, float] = {}
        self._t0 = time.time()
        self._last_update = self._t0
        self._interval = update_interval

    def start_time(self, category: str):
        self._starts[category] = time.time()

    def stop_time(self, category: str):
        if category in self._starts:
            self._times[category] = (self._times.get(category, 0.0)
                                     + time.time() - self._starts.pop(category))

    @contextlib.contextmanager
    def timed(self, category: str):
        self.start_time(category)
        try:
            yield
        finally:
            self.stop_time(category)

    def get_times(self) -> dict:
        return dict(self._times)

    def show_time(self, n_total: int, i_current: int):
        """Periodic ETA + per-category percentage print (show_time:180-207)."""
        now = time.time()
        if now - self._last_update < self._interval:
            return
        self._last_update = now
        elapsed = now - self._t0
        eta = elapsed * (n_total - i_current - 1) / max(i_current + 1, 1)
        total = sum(self._times.values()) or 1.0
        parts = ", ".join(f"{k} = {100 * v / elapsed:.0f}%"
                          for k, v in self._times.items())
        self._logger.info(
            "Processing %d/%d. ETA: %s, time consumption: %s, unaccounted: %.0f%%",
            i_current + 1, n_total, pretty_time_delta(eta), parts,
            100 * (elapsed - total) / elapsed)
