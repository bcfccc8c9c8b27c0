# TimeLogger and pretty_time_delta copied from nuradiomc_tpu/utils/timing.py:1-77
# (the logger's name is the port's); the recorder is the port's own. The port
# imports nothing of the JAX package
"""Wall-time accounting per pipeline stage, and the program's span and
counter recorder.

``TimeLogger`` replaces NuRadioMC/simulation/time_logger.py:45-207 (named
start/stop counters with periodic ETA prints). For device work, remember
that CUDA launches are asynchronous: end a timed region with
``torch.cuda.synchronize()``, or use ``torch.profiler`` for in-depth traces
(the device-side analog of the reference's per-module timers,
base/module.py:105-112).

The recorder is off by default; ``enable()`` turns it on for the process.
Then ``span(name)`` records the name, start, end, enclosing span and job of
a region; ``count(name, n)`` adds to a counter of the current job;
``host_sync(site)`` marks a blocking device-to-host read (a span
``sync.<site>`` and one more ``host_syncs.<site>``); ``new_job()``, called by
each ``Simulation.__init__``, starts the next job id; ``take()`` hands over
every record and clears them. Stamps are ``time.time_ns()``, the clock of
``torch.profiler``'s event stamps, so a span joins the profiler's device
events without conversion. Nothing is synchronized and no profiler range is
opened: a span measures the host's time, and a ``sync.*`` span the host's
wait. Off, each call is one flag test and ``span`` / ``host_sync`` return
the shared no-op context ``NOOP``. Spans nest in the order one host thread
opens them.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import time

# the fields of a span record, in the order the recorder keeps them
SPAN_FIELDS = ("id", "name", "start_ns", "end_ns", "parent", "job")
NOOP = contextlib.nullcontext()

_on = False
_job = 0
_ids = itertools.count()
_spans = []        # [id, name, start_ns, end_ns, parent id or None, job]
_open = []         # ids of the open spans, innermost last
_counters = {}     # job -> {name: n}


def enable(on: bool = True):
    """Turn the recorder on (or off) for the process."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def new_job():
    """Start the next job id: the records that follow belong to it."""
    global _job
    if _on:
        _job += 1


class _Span:
    __slots__ = ("_name", "_rec")

    def __init__(self, name):
        self._name = name

    def __enter__(self):
        sid = next(_ids)
        self._rec = [sid, self._name, time.time_ns(), None, _open[-1] if _open else None, _job]
        _spans.append(self._rec)
        _open.append(sid)
        return self

    def __exit__(self, *exc):
        self._rec[3] = time.time_ns()
        _open.remove(self._rec[0])
        return False


def span(name: str):
    """A context that records the region as span ``name`` (``NOOP`` when off)."""
    if not _on:
        return NOOP
    return _Span(name)


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` of the current job."""
    if not _on:
        return
    c = _counters.setdefault(_job, {})
    c[name] = c.get(name, 0) + n


def host_sync(site: str):
    """A blocking device-to-host read at ``site``: span ``sync.<site>`` and
    one more ``host_syncs.<site>`` (``NOOP`` when off)."""
    if not _on:
        return NOOP
    count("host_syncs." + site)
    return _Span("sync." + site)


def take() -> dict:
    """Every record so far, cleared: ``{"spans": [dict of SPAN_FIELDS, in
    the order the spans opened; end_ns None while open], "counters": {job:
    {name: n}}}``."""
    global _spans, _counters
    out = {"spans": [dict(zip(SPAN_FIELDS, r)) for r in _spans], "counters": _counters}
    _spans, _counters = [], {}
    return out


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
    """Named stage timers with periodic status prints (timeLogger:45-207);
    with the recorder on, each timed stage is also a span of its name."""

    def __init__(self, logger: logging.Logger | None = None,
                 update_interval: float = 60.0):
        self._logger = logger or logging.getLogger("nuradiomc_tpu_torch.timing")
        self._times: dict[str, float] = {}
        self._starts: dict[str, float] = {}
        self._spans: dict[str, _Span] = {}
        self._t0 = time.time()
        self._last_update = self._t0
        self._interval = update_interval

    def start_time(self, category: str):
        self._starts[category] = time.time()
        if _on:
            self._spans[category] = span(category).__enter__()

    def stop_time(self, category: str):
        if category in self._starts:
            self._times[category] = (self._times.get(category, 0.0)
                                     + time.time() - self._starts.pop(category))
        sp = self._spans.pop(category, None)
        if sp is not None:
            sp.__exit__(None, None, None)

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
