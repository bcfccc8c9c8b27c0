"""The program's own spans and counters (``nuradiomc_tpu_torch.utils.timing``)
for the per-layer metrics that read them.

Importing this module turns the program's recorder on. The harness loads
the metric readers, and with them this module, only in traced runs
(``--trace 1``), so an untraced run leaves the recorder off. A run's records
are taken once, when its record is first read, and split by job id in the
order the jobs began: the harness's warm-up job, then the window's jobs
(``len(rec["jobs"])``, in the order of ``rec["jobs"]``), then the profiled
job where there is one. Readers see the window's jobs alone. A program
without the recorder records nothing, and every reader then reads nothing
(``None``), never 0."""

from __future__ import annotations

import importlib

MODULE = "nuradiomc_tpu_torch.utils.timing"

_timing = importlib.import_module(MODULE)
if hasattr(_timing, "enable"):
    _timing.enable()

# (the record last read, its window's jobs)
_taken = [None, None]


def take():
    """Every record the program's recorder holds, cleared there; None for
    a program without the recorder."""
    fn = getattr(_timing, "take", None)
    return None if fn is None else fn()


def split(records, n_window: int):
    """The records of the window's jobs: for each, ``{"spans": [...],
    "counters": {...}}``; None where fewer than the warm-up and the window's
    jobs were recorded. Job 0 is outside any job and is dropped."""
    if not records:
        return None
    spans, counters = records["spans"], records["counters"]
    jobs = sorted(({s["job"] for s in spans} | set(counters)) - {0})
    if len(jobs) < 1 + n_window:
        return None
    return [{"spans": [s for s in spans if s["job"] == job], "counters": counters.get(job, {})}
            for job in jobs[1:1 + n_window]]


def window_jobs(rec):
    """The program's records of the window's jobs of the run ``rec``."""
    if _taken[0] is not rec:
        _taken[:] = [rec, split(take(), len(rec["jobs"]))]
    return _taken[1]


def _matches(name, match):
    if isinstance(match, tuple):
        return any(_matches(name, m) for m in match)
    return name.startswith(match) if match.endswith(".") else name == match


def durations(job, match, within=None):
    """Seconds of each span of ``job`` whose name ``match`` takes (a name, a
    prefix ending in ``.``, or a tuple of them); with ``within``, only those
    inside a span that ``within`` takes."""
    by_id = {s["id"]: s for s in job["spans"]}

    def inside(s):
        p = by_id.get(s["parent"])
        while p is not None:
            if _matches(p["name"], within):
                return True
            p = by_id.get(p["parent"])
        return False

    return [(s["end_ns"] - s["start_ns"]) / 1e9 for s in job["spans"]
            if s["end_ns"] is not None and _matches(s["name"], match)
            and (within is None or inside(s))]


def ms_per_kevent(rec, per_job):
    """1000 x the sum over the window's jobs of ``per_job(job)`` (seconds),
    per 1000 input events of the window; None where nothing was recorded or
    ``per_job`` gives None for a job."""
    jobs = window_jobs(rec)
    if not jobs:
        return None
    values = [per_job(j) for j in jobs]
    if any(v is None for v in values):
        return None
    return 1e3 * sum(values) / (sum(j["events"] for j in rec["jobs"]) / 1e3)


def span_ms_per_kevent(rec, match):
    """The spans ``match`` takes, in ms per 1000 input events; None where a
    window job has none."""
    def total(job):
        d = durations(job, match)
        return sum(d) if d else None
    return ms_per_kevent(rec, total)
