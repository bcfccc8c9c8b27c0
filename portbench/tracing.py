"""Spans and op records from the benchmark's own wrappers, and the reduction
of one profiled job's device trace.

A metric reader (``portbench/metrics/<metric>.py``) may declare

- ``SPAN = {"module": ..., "attr": ..., "name": ..., "sync": bool}``: the
  module attribute that the program looks up when it calls it is wrapped, and
  each call's host-clock time (ending in ``torch.cuda.synchronize()`` where
  ``sync``) is added to the job's span ``name``;
- ``OP = {"module": ..., "attr": ..., "name": ..., "kernel": ...}`` and
  ``problem(args, kwargs)``: while a job is profiled, each call records its
  problem sizes (a dict whose values may be 0-d tensors, read once the job
  has ended) for the reader's bound, and the kernel name whose device time
  the bound is held against.

Wrappers are installed only in traced runs (``--trace 1``)."""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

import torch

LABEL = "portbench:"
# a device op's name in the breakdown is cut to this many characters (the
# kernel names of ATen's templates run to a few hundred)
NAME_CHARS = 160


class Recorder:
    """Per-job span sums, and the op problems of the profiled job."""

    def __init__(self, sync_device=None):
        self.sync_device = sync_device
        self.spans = {}
        self.profiling = False
        self.ops = {}
        self._patched = []

    def start_job(self):
        self.spans = {}

    def _span(self, name, fn, sync):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            ctx = (torch.profiler.record_function(LABEL + name) if self.profiling
                   else contextlib.nullcontext())
            t0 = time.perf_counter()
            with ctx:
                out = fn(*args, **kwargs)
                if sync and self.sync_device is not None:
                    torch.cuda.synchronize(self.sync_device)
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    def _op(self, name, fn, problem):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if self.profiling:
                self.ops.setdefault(name, []).append(problem(args, kwargs))
            return fn(*args, **kwargs)
        return wrapper

    def install(self, readers):
        """Wrap every SPAN and OP that the readers declare (once each)."""
        seen = set()
        for reader in readers:
            for kind in ("SPAN", "OP"):
                spec = getattr(reader, kind, None)
                if spec is None or (kind, spec["module"], spec["attr"]) in seen:
                    continue
                seen.add((kind, spec["module"], spec["attr"]))
                mod = importlib.import_module(spec["module"])
                fn = getattr(mod, spec["attr"])
                wrapped = (self._span(spec["name"], fn, spec.get("sync", False))
                           if kind == "SPAN" else self._op(spec["name"], fn, reader.problem))
                setattr(mod, spec["attr"], wrapped)
                self._patched.append((mod, spec["attr"], fn))

    def uninstall(self):
        for mod, attr, fn in reversed(self._patched):
            setattr(mod, attr, fn)
        self._patched = []

    def resolved_ops(self):
        """The profiled job's op problems with every tensor read as a number."""
        return {name: [{k: (v.item() if torch.is_tensor(v) else v) for k, v in p.items()}
                       for p in calls] for name, calls in self.ops.items()}


def _events(prof):
    """(name, is_device, start_us, duration_us) of every event of the trace,
    read from the profiler's raw results (faster than its event tree)."""
    from torch.autograd import DeviceType
    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns() / 1e3,
             e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()]


def union_intervals(intervals):
    """Merged [start, end) intervals of a list of (start, end)."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(events, top=10):
    """The profiled job's device record from its trace events: busy seconds
    (the union of device intervals), kernel launches, device seconds and
    count per kernel name, the longest idle gaps labelled by the innermost
    benchmark span the host was in."""
    # the profiler mirrors a record_function range on the device's timeline:
    # that is host time, not a device op
    dev = [(n, s, d) for n, is_dev, s, d in events if is_dev and not n.startswith(LABEL)]
    kernels = {}
    launches = 0
    for n, s, d in dev:
        c, t = kernels.get(n, (0, 0.0))
        kernels[n] = (c + 1, t + d / 1e6)
        if not n.startswith(("Memcpy", "Memset")):
            launches += 1
    merged = union_intervals([(s, s + d) for _, s, d in dev])
    busy_s = sum(e - s for s, e in merged) / 1e6
    spans = [(s, s + d, n[len(LABEL):]) for n, is_dev, s, d in events
             if not is_dev and n.startswith(LABEL)]
    job = [(a, b) for a, b, name in spans if name == "job"]
    spans = [sp for sp in spans if sp[2] != "job"]
    if job:
        # the host's time before the first and after the last device op
        merged = [[job[0][0], job[0][0]]] + merged + [[job[0][1], job[0][1]]]
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        inner = [(b - a, name) for a, b, name in spans if a <= mid <= b]
        gaps.append((min(inner)[1] if inner else "orchestrator", (s1 - e0) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {"busy_s": busy_s, "launches": launches, "kernels": kernels,
            "device_ops": [[n[:NAME_CHARS], t] for n, (_, t) in ops[:top]],
            "idle_gaps": [[n, t] for n, t in gaps[:top]]}


def profile_job(run_job, recorder):
    """Run one job under torch.profiler (CPU and CUDA activities) with the
    recorder's op records on; (profiled wall seconds, trace events)."""
    from torch.profiler import ProfilerActivity, profile
    recorder.ops = {}
    recorder.profiling = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(LABEL + "job"):
                t0 = time.perf_counter()
                run_job()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
    finally:
        recorder.profiling = False
    return wall, _events(prof)
