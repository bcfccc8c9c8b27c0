"""The readers of the program's own spans and counters
(``portbench/program_spans.py``): each on a synthetic record whose warm-up
and profiled jobs are dropped, the CPU harness run with ``--trace 1``
reporting all of them, and an untraced run leaving the program's recorder
off."""

import json
import subprocess
import sys
import time

import pytest

from portbench import harness, program_spans
from portbench.run import parse
from test_portbench_harness import ROOT, dummy_tree

NEW = ("init_ms_per_kevent", "batch_ms_per_kevent", "transfer_ms_per_kevent",
       "results_ms_per_kevent", "sync_wait_ms_per_kevent", "host_syncs_per_chunk",
       "raytrace_ms_per_kevent", "trigger_ms_per_kevent")
MS = 1_000_000


def job_records(job, scale):
    """The records of one job: every span ``scale`` ms long or a multiple,
    nested as the program nests them."""
    spans = []

    def span(name, ms, parent=None):
        sid = len(spans) + 100 * job
        start = 10_000 * MS * job + len(spans) * 1000 * MS
        spans.append({"id": sid, "name": name, "start_ns": start,
                      "end_ns": start + int(ms * scale * MS), "parent": parent, "job": job})
        return sid

    init = span("sim.init", 10)
    span("sim.channels", 4, init)
    span("sim.input", 1, init)
    span("sim.batch", 3)
    span("sim.weights", 7)
    span("sync.cable_delays", 0.5)
    span("sim.h2d", 2)
    step = span("sim.step", 40)
    span("step.raytrace", 20, step)
    signal = span("step.signal", 8, step)
    span("sync.min_efield", 1, signal)
    span("step.placement", 3, step)
    span("step.trigger", 6, step)
    span("step.trigger", 1, step)
    readback = span("sim.readback", 5)
    span("sync.readback", 2, readback)
    span("sync.readback", 1, readback)
    span("sim.results", 4)
    counters = {"chunks": 1, "host_syncs.cable_delays": 1, "host_syncs.min_efield": 1,
                "host_syncs.readback": 18}
    return spans, counters


def synthetic():
    """A window of two jobs of 1000 and 3000 events; the program also
    recorded the warm-up job (scale 50) and the profiled job (scale 70)."""
    spans, counters = [], {}
    for job, scale in ((1, 50), (2, 1), (3, 2), (4, 70)):
        s, c = job_records(job, scale)
        spans += s
        counters[job] = c
    rec = {"jobs": [{"wall_s": 1.0, "events": 1000}, {"wall_s": 2.0, "events": 3000}],
           "peak_mem_bytes": 0, "profile": None}
    return rec, {"spans": spans, "counters": counters}


# each job's value at scale 1 (ms), and the window's: scale 1 + scale 2 = 3x,
# over 4 kevents
@pytest.mark.parametrize("name, per_job", [
    ("init_ms_per_kevent", 10.0),
    ("batch_ms_per_kevent", 3.0),
    ("transfer_ms_per_kevent", 2.0 + 5.0 - 3.0),
    ("results_ms_per_kevent", 4.0),
    ("sync_wait_ms_per_kevent", 0.5 + 1.0 + 3.0),
    ("raytrace_ms_per_kevent", 20.0),
    ("trigger_ms_per_kevent", 7.0),
])
def test_reader_reads_the_window_jobs(monkeypatch, name, per_job):
    rec, raw = synthetic()
    monkeypatch.setattr(program_spans, "take", lambda: raw)
    assert harness.load_reader(name).read(rec) == pytest.approx(3 * per_job / 4.0)


def test_host_syncs_per_chunk(monkeypatch):
    rec, raw = synthetic()
    raw["counters"][3]["chunks"] = 3
    monkeypatch.setattr(program_spans, "take", lambda: raw)
    assert harness.load_reader("host_syncs_per_chunk").read(rec) == pytest.approx(40 / 4)


def test_records_are_taken_once_per_run(monkeypatch):
    rec, raw = synthetic()
    calls = []
    monkeypatch.setattr(program_spans, "take", lambda: calls.append(1) or raw)
    for name in NEW:
        harness.load_reader(name).read(rec)
    assert len(calls) == 1


@pytest.mark.parametrize("raw", [None, {"spans": [], "counters": {}}])
def test_readers_read_nothing_without_the_programs_records(monkeypatch, raw):
    """A program without the recorder (None), or one that recorded nothing."""
    rec, _ = synthetic()
    monkeypatch.setattr(program_spans, "take", lambda: raw)
    for name in NEW:
        assert harness.load_reader(name).read(rec) is None, name


def test_a_missing_span_reads_nothing(monkeypatch):
    rec, raw = synthetic()
    raw["spans"] = [s for s in raw["spans"] if not (s["name"] == "sim.batch" and s["job"] == 3)]
    monkeypatch.setattr(program_spans, "take", lambda: raw)
    assert harness.load_reader("batch_ms_per_kevent").read(rec) is None
    assert harness.load_reader("init_ms_per_kevent").read(rec) is not None


def test_traced_cpu_run_reports_every_new_metric(tmp_path, capsys):
    root = dummy_tree(tmp_path)
    program_spans.take()               # records left by earlier runs in this process
    args = parse(["--workload", "dipole_veff.dummy", "--seed", "3000000007", "--seconds", "0.1",
                  "--trace", "1"])
    assert harness.run(args, t_start=time.perf_counter(), device="cpu", root=root) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["correct"]
    got = {k: v["value"] for k, v in last["metrics"].items()}
    assert set(NEW) <= set(got)
    assert all(got[k] > 0 for k in NEW)
    # one chunk a job: the cable delays, min_efield, five reads, and 13 more
    # in a job with a triggered group
    assert 7.0 <= got["host_syncs_per_chunk"] <= 20.0


def test_untraced_run_leaves_the_recorder_off(tmp_path):
    """In a fresh process (loading the readers turns the recorder on)."""
    root = dummy_tree(tmp_path)
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
from portbench import harness
from portbench.run import parse
from nuradiomc_tpu_torch.utils import timing
args = parse(["--workload", "dipole_veff.dummy", "--seed", "11", "--seconds", "0.1",
              "--trace", "0"])
assert harness.run(args, t_start=time.perf_counter(), device="cpu", root={str(root)!r}) == 0
print("RECORDER", timing.enabled(), len(timing.take()["spans"]),
      "portbench.program_spans" in sys.modules)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "RECORDER False 0 False"
