"""The port's span and counter recorder (``utils/timing.py``) on the CPU:

* off, it records nothing and ``span`` / ``host_sync`` hand out the shared
  no-op context;
* on, a tiny float64 ``Simulation`` run in two chunks gives the span tree of
  the job (construction, batch, weights, per chunk the copy, the step with its
  four stage spans and the readback, the results, and the output where a
  file is written), one job id, and one ``host_syncs.<site>`` per blocking
  read the code passes, with and without an output file;
* the results are equal bit for bit with the recorder on and off;
* a span's stamps are on the clock of ``torch.profiler``'s events;
* ``TimeLogger`` records through the same recorder.
"""

import time

import numpy as np
import pytest
import torch

from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim import io_input
from nuradiomc_tpu_torch.utils import timing

# 16 groups that do not trigger, then 4 that do (tests/test_torch_arz.py's
# list): in chunks of 16 the first chunk triggers nothing, the second does
QUIET = 16
FIRING = [229, 253, 291, 378]
CHUNK = 16

# blocking device-to-host reads the code passes (sim/simulation.py,
# sim/pipeline.py): per chunk the readback's five decisions and amplitudes;
# where an output file is written, per chunk with a triggered group 13 more
# reads (twelve per-solution outputs of the triggered rows and their
# polarization), which only the file's writer reads
READBACK_PER_CHUNK = 5
READBACK_PER_FIRING_CHUNK = 13


@pytest.fixture
def recorder_off():
    timing.enable(False)
    timing.take()
    yield
    timing.enable(False)
    timing.take()


def _simulation(outputfilename=None):
    full = io_input.read_input(str(io_input.INPUT_1E18_N3000))
    ids = np.concatenate([np.unique(full.event_group_ids)[:QUIET], FIRING])
    return convert.dipole_simulation(io_input.select(full, ids), chunk_size=CHUNK,
                                     device="cpu", dtype=torch.float64,
                                     outputfilename=outputfilename)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(results off, results on, the records of the run on, the records of a
    run on that writes an output file)."""
    timing.enable(False)
    timing.take()
    try:
        off = _simulation().run()
        timing.enable()
        on = _simulation().run()
        records = timing.take()
        _simulation(str(tmp_path_factory.mktemp("timing") / "out.hdf5")).run()
        written = timing.take()
    finally:
        timing.enable(False)
        timing.take()
    return off, on, records, written


def test_off_records_nothing(recorder_off):
    assert not timing.enabled()
    assert timing.span("sim.step") is timing.NOOP
    assert timing.host_sync("readback") is timing.NOOP
    timing.new_job()
    with timing.span("a"), timing.host_sync("b"):
        timing.count("chunks")
    _simulation().run()
    assert timing.take() == {"spans": [], "counters": {}}


def test_recorder_api(recorder_off):
    timing.enable()
    timing.new_job()
    with timing.span("outer"):
        with timing.span("inner"):
            with timing.host_sync("site"):
                pass
        timing.count("n", 3)
    timing.new_job()
    timing.count("n")
    rec = timing.take()
    assert timing.take() == {"spans": [], "counters": {}}
    by_name = {s["name"]: s for s in rec["spans"]}
    assert [s["name"] for s in rec["spans"]] == ["outer", "inner", "sync.site"]
    assert set(by_name["outer"]) == set(timing.SPAN_FIELDS)
    assert by_name["outer"]["parent"] is None
    assert by_name["inner"]["parent"] == by_name["outer"]["id"]
    assert by_name["sync.site"]["parent"] == by_name["inner"]["id"]
    job = by_name["outer"]["job"]
    assert rec["counters"] == {job: {"host_syncs.site": 1, "n": 3}, job + 1: {"n": 1}}
    for s in rec["spans"]:
        assert s["job"] == job and s["start_ns"] <= s["end_ns"]


@pytest.mark.parametrize("written", [False, True], ids=["results", "output_file"])
def test_span_tree_of_a_two_chunk_run(runs, written):
    off, on, rec, rec_written = runs
    if written:
        rec = rec_written
    spans = rec["spans"]
    by_id = {s["id"]: s for s in spans}
    jobs = {s["job"] for s in spans}
    assert len(jobs) == 1 and set(rec["counters"]) == jobs
    counters = rec["counters"][jobs.pop()]
    assert {s["name"] for s in spans} == {
        "sim.init", "sim.channels", "sim.input", "sim.batch", "sim.weights", "sim.h2d",
        "sim.step", "step.raytrace", "step.signal", "step.placement", "step.trigger",
        "sim.readback", "sim.results", "sync.readback"} | ({"sim.output"} if written else set())

    def parent(s):
        return by_id[s["parent"]]["name"] if s["parent"] is not None else None

    want_parent = {"sim.channels": "sim.init", "sim.input": "sim.init",
                   "step.raytrace": "sim.step", "step.signal": "sim.step",
                   "step.placement": "sim.step", "step.trigger": "sim.step",
                   "sync.readback": "sim.readback"}
    for s in spans:
        assert parent(s) == want_parent.get(s["name"]), s["name"]
        assert s["end_ns"] is not None and s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    # per chunk: the copy, the step with its four stages, the readback
    n_chunks = -(-(QUIET + len(FIRING)) // CHUNK)
    assert counters["chunks"] == n_chunks == 2
    per_chunk = [s["name"] for s in spans if s["name"] in ("sim.h2d", "sim.step", "sim.readback")]
    assert per_chunk == ["sim.h2d", "sim.step", "sim.readback"] * n_chunks
    for step in (s for s in spans if s["name"] == "sim.step"):
        children = [c["name"] for c in spans if c["parent"] == step["id"]]
        # one window: the placement's set-up and the window, the window's
        # triggers and the decisions across windows
        assert sorted(children) == ["step.placement", "step.placement", "step.raytrace",
                                    "step.signal", "step.trigger", "step.trigger"]
    # the host syncs the code passes
    firing_chunks = len(np.unique(np.flatnonzero(on["triggered"]) // CHUNK))
    assert firing_chunks == 1 and on["n_triggered"] == len(FIRING)
    want = {"host_syncs.readback": READBACK_PER_CHUNK * n_chunks
            + READBACK_PER_FIRING_CHUNK * firing_chunks * written}
    assert {k: v for k, v in counters.items() if k.startswith("host_syncs.")} == want
    for name, n in want.items():
        assert sum(s["name"] == "sync." + name.split(".", 1)[1] for s in spans) == n
    assert sum(want.values()) / n_chunks == (11.5 if written else 5.0)


def test_results_equal_with_the_recorder_on_and_off(runs):
    off, on, _, _ = runs
    assert off.keys() == on.keys()

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
        return a == b

    for key in off:
        assert same(off[key], on[key]), key


def test_spans_are_on_the_profilers_clock(recorder_off):
    """A program span opened around a record_function range brackets the
    range's event in the profiler's own stamps."""
    from torch.profiler import ProfilerActivity, profile, record_function
    timing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timing.span("around"):
                time.sleep(0.002)
                with record_function("probe"):
                    torch.ones(64).sum()
                time.sleep(0.002)
    spans = [s for s in timing.take()["spans"] if s["name"] == "around"]
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe"]
    assert len(spans) == len(events) == 3
    for s, e in zip(spans, sorted(events, key=lambda e: e.start_ns())):
        assert s["start_ns"] <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s["end_ns"]


def test_time_logger_records_through_the_recorder(recorder_off):
    tl = timing.TimeLogger(update_interval=0.0)
    with tl.timed("quiet"):
        pass
    assert timing.take() == {"spans": [], "counters": {}}
    timing.enable()
    with tl.timed("stage"):
        time.sleep(0.001)
    tl.start_time("other")
    tl.stop_time("other")
    rec = timing.take()
    assert [s["name"] for s in rec["spans"]] == ["stage", "other"]
    assert set(tl.get_times()) == {"quiet", "stage", "other"}
    assert tl.get_times()["stage"] >= 0.001
    stage = rec["spans"][0]
    assert stage["end_ns"] - stage["start_ns"] >= 1_000_000
