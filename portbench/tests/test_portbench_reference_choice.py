"""A configuration names its own reference module (``"reference"``), the
harness refuses any other name before the window, and the comparison reads
every station where both sides give them."""

import json
import shutil
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

from portbench import compare, harness
from portbench.reference import job as default_reference
from portbench.run import parse

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
CELL = "dipole_veff.nu_1e18"


def tree_with_reference(tmp_path, reference):
    """A copy of BENCHMARK.json and portbench/'s data files whose
    ``dipole_veff`` configuration names ``reference`` (left out for None)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    path = tmp_path / "portbench" / "configs" / "dipole_veff.json"
    cfg = json.loads(path.read_text())
    assert "reference" not in cfg
    if reference is not None:
        cfg["reference"] = reference
    path.write_text(json.dumps(cfg))
    return tmp_path


def run_cell(root, capsys, seed=3000000011):
    args = parse(["--workload", CELL, "--seed", str(seed), "--seconds", "0.1", "--trace", "0"])
    rc = harness.run(args, t_start=time.perf_counter(), device="cpu", events_per_job=120,
                     root=root)
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), cap.err


def test_explicit_default_reference_gives_the_same_run(tmp_path, capsys):
    rc0, plain, _ = run_cell(tree_with_reference(tmp_path / "a", None), capsys)
    rc1, named, _ = run_cell(tree_with_reference(tmp_path / "b", "portbench.reference.job"),
                             capsys)
    assert rc0 == rc1 == 0
    assert plain["correct"] and named["correct"]
    assert plain["checks"] == named["checks"]
    assert plain["attempted"] >= 1 and named["attempted"] >= 1


def test_a_named_module_is_the_reference(tmp_path, capsys, monkeypatch):
    """A planted ``portbench.reference.*`` module decides ``correct``: its
    Job flips one station's decision, so the run reads not correct."""
    calls = []

    class Job(default_reference.Job):
        def run(self, list_path, seed, **kwargs):
            calls.append(seed)
            out = super().run(list_path, seed, **kwargs)
            flipped = np.asarray(out["triggered"], dtype=bool).copy()
            flipped[0] = ~flipped[0]
            return {**out, "triggered_per_station": {101: flipped}}

    planted = types.ModuleType("portbench.reference.planted_for_test")
    planted.Job = Job
    monkeypatch.setitem(sys.modules, planted.__name__, planted)
    rc, last, _ = run_cell(tree_with_reference(tmp_path, planted.__name__), capsys)
    assert rc == 0 and len(calls) == 1
    assert last["correct"] is False and last["checks"]["decisions"]["value"] == 1
    assert harness.reference_module({"reference": planted.__name__}) is planted
    assert harness.reference_module({}) is default_reference


@pytest.mark.parametrize("name", ["numpy", "portbench.compare", "portbench.reference",
                                  "portbench.reference.no_such_module",
                                  "portbench.reference..job", "portbench.reference.units", 7])
def test_other_names_are_refused_before_the_window(tmp_path, capsys, name):
    rc, last, err = run_cell(tree_with_reference(tmp_path, name), capsys)
    assert rc != 0 and last is None
    assert "'reference'" in err and "0 jobs" not in err and "jobs," not in err


def results(G=6, T=1, stations=None):
    rng = np.random.default_rng(4)
    trig = rng.random(G) < 0.5
    out = {"group_ids": np.arange(G), "triggered": trig, "multiple_triggers": trig[:, None],
           "trigger_times_per_trigger": np.where(trig, 10.0, np.nan)[:, None],
           "trigger_times": np.where(trig, 10.0, 0.0),
           "max_amplitude": rng.random((G, 1)), "weights": rng.random(G), "veff": 2.5}
    if stations is not None:
        out["triggered_per_station"] = stations
    return out


def test_one_station_flip_counts_one_group():
    base = results()
    a = np.array([True, False, True, False, False, True])
    b = np.array([False, True, False, False, True, True])
    ref = {**base, "triggered_per_station": {11: a, 12: b}}
    flipped = b.copy()
    flipped[3] = ~flipped[3]
    prog = {**base, "triggered_per_station": {11: a.copy(), 12: flipped}}
    assert compare.readings(prog, ref, 0.1)["decisions"] == 1
    # a group that differs at a station and in its decision counts once
    prog["triggered"] = base["triggered"].copy()
    prog["triggered"][3] = ~prog["triggered"][3]
    assert compare.readings(prog, ref, 0.1)["decisions"] == 1
    # a station that one side lacks differs in every group
    assert compare.readings({**base, "triggered_per_station": {11: a}}, ref,
                            0.1)["decisions"] == 6


def test_single_station_readings_are_unchanged():
    base = results()
    prog = {**base, "triggered": ~base["triggered"]}
    plain = compare.readings(prog, base, 0.1)
    st = {101: prog["triggered"].copy()}
    # only the program gives stations (the existing reference gives none)
    assert compare.readings({**prog, "triggered_per_station": st}, base, 0.1) == plain
    assert compare.readings(prog, {**base, "triggered_per_station": st}, 0.1) == plain
    assert plain["decisions"] == 6
    assert compare.readings(base, base, 0.1) == {"decisions": 0, "amplitude": 0.0,
                                                 "trigger_time_ns": 0.0, "weight": 0.0,
                                                 "veff": 0.0}
