"""The reference against the port on the CPU, a few hundred groups of each
configuration in float64, and the control (the reference in float32) against
the limits."""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import compare, control, harness
from portbench.reference.job import Job
from portbench.traffic import generator

CELLS = {"dipole_veff.nu_1e18": 400, "deep_pa.nu_1e18_noise": 300,
         "dipole_veff.nutau_1e19_secondaries": 200}


def setup(workload, events, seed=21):
    bench = harness.benchmark()
    cell, entry = harness.cell_of(bench, workload)
    cfg = harness.load_config(entry)
    mix = {**harness.load_mix(cell["traffic"]), "events_per_job": events}
    data, attrs = generator.make_list(mix, seed, 0)
    return cfg, data, attrs, harness.config_seed(seed, 0)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_reference_matches_the_port(workload):
    cfg, data, attrs, cseed = setup(workload, CELLS[workload])
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "list.npz"
        generator.write_list(path, data, attrs)
        prog = harness.simulation_factory(cfg, "cpu", torch.float64)(path, cseed).run()
        job = Job(cfg, "cpu", torch.float64)
        ref = job.run(path, cseed)
    values = compare.readings(prog, ref, job.Vrms)
    ok, rows = compare.judge(values, cfg["limits"])
    assert ok, rows
    # the comparison sees the whole chain: groups fire, weights vary
    assert ref["triggered"].sum() > 0 and np.ptp(ref["weights"]) > 0
    np.testing.assert_array_equal(prog["triggered"], ref["triggered"])


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_the_limits(workload):
    """The reference computed in float32 and put in the program's place
    fails at least one limit, on three seeds (at the CPU's size; the card's
    readings at the cells' size are in PERF.md)."""
    for seed in (31, 32, 33):
        out = control.readings_of(workload, seed, "cpu", events=CELLS[workload],
                                  with_program=False)
        ok, rows = compare.judge(out["control"], out["limits"])
        assert not ok, rows
