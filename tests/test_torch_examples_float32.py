"""The groups of example 01's event list on which float32 is excused on the
card (``chip_smoke.P17_F32_SENSITIVE``), held to the JAX package.

``chip_smoke.py`` phase 17 compares the card's float32 runs of examples 01
and 09 with the CPU's and excuses a group whose decision differs only where
it is within 1e-3 of its threshold or is one of those groups. This test
shows that each of them is float32-sensitive in the reference itself: the
JAX package's float32 run moves one of the group's ray travel times by more
than 0.1 ns from its float64 run. There two rays arrive a few ns apart and
the float32 ray solver's travel times move their interference, so float32
can decide a rung far from its threshold in either package. Tolerances: the
port's float64 travel times equal the JAX package's within 1e-3 ns (the two
packages' closed-form solutions differ by 1.2e-4 ns at most on these
groups).
"""

import dataclasses
import os
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.sim import evtgen as jevtgen
from nuradiomc_tpu.sim.simulation import FilterStage as JFilterStage
from nuradiomc_tpu.sim.simulation import Simulation as JSimulation
from nuradiomc_tpu.sim.simulation import TriggerSpec as JTriggerSpec
from nuradiomc_tpu_torch.examples.e01_veff_simulation import t01_generate_event_list as t01
from nuradiomc_tpu_torch.examples.e01_veff_simulation import t02_run_simulation as t02
from nuradiomc_tpu_torch.sim.simulation import Simulation as PSimulation
from nuradiomc_tpu_torch.sim.simulation import TriggerSpec as PTriggerSpec

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import P17_F32_SENSITIVE  # noqa: E402

torch.set_num_threads(1)

# a trigger that every group with a signal passes (the station's per-ray
# rows are written for triggered groups), and example 09's top rung
TRIGGERS = (dict(name="any", threshold_high_sigma=1e-3, threshold_low_sigma=-1e-3),
            dict(name="hilo_4sigma", threshold_high_sigma=4.0, threshold_low_sigma=-4.0))


def travel_times(path):
    """({group id: travel times [channels, solutions]}, {group id: fires at
    4 sigma}) of an output file."""
    with h5py.File(path, "r") as f:
        st = f["station_101"]
        gids = np.asarray(st["event_group_id_per_shower"])
        tt = np.asarray(st["travel_times"])
        top = np.asarray(f["multiple_triggers"])[:, 1]
        rows = np.asarray(f["event_group_ids"])
    return {int(g): t for g, t in zip(gids, tt)}, dict(zip(rows.tolist(), top.tolist()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("f32")
    data, attrs = jevtgen.generate_eventlist_cylinder(None, 1e4, 1e18, 1e18, t01.VOLUME,
                                                      seed=t01.SEED)
    keep = np.isin(data["event_group_ids"], sorted(P17_F32_SENSITIVE))
    listfile = str(tmp / "sensitive.hdf5")
    jevtgen.write_events_to_hdf5(listfile, {k: np.asarray(v)[keep] for k, v in data.items()},
                                 attrs)
    out = {}
    for dtype in (jnp.float32, jnp.float64):
        path = str(tmp / f"jax_{dtype.__name__}.hdf5")
        JSimulation(listfile, t02.DETECTOR, config=t02.CONFIG,
                    filter_chain=[JFilterStage(**dataclasses.asdict(f)) for f in t02.FILTERS],
                    triggers=[JTriggerSpec(**t) for t in TRIGGERS], chunk_size=1024,
                    dtype=dtype, outputfilename=path).run()
        out["jax", dtype.__name__] = travel_times(path)
    for dtype in (torch.float32, torch.float64):
        path = str(tmp / f"port_{dtype}.hdf5")
        PSimulation(listfile, t02.DETECTOR, config=t02.CONFIG, filter_chain=t02.FILTERS,
                    triggers=[PTriggerSpec(**t) for t in TRIGGERS], chunk_size=1024,
                    device="cpu", dtype=dtype, outputfilename=path).run()
        out["port", str(dtype).split(".")[-1]] = travel_times(path)
    return out


def departure(a, b):
    """Largest |a - b| over a group's finite travel times, ns."""
    d = np.abs(np.asarray(a, dtype=np.float64) - b)
    return float(np.max(d[np.isfinite(d)]))


def test_float64_travel_times_agree(runs):
    ref, ref_top = runs["jax", "float64"]
    mine, top = runs["port", "float64"]
    assert set(ref) == set(mine) == set(P17_F32_SENSITIVE)
    for gid, t in mine.items():
        assert departure(t, ref[gid]) <= 1e-3, gid
    assert top == ref_top


def test_sensitive_groups_move_in_the_jax_package_in_float32(runs):
    """Prints each group's readings: its float32 travel times' largest
    departure from the JAX package's float64 ones, and whether it fires at
    4 sigma, in either package."""
    ref = runs["jax", "float64"][0]
    for gid in sorted(P17_F32_SENSITIVE):
        jax_ns = departure(runs["jax", "float32"][0][gid], ref[gid])
        port_ns = departure(runs["port", "float32"][0][gid], ref[gid])
        fires = " / ".join(f"{pkg} {dt} {int(runs[pkg, dt][1][gid])}"
                           for pkg in ("jax", "port") for dt in ("float32", "float64"))
        print(f"group {gid}: float32 travel times {jax_ns:.3f} ns (JAX package) / "
              f"{port_ns:.3f} ns (port) from float64; fires at 4 sigma: {fires}")
        assert jax_ns > 0.1, gid
