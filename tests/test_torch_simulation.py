"""The port's ``Simulation`` on the committed 3000-event 1e18 eV input, held
to NuRadioMC's own output (tests/golden/e2e_reference.npz), with the
assertions of tests/test_e2e.py:

* float64 (production): identical triggered set above the minimum-weight
  cut, weight sum to rtol 1e-6, Veff 0.22978 km^3, and the per-solution
  observables of the output HDF5 at test_e2e's tolerances (C0 1e-7, travel
  times and distances 1e-6, launch vectors 1e-6 absolute, amplitudes 2e-2:
  the reference integrates attenuation with scipy.quad at epsrel 1e-2);
* float32 bench configuration (n_freq 16, GL-8, 28 solver steps, band limit
  1e-2): every golden group, and at most the documented borderline group
  1272 extra (test_e2e.py:147-153); its output file's arrival times are the
  travel times plus the 19.8 ns cable delay, added in float32.
"""

import os

import h5py
import numpy as np
import pytest
import torch

from nuradiomc_tpu.utils import units
from nuradiomc_tpu_torch.convert import DIPOLE_DETECTOR, dipole_simulation
from nuradiomc_tpu_torch.sim.simulation import Simulation

torch.set_num_threads(1)
HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden", "e2e_reference.npz")
INPUT = os.path.join(HERE, "data", "1e18_n3000.hdf5")
MIN_W = 1e-5


def _simulation(dtype, outputfilename=None, propagation=None, perf=None):
    return dipole_simulation(INPUT, {"propagation": propagation or {}, "perf": perf or {}},
                             chunk_size=1024, device="cpu", dtype=dtype,
                             outputfilename=outputfilename)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def run64(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sim64") / "out.hdf5")
    sim = _simulation(torch.float64, outputfilename=out)
    return sim, sim.run(), out


def _triggered_groups(res):
    return set(res["group_ids"][res["triggered"] & (res["weights"] >= MIN_W)])


def test_vrms_matches_reference(golden, run64):
    sim, _, _ = run64
    np.testing.assert_allclose(sim.Vrms, float(golden["Vrms"]), rtol=1e-12)
    np.testing.assert_allclose(sim.bandwidth, float(golden["bandwidth"]), rtol=1e-12)


def test_float64_triggered_set_matches_reference(golden, run64):
    _, res, _ = run64
    assert _triggered_groups(res) == set(np.unique(golden["group_ids"]))


def test_float64_weight_sum_and_veff(golden, run64):
    _, res, _ = run64
    _, first = np.unique(golden["group_ids"], return_index=True)
    sel = res["triggered"] & (res["weights"] >= MIN_W)
    np.testing.assert_allclose(res["weights"][sel].sum(), golden["weights"][first].sum(),
                               rtol=1e-6)
    assert round(res["veff"] / units.km ** 3, 5) == 0.22978


def test_float64_output_observables(golden, run64):
    _, res, out = run64
    with h5py.File(out, "r") as f:
        assert f.attrs["Veff"] == pytest.approx(res["veff"], rel=1e-12)
        st = {k: f["station_101"][k][()] for k in f["station_101"].keys()}
    row_of = {int(s): i for i, s in enumerate(st["shower_id"])}
    for j, sid in enumerate(golden["st_shower_id"]):
        i = row_of[int(sid)]
        have = ~np.isnan(golden["st_ray_tracing_C0"][j, 0])
        np.testing.assert_array_equal(~np.isnan(st["ray_tracing_C0"][i, 0]), have)
        for key, tol in (("ray_tracing_C0", dict(rtol=1e-7)),
                         ("travel_times", dict(rtol=1e-6)),
                         ("travel_distances", dict(rtol=1e-6)),
                         ("launch_vectors", dict(atol=1e-6)),
                         ("max_amp_shower_and_ray", dict(rtol=2e-2))):
            np.testing.assert_allclose(st[key][i, 0][have], golden["st_" + key][j, 0][have],
                                       err_msg=f"{key} shower {sid}", **tol)


def test_float32_bench_config_reproduces_golden(golden, tmp_path):
    out = str(tmp_path / "out.hdf5")
    sim = _simulation(torch.float32, outputfilename=out,
                      propagation={"n_freq": 16, "attenuation_steps": 8, "n_bisect": 28},
                      perf={"band_limit_eps": 1e-2})
    res = sim.run()
    ref = set(np.unique(golden["group_ids"]))
    mine = _triggered_groups(res)
    assert ref <= mine, sorted(ref - mine)
    assert mine - ref <= {1272}, sorted(mine - ref)
    # the arrival times add the cable delay to the travel times in float32
    with h5py.File(out, "r") as f:
        arrival = f["station_101"]["time_shower_and_ray"][()]
        travel = f["station_101"]["travel_times"][()]
    solved = ~np.isnan(travel)
    assert solved.any()
    np.testing.assert_array_equal(
        arrival[solved], travel[solved].astype(np.float32) + np.float32(19.8 * units.ns))


def test_unported_configurations_raise():
    replacements = {"XFDTD_Vpol_CrossFeed_150mmHole_n1.78": "analytic_VPol"}
    # HCRB2017 is a stand-alone op, not a pipeline model
    with pytest.raises(NotImplementedError, match="HCRB2017"):
        Simulation(INPUT, DIPOLE_DETECTOR, config={"signal": {"model": "HCRB2017"}},
                   antenna_replacements=replacements, device="cpu")
    # the ARZ models run, given their shower library
    with pytest.raises(ValueError, match="arz_library_path"):
        Simulation(INPUT, DIPOLE_DETECTOR, config={"signal": {"model": "ARZ2019"}},
                   antenna_replacements=replacements, device="cpu")
    # a tabulated antenna with neither its table on disk nor a replacement
    with pytest.raises(NotImplementedError, match="antenna_models_path"):
        Simulation(INPUT, DIPOLE_DETECTOR, device="cpu")
