"""The port's example workflows that run ``Simulation`` (examples 01, 02, 05,
09, 10, 11, 13 and 15), each held to its JAX example on the CPU.

Each port module (``nuradiomc_tpu_torch.examples``) runs with
``device="cpu"`` at ``tests/test_examples.py``'s small argv or smaller. The
JAX side is the JAX example script itself, run in this process with
``runpy`` at the same argv in a temporary directory (module-scoped
fixtures), or, for the float64 reruns of 01 and 09 whose scripts fix
float32, the JAX package's ``Simulation`` at the script's configuration
(the float64 ladder, whose 2 sigma rung is example 01's trigger).
Both print the strings ``tests/test_examples.py`` looks for. Tolerances:

* noiseless float64 runs (05, 10, 11, and 01 and 09 in float64): the same
  triggered set, Veff at rtol 1e-6;
* float32 runs (01, 09): the same sets but for at most 2 groups, each within
  1e-3 relative of the threshold (its float64 decision changes between
  0.999 and 1.001 times the threshold, ``near_threshold``);
* deterministic outputs (the lists of 01, 13 and 15): equal;
* noisy runs (02, 13): the triggered count (each named trigger's too) within
  4 binomial standard deviations of the JAX example's (the difference of
  two counts over the same groups, sigma = sqrt(2 N p (1 - p)) at the pooled
  rate p, at least 1).

The HDF5 steps run here, where h5py imports; each example's route without
h5py (``.npz`` lists and results, the card's machine) is run too and must
give the same numbers.
"""

import dataclasses
import json
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.sim import evtgen as jevtgen
from nuradiomc_tpu.sim.simulation import FilterStage as JFilterStage
from nuradiomc_tpu.sim.simulation import Simulation as JSimulation
from nuradiomc_tpu.sim.simulation import TriggerSpec as JTriggerSpec
from nuradiomc_tpu_torch.examples import EXAMPLES, _common
from nuradiomc_tpu_torch.examples.e01_veff_simulation import t02_run_simulation as t02
from nuradiomc_tpu_torch.examples.e09_threshold_ladder import run_ladder
from nuradiomc_tpu_torch.sim import io_input
from nuradiomc_tpu_torch.sim.simulation import Simulation as PSimulation
from nuradiomc_tpu_torch.sim.simulation import TriggerSpec as PTriggerSpec
from nuradiomc_tpu_torch.utils import units

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_example_runs import run_jax, run_port  # noqa: E402

torch.set_num_threads(1)

N_LIST = 300          # tests/test_examples.py's list for 01 and 09


def fired_set(res, col=None):
    trig = res["triggered"] if col is None else res["multiple_triggers"][:, col]
    return set(np.asarray(res["group_ids"])[np.asarray(trig, dtype=bool)].tolist())


def near_threshold(inputfile, group_ids, sigmas=run_ladder.SIGMAS, rel=1e-3):
    """[groups, rungs] bool, rows in ascending group id: whether the
    decision of each of the event groups ``group_ids`` of ``inputfile`` at
    each rung changes between (1 - rel) and (1 + rel) times its thresholds,
    in float64 on the CPU: the groups within ``rel`` of a threshold, where
    float32 runs may decide either way."""
    inp = io_input.select(io_input.read_input(inputfile), group_ids)
    decisions = []
    for f in (1 - rel, 1 + rel):
        sim = PSimulation(
            inp, run_ladder.DETECTOR, config=run_ladder.CONFIG,
            filter_chain=run_ladder.FILTERS,
            triggers=[PTriggerSpec(name=f"hilo_{s:g}sigma", threshold_high_sigma=s * f,
                                  threshold_low_sigma=-s * f) for s in sigmas],
            chunk_size=1024, device="cpu", dtype=torch.float64)
        decisions.append(sim.run()["multiple_triggers"])
    return decisions[0] != decisions[1]


def assert_f32_sets(mine, ref, listfile, rung, sigmas=run_ladder.SIGMAS):
    """Float32 sets of the same list: at most 2 groups differ, each within
    1e-3 relative of the rung's threshold (its float64 decision changes
    between 0.999 and 1.001 times the threshold)."""
    differ = sorted(mine ^ ref)
    assert len(differ) <= 2, differ
    if differ:
        assert np.all(near_threshold(listfile, differ, sigmas)[:, rung]), differ


def assert_binomial(n_mine, n_ref, n):
    p = (n_mine + n_ref) / (2 * n)
    sigma = max(np.sqrt(2 * n * p * (1 - p)), 1.0)
    assert abs(n_mine - n_ref) <= 4 * sigma, (n_mine, n_ref, sigma)


def jax_simulation(inputfile, module, dtype, triggers):
    """The JAX package's ``Simulation`` at a port module's configuration."""
    return JSimulation(
        inputfile, module.DETECTOR, config=module.CONFIG,
        filter_chain=[JFilterStage(**dataclasses.asdict(f)) for f in module.FILTERS],
        triggers=[JTriggerSpec(**dataclasses.asdict(t)) for t in triggers],
        chunk_size=1024, dtype=dtype)


# ---- 01 and 09: the dipole list, Veff, the threshold ladder ------------------

@pytest.fixture(scope="module")
def dipole(tmp_path_factory):
    port_dir = tmp_path_factory.mktemp("port01")
    jax_dir = tmp_path_factory.mktemp("jax01")
    out = {name: run_port(name, [str(N_LIST)] if name == "e01_t01" else [], port_dir)
           for name in ("e01_t01", "e01_t02", "e01_t03", "e09")}
    listfile = str(port_dir / "1e18_full.hdf5")
    jax = {"t02": run_jax("01_Veff_simulation/T02_run_simulation.py", [listfile], jax_dir),
           "t03": run_jax("01_Veff_simulation/T03_visualize_Veff.py", [], jax_dir),
           "ladder": run_jax("09_threshold_ladder/run_ladder.py", [listfile], jax_dir)}
    triggers = [dataclasses.replace(t02.TriggerSpec(), name=f"hilo_{s:g}sigma",
                                    threshold_high_sigma=s, threshold_low_sigma=-s)
                for s in run_ladder.SIGMAS]
    f64 = {"t02": run_port("e01_t02", [], port_dir, dtype=torch.float64)[0],
           "ladder": run_port("e09", [], port_dir, dtype=torch.float64)[0],
           "jax_ladder": jax_simulation(listfile, t02, jnp.float64, triggers).run()}
    return out, jax, f64, listfile, port_dir


def test_veff_list_equals_the_jax_generator(dipole):
    out, _, _, listfile, _ = dipole
    data, attrs = jevtgen.generate_eventlist_cylinder(
        None, N_LIST, 1e18, 1e18, {"fiducial_rmin": 0, "fiducial_rmax": 4 * units.km,
                                   "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0},
        seed=10)
    mine = io_input.read_input(listfile)
    for key in ("event_group_ids", "xx", "yy", "zz", "zeniths", "azimuths", "energies",
                "shower_energies", "inelasticity", "vertex_times"):
        np.testing.assert_array_equal(getattr(mine, key), data[key])
    assert out["e01_t01"][0]["n_events"] == attrs["n_events"]


def test_veff_example_float32(dipole):
    out, jax, _, listfile, _ = dipole
    (mine, text), (g, jtext) = out["e01_t02"], jax["t02"]
    assert "Veff" in text and "Veff" in jtext
    assert_f32_sets(fired_set(mine["results"]), fired_set(g["results"]), listfile, 0, (2.0,))
    # rtol: the f32 Veff of equal sets
    if fired_set(mine["results"]) == fired_set(g["results"]):
        np.testing.assert_allclose(mine["veff"], g["results"]["veff"], rtol=1e-6)


def test_veff_example_float64(dipole):
    """Example 01 in float64 against the JAX package's float64 ladder's
    2 sigma rung (the same trigger on the same traces)."""
    _, _, f64, _, _ = dipole
    mine, ref = f64["t02"]["results"], f64["jax_ladder"]
    assert fired_set(mine) == fired_set(ref, 1)
    np.testing.assert_allclose(mine["veff"], ref["veff_per_trigger"]["hilo_2sigma"], rtol=1e-6)


def test_veff_table(dipole, monkeypatch, tmp_path):
    out, jax, _, _, port_dir = dipole
    (mine, text), (g, jtext) = out["e01_t03"], jax["t03"]
    assert "km^3 sr" in text and "km^3 sr" in jtext
    (jr,), (mr,) = g["results"], mine["tables"]
    if fired_set(out["e01_t02"][0]["results"]) == fired_set(jax["t02"][0]["results"]):
        for key in ("veff", "n_triggered", "solid_angle", "veff_low", "veff_high"):
            np.testing.assert_allclose(mr[key], jr[key], rtol=1e-6)
    # the route without h5py: the table from the results dict equals the HDF5 one
    monkeypatch.setattr(_common, "hdf5", lambda: False)
    run_port("e01_t01", [str(N_LIST)], tmp_path)
    run_port("e01_t02", [], tmp_path)
    npz, npz_text = run_port("e01_t03", [], tmp_path)
    assert "results dict (no h5py)" in npz_text and (tmp_path / "1e18_full.npz").exists()
    assert npz["rows"] == mine["rows"]


def test_ladder_float32(dipole):
    out, jax, _, listfile, _ = dipole
    (mine, text), (g, jtext) = out["e09"], jax["ladder"]
    for t in (text, jtext):
        assert "hilo_1.5sigma" in t and "loose_not_tight" in t
    assert os.path.exists(mine["yaml"])
    res, ref = mine["results"], g["results"]
    assert res["trigger_names"] == ref["trigger_names"]
    for iT in range(len(run_ladder.SIGMAS)):
        assert_f32_sets(fired_set(res, iT), fired_set(ref, iT), listfile, iT)


def test_ladder_float64_and_table(dipole, monkeypatch, tmp_path):
    out, jax, f64, _, _ = dipole
    res, ref = f64["ladder"]["results"], f64["jax_ladder"]
    for iT, name in enumerate(ref["trigger_names"]):
        assert fired_set(res, iT) == fired_set(ref, iT), name
        np.testing.assert_allclose(res["veff_per_trigger"][name], ref["veff_per_trigger"][name],
                                   rtol=1e-6)
    # the f64 2 sigma rung is example 01's float64 run
    assert fired_set(res, 1) == fired_set(f64["t02"]["results"])
    # the JAX example's table of its own (float32) output, and the port's
    # table of its results without h5py, against the port's HDF5 table
    post, jpost = out["e09"][0]["post"], jax["ladder"][0]["post"]
    same = all(fired_set(out["e09"][0]["results"], i) == fired_set(jax["ladder"][0]["results"], i)
               for i in range(len(run_ladder.SIGMAS)))
    for name, v in jpost["veffs"].items():
        if same:
            np.testing.assert_allclose(post["veffs"][name], v, rtol=1e-6)
    monkeypatch.setattr(_common, "hdf5", lambda: False)
    run_port("e01_t01", [str(N_LIST)], tmp_path)
    npz = run_port("e09", [], tmp_path)[0]
    assert npz["route"] == "results dict (no h5py)"
    for name, v in post["veffs"].items():
        np.testing.assert_array_equal(npz["post"]["veffs"][name], v)


# ---- 02: the phased array with noise -----------------------------------------

def test_phased_array_example(dipole, tmp_path):
    _, _, _, listfile, _ = dipole
    mine, text = run_port("e02", [listfile], tmp_path)
    g, jtext = run_jax("02_phased_array/run_pa_veff.py", [listfile], tmp_path)
    assert "Veff*4pi" in text and "Veff*4pi" in jtext
    assert_binomial(mine["n_triggered"], g["results"]["n_triggered"], mine["n_groups"])


# ---- 05: the mesh --------------------------------------------------------------

def test_multichip_example(tmp_path):
    mine, text = run_port("e05", ["60", "--procs", "4"], tmp_path)
    g, jtext = run_jax("05_multichip/run_sharded_veff.py", ["60"], tmp_path)
    assert "mesh: {'event': 4, 'channel': 2}" in jtext and "triggered" in jtext
    assert "mesh: {'event': 2, 'channel': 2}" in text and "triggered" in text
    assert mine["ranks_agree"]
    assert mine["step_triggered"] == int(g["n_trig"])
    ref = g["res"]
    assert mine["n_triggered"] == ref["n_triggered"]
    np.testing.assert_array_equal(mine["group_ids"], ref["group_ids"])
    np.testing.assert_array_equal(mine["triggered"], ref["triggered"])
    np.testing.assert_allclose(mine["veff"], ref["veff"], rtol=1e-6)


# ---- 10: the pulser sweep ---------------------------------------------------

def test_pulser_calibration_example(tmp_path, monkeypatch):
    run_port("e10_a01", ["12"], tmp_path)
    mine, text = run_port("e10_a02", [], tmp_path)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    run_jax("10_pulser_calibration/A01_generate_pulser_events.py", ["12"], jdir)
    g, jtext = run_jax("10_pulser_calibration/A02_run_simulation.py", [], jdir)
    seq = [int(x) for x in re.search(r"amplitude sweep: \[(.*)\]", text).group(1).split(",")]
    first = seq.index(1) if 1 in seq else len(seq)
    assert all(v == 1 for v in seq[first:]) and any(seq), seq
    assert seq == np.asarray(g["res"]["triggered"]).astype(int).tolist()
    assert "triggered" in jtext
    # the route without h5py: the list as the EventInput the HDF5 reader builds
    monkeypatch.setattr(_common, "hdf5", lambda: False)
    npz_dir = tmp_path / "npz"
    run_port("e10_a01", ["12"], npz_dir)
    assert run_port("e10_a02", [], npz_dir)[0]["sweep"] == seq
    a, b = (io_input.read_input(p) for p in (tmp_path / "emitter_event_list.hdf5",
                                              npz_dir / "emitter_event_list.npz"))
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "emitter":
            assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        elif f.name == "attrs":
            assert {k: str(v) for k, v in x.items()} == {k: str(v) for k, v in y.items()}
        else:
            assert np.array_equal(x, y) if x is not None else y is None, f.name


# ---- 11: station coincidences -------------------------------------------------

def test_station_coincidences_example(tmp_path, monkeypatch):
    run_port("e11_a01", ["900"], tmp_path)
    mine, text = run_port("e11_a02", ["150"], tmp_path)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    run_jax("11_station_coincidences/A01_create_detector.py", ["900"], jdir)
    g, jtext = run_jax("11_station_coincidences/A02_run_and_analyze.py", ["150"], jdir)
    with open(tmp_path / "coincidence_detector.json") as f, \
            open(jdir / "coincidence_detector.json") as h:
        assert json.load(f) == json.load(h)
    for t in (text, jtext):
        assert "coincidences (>=2 stations):" in t
        assert t.count("in coincidence with center") == 3
    assert mine["fired"] == g["fired"]
    assert mine["n_coincidences"] == g["n_coinc"]
    assert fired_set(mine["results"]) == fired_set(g["res"])
    np.testing.assert_allclose(mine["results"]["veff"], g["res"]["veff"], rtol=1e-6)
    monkeypatch.setattr(_common, "hdf5", lambda: False)
    npz = run_port("e11_a02", ["150"], tmp_path)[0]
    assert npz["route"] == "results dict (no h5py)" and npz["fired"] == mine["fired"]


# ---- 13: the webinar chain ----------------------------------------------------

@pytest.fixture(scope="module")
def webinar(tmp_path_factory):
    port_dir = tmp_path_factory.mktemp("port13")
    jax_dir = tmp_path_factory.mktemp("jax13")
    port = {name: run_port(name, EXAMPLES[name][1], port_dir)
            for name in ("e13_w01", "e13_w02", "e13_w03", "e13_w04", "e13_w05")}
    jax = {}
    for script, argv in (("W01_create_input.py", ["150"]),
                         ("W02_run_simulation.py",
                          ["--outputfilenameNuRadioReco", "results/NuMC_output.nur"]),
                         ("W03_check_output.py", []), ("W04_effective_volumes.py", []),
                         ("W05_electric_fields.py", [])):
        jax[script[:3]] = run_jax("13_webinar/" + script, argv, jax_dir)
    return port, jax, port_dir, jax_dir


def test_webinar_lists_equal(webinar):
    _, _, port_dir, jax_dir = webinar
    for name in ("input_1e18.hdf5", "input_3.2e+17_1.0e+19.hdf5"):
        a, b = (io_input.read_input(str(d / "input" / name)) for d in (port_dir, jax_dir))
        for f in dataclasses.fields(a):
            if f.name not in ("attrs", "emitter") and getattr(b, f.name) is not None:
                np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), f.name)


def test_webinar_chain(webinar):
    port, jax, port_dir, _ = webinar
    assert "Veff" in port["e13_w02"][1] and "Veff" in jax["W02"][1]
    mine, ref = port["e13_w02"][0]["results"], jax["W02"][0]["res"]
    n = len(mine["group_ids"])
    assert_binomial(int(mine["n_triggered"]), int(ref["n_triggered"]), n)
    for iT, name in enumerate(ref["trigger_names"]):
        assert mine["trigger_names"][iT] == name
        assert_binomial(int(mine["multiple_triggers"][:, iT].sum()),
                        int(np.asarray(ref["multiple_triggers"])[:, iT].sum()), n)
    assert "fired" in port["e13_w03"][1] and "fired" in jax["W03"][1]
    assert "km^3 sr" in port["e13_w04"][1] and (port_dir / "Veff_webinar.json").exists()
    assert "electric fields inspected" in port["e13_w05"][1]
    assert "electric fields inspected" in jax["W05"][1]


def test_webinar_without_h5py(webinar, monkeypatch, tmp_path):
    port, _, _, _ = webinar
    monkeypatch.setattr(_common, "hdf5", lambda: False)
    out = {name: run_port(name, EXAMPLES[name][1], tmp_path)
           for name in ("e13_w01", "e13_w02", "e13_w03", "e13_w04")}
    assert (tmp_path / "input" / "input_1e18.npz").exists()
    assert (tmp_path / "results" / "NuMC_output.npz").exists()
    assert "results dict (no h5py)" in out["e13_w03"][1]
    # the noise is the port's own and seeded: the same numbers on either route
    assert out["e13_w02"][0]["n_triggered"] == port["e13_w02"][0]["n_triggered"]
    assert out["e13_w03"][0]["n_fired"] == port["e13_w03"][0]["n_fired"]
    assert out["e13_w04"][0]["rows"] == port["e13_w04"][0]["rows"]


# ---- 15: the generator template -----------------------------------------------

def test_custom_generator_example(tmp_path, monkeypatch):
    import h5py

    mine, text = run_port("e15", [], tmp_path)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    run_jax("15_custom_generator/generate_my_events.py", [], jdir)
    with h5py.File(tmp_path / "testfile.hdf5") as f, h5py.File(jdir / "testfile.hdf5") as h:
        assert f.attrs["n_events"] == 20 and set(np.asarray(f["shower_type"]).astype(str)) == {
            "had"}
        assert set(f.keys()) == set(h.keys()) and set(f.attrs) == set(h.attrs)
        for k in f:
            np.testing.assert_array_equal(np.asarray(f[k]), np.asarray(h[k]), k)
        for k in f.attrs:
            np.testing.assert_array_equal(f.attrs[k], h.attrs[k], k)
    assert io_input.read_input(str(tmp_path / "testfile.hdf5")).n_showers == 20
    monkeypatch.setattr(_common, "hdf5", lambda: False)
    npz = run_port("e15", [], tmp_path / "npz")[0]
    a, b = io_input.read_input(npz["path"]), io_input.read_input(mine["path"])
    for f in dataclasses.fields(a):
        if f.name not in ("attrs", "emitter") and getattr(a, f.name) is not None:
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), f.name)
