"""NuRadioMC's atmospheric-muon effective-area campaign
(test/atmospheric_Aeff/1e18eV) through the port on the CPU, held to the JAX
package.

* The port's ``evtgen.generate_surface_muons`` gives the JAX generator's
  lists seed for seed (``list_digest`` equal) with ``parametrized`` and
  ``stochastic`` secondaries; ``proposal`` raises as it does there.
* The port's copy of ``sim/muon_flux.py`` (the Gaisser backend, the only
  one on either machine) equals the original.
* 300 muons of the campaign's list (stochastic secondaries) through the
  port's ``Simulation`` in float64: weights identically 1, the triggered set,
  trigger times and amplitudes equal to the JAX package's ``Simulation``
  on the same list (times rtol 1e-9; amplitudes rtol 2e-4, the turning-point
  property of ROADMAP.md: a refracted ray's arrival moves by ~1e-4 ns
  between two correct implementations, which moves the peak of a channel's
  two-pulse sum by up to ~1e-4 relative, as in the other files' JAX
  comparisons); the results-dict Aeff (``veff.aeff_from_results``, what
  the card computes without h5py) equal to the port's
  ``get_Veff_Aeff_single(..., veff_aeff="aeff_surface_muons")`` on the
  run's output HDF5 at rtol 1e-9.

Run as a script, the file writes
``nuradiomc_tpu_torch/data/surface_muons_jax_sets.npz``: the JAX package's
float64 triggered set of the whole 2500-muon list, which ``chip_smoke.py``
phase 11 (e) holds the card's campaign to.
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax.numpy as jnp  # noqa: E402

from nuradiomc_tpu.sim import evtgen as jevtgen  # noqa: E402
from nuradiomc_tpu.sim import muon_flux as jflux  # noqa: E402
from nuradiomc_tpu.sim.simulation import FilterStage, Simulation, TriggerSpec  # noqa: E402
from nuradiomc_tpu_torch import convert  # noqa: E402
from nuradiomc_tpu_torch.sim import evtgen, io_input, veff  # noqa: E402
from nuradiomc_tpu_torch.sim import muon_flux  # noqa: E402
from nuradiomc_tpu_torch.sim.io_input import DATA_DIR  # noqa: E402
from nuradiomc_tpu_torch.utils import units  # noqa: E402

torch.set_num_threads(1)
N_CPU = 300
JAX_SETS = DATA_DIR / "surface_muons_jax_sets.npz"


def _jax_list(filename, n_events, secondaries):
    kw = dict(convert.SURFACE_MUON_LIST, secondaries=secondaries)
    kw.pop("n_events")
    return jevtgen.generate_surface_muons(filename, n_events, kw.pop("Emin"), kw.pop("Emax"),
                                          kw.pop("volume"), **kw)


def _jax_simulation(infile, outfile=None):
    """tests/test_atmospheric_aeff.py's JAX Simulation of a list file."""
    return Simulation(
        infile, convert.DIPOLE_DETECTOR, config=convert.DIPOLE_CONFIG,
        filter_chain=[FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
                      FilterStage((0, 500 * units.MHz), "butter", {"order": 10})],
        trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
        antenna_replacements={"XFDTD_Vpol_CrossFeed_150mmHole_n1.78": "analytic_VPol"},
        chunk_size=256, dtype=jnp.float64, outputfilename=outfile)


@pytest.mark.parametrize("secondaries", ["parametrized", "stochastic"])
def test_lists_equal_the_jax_generator(secondaries):
    data, attrs = convert.surface_muon_event_list(secondaries=secondaries)
    ref, ref_attrs = _jax_list(None, 2500, secondaries)
    assert evtgen.list_digest(data) == evtgen.list_digest(ref)
    assert sorted(attrs) == sorted(ref_attrs)
    for key, value in ref_attrs.items():
        np.testing.assert_array_equal(attrs[key], value, err_msg=key)
    assert attrs["simulation_mode"] == "atmospheric_muon"
    if secondaries == "stochastic":
        assert len(data["xx"]) > 2500     # several losses per muon


def test_proposal_raises_as_in_jax():
    for gen in (evtgen.generate_surface_muons, jevtgen.generate_surface_muons):
        with pytest.raises((ImportError, NotImplementedError)):
            gen(None, 4, 1e18, 1e18, convert.SURFACE_MUON_LIST["volume"], seed=1,
                secondaries="proposal")


def test_muon_flux_equals_the_original():
    E = 10 ** np.linspace(11, 20, 40)
    for theta in np.deg2rad([0.0, 45.0, 60.0, 85.0]):
        np.testing.assert_array_equal(muon_flux.gaisser_flux(E, theta),
                                      jflux.gaisser_flux(E, theta))
    port, ref = muon_flux.MuonFlux("unused.pkl"), jflux.MuonFlux("unused.pkl")
    assert not port._have_mceq() and not ref._have_mceq()
    for a, b in zip(port.get_mu_flux(np.deg2rad(60)), ref.get_mu_flux(np.deg2rad(60))):
        np.testing.assert_array_equal(a, b)
    lo, hi = np.deg2rad(58), np.deg2rad(62)
    np.testing.assert_array_equal(port.get_int_angle_mu_flux_buffered(1e15, lo, hi),
                                  ref.get_int_angle_mu_flux_buffered(1e15, lo, hi))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The first 300 muons of the campaign's list through both packages."""
    tmp = tmp_path_factory.mktemp("muons")
    infile = str(tmp / "mu.hdf5")
    _jax_list(infile, N_CPU, "stochastic")
    data, attrs = convert.surface_muon_event_list(N_CPU)
    out = str(tmp / "port.hdf5")
    res = convert.surface_muon_simulation(io_input.from_generated(data, attrs), device="cpu",
                                          dtype=torch.float64, outputfilename=out).run()
    ref = _jax_simulation(infile).run()
    return res, ref, out


def test_weights_are_one(runs):
    res, ref, _ = runs
    np.testing.assert_array_equal(res["weights"], 1.0)
    np.testing.assert_array_equal(ref["weights"], 1.0)


def test_triggered_set_equals_jax(runs):
    res, ref, _ = runs
    np.testing.assert_array_equal(res["group_ids"], ref["group_ids"])
    np.testing.assert_array_equal(res["triggered"], ref["triggered"])
    assert res["n_triggered"] == ref["n_triggered"] >= 3
    np.testing.assert_array_equal(res["trigger_times"] == 0, ref["trigger_times"] == 0)
    np.testing.assert_allclose(res["trigger_times"], ref["trigger_times"], rtol=1e-9,
                               atol=1e-6)
    np.testing.assert_allclose(res["max_amplitude"], ref["max_amplitude"], rtol=2e-4, atol=1e-15)


def test_results_carry_the_generation_area(runs):
    res, _, _ = runs
    _, attrs = convert.surface_muon_event_list(N_CPU)
    assert res["area"] == attrs["area"] and res["n_events"] == N_CPU
    assert (res["thetamin"], res["thetamax"]) == (attrs["thetamin"], attrs["thetamax"])


def test_results_aeff_equals_the_output_file(runs):
    res, _, out = runs
    post = veff.get_Veff_Aeff_single(out, veff_aeff="aeff_surface_muons", min_weight=0.0)
    ref = post["aeff_surface_muons"][post["trigger_names"][0]][0]
    np.testing.assert_allclose(res["aeff"], ref, rtol=1e-9)
    projected = res["area"] * 0.5 * (np.cos(res["thetamin"]) + np.cos(res["thetamax"]))
    np.testing.assert_allclose(res["aeff"], projected * res["n_triggered"] / N_CPU, rtol=1e-12)


def write_jax_sets(path=JAX_SETS):
    """The JAX package's float64 set of the whole 2500-muon list."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        infile = os.path.join(tmp, "mu.hdf5")
        _jax_list(infile, 2500, "stochastic")
        res = _jax_simulation(infile).run()
    np.savez(path, group_ids=res["group_ids"], triggered=res["triggered"],
             weights=res["weights"], n_triggered=res["n_triggered"])
    print(f"wrote {path}: {res['n_triggered']} of {len(res['triggered'])} groups triggered")


if __name__ == "__main__":
    import conftest  # noqa: F401  (the JAX package on the CPU, float64)
    write_jax_sets()
