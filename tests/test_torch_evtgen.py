"""The port's event generator against the JAX package's, and the campaign
inputs against their anchors.

* ``evtgen.generate_eventlist_cylinder`` of the port equals the JAX
  package's column for column, exactly, for the default ccnc/ctw draw, CC
  only, an E^-2 spectrum, named fluxes, a cube volume and stochastic tau
  and muon secondaries; ``generate_unforced`` likewise on a small list.
* The in-memory digest (``evtgen.list_digest``) of the seed-10 lists equals
  the ``input_sha1`` of ``veff_fullscale_reference.npz`` (50,000 events) and
  ``veff_fullscale_pa_reference.npz`` (10,000 events), and the digest of the
  port's HDF5 file read back with h5py as the golden's script reads it.
* The Gen2 tau list regenerated by the port equals its committed export
  ``nuradiomc_tpu_torch/data/gen2_taus_2048_seed21.npz``.
* ``io_input.from_generated`` gives the ``EventInput`` that writing the list
  and reading it back gives.
"""

import dataclasses
import hashlib
import os

import h5py
import numpy as np
import pytest

from nuradiomc_tpu.sim import evtgen as jevtgen
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim import evtgen, io_hdf5, io_input
from nuradiomc_tpu_torch.utils import units

HERE = os.path.dirname(__file__)
CYLINDER = {"fiducial_rmin": 0, "fiducial_rmax": 4 * units.km,
            "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0}
CUBE = {"fiducial_xmin": -1 * units.km, "fiducial_xmax": 2 * units.km,
        "fiducial_ymin": -3 * units.km, "fiducial_ymax": 1 * units.km,
        "fiducial_zmin": -2 * units.km, "fiducial_zmax": 0}

OPTION_SETS = {
    "default ccnc/ctw": dict(n_events=2000, Emin=1e16, Emax=1e20, volume=CYLINDER, seed=1),
    "cc only": dict(n_events=2000, Emin=1e16, Emax=1e20, volume=CYLINDER, seed=2,
                    interaction_type="cc"),
    "E-2 spectrum": dict(n_events=2000, Emin=1e16, Emax=1e20, volume=CYLINDER, seed=3,
                         spectrum="E-2"),
    "named flux": dict(n_events=1000, Emin=1e16, Emax=1e20, volume=CYLINDER, seed=4,
                       spectrum="GZK-1"),
    "summed named fluxes": dict(n_events=1000, Emin=1e16, Emax=1e20, volume=CYLINDER,
                                seed=5, spectrum="IceCube-nu-2022+GZK-2"),
    "cube volume": dict(n_events=2000, Emin=1e17, Emax=1e19, volume=CUBE, seed=6,
                        start_event_id=100, flavor=(12, 14)),
    "stochastic tau secondaries": dict(n_events=64, Emin=1e19, Emax=1e19, volume=CYLINDER,
                                       seed=7, flavor=(16, -16), interaction_type="cc",
                                       secondaries="stochastic"),
    "stochastic muon and tau secondaries": dict(n_events=64, Emin=1e18, Emax=1e20,
                                                volume=CYLINDER, seed=8,
                                                flavor=(14, -14, 16, -16),
                                                secondaries="stochastic"),
}


def _assert_lists_equal(got, ref):
    (d, a), (jd, ja) = got, ref
    assert list(d) == list(jd)
    for key in jd:
        assert d[key].dtype == jd[key].dtype, key
        np.testing.assert_array_equal(d[key], jd[key], err_msg=key)
    assert sorted(a) == sorted(ja)
    for key in ja:
        np.testing.assert_array_equal(a[key], ja[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_generate_eventlist_cylinder_equals_the_jax_package(name):
    kw = dict(OPTION_SETS[name])
    args = [kw.pop(k) for k in ("n_events", "Emin", "Emax", "volume")]
    got = evtgen.generate_eventlist_cylinder(None, *args, **kw)
    ref = jevtgen.generate_eventlist_cylinder(None, *args, **kw)
    _assert_lists_equal(got, ref)
    if kw.get("secondaries"):
        # the option inserted secondary showers (else the case tests nothing)
        assert len(got[0]["shower_ids"]) > args[0]
        assert (got[0]["n_interaction"] > 1).any()


def test_generate_unforced_equals_the_jax_package():
    kw = dict(seed=9, n_chord_samples=256, chunk=512)
    volume = {"fiducial_rmin": 0, "fiducial_rmax": 5 * units.km,
              "fiducial_zmin": -3 * units.km, "fiducial_zmax": 0}
    got = evtgen.generate_unforced(None, 3000, 1e17, 1e20, volume, **kw)
    ref = jevtgen.generate_unforced(None, 3000, 1e17, 1e20, volume, **kw)
    _assert_lists_equal(got, ref)
    assert 0 < len(got[0]["shower_ids"]) < 3000


def test_helpers_equal_the_jax_package():
    rng_a, rng_b = (np.random.default_rng(np.random.Philox(11)) for _ in range(2))
    E = 10 ** np.linspace(16, 20, 50)
    fl = np.resize([12, -12, 14, -14, 16, -16], 50)
    np.testing.assert_array_equal(evtgen.get_ccnc(50, E, fl, rng_a),
                                  jevtgen.get_ccnc(50, E, fl, rng_b))
    np.testing.assert_array_equal(evtgen.get_neutrino_inelasticity(50, rng_a),
                                  jevtgen.get_neutrino_inelasticity(50, rng_b))
    for spectrum in ("log_uniform", "E-2.2", "IceCube-nu-2017", "GZK-2"):
        np.testing.assert_array_equal(evtgen.get_energies(50, 1e16, 1e20, spectrum, rng_a),
                                      jevtgen.get_energies(50, 1e16, 1e20, spectrum, rng_b))
    times = np.array([0.0, 5.0, 3e6, 3e6 + 1.0, 9e6])
    np.testing.assert_array_equal(evtgen.group_into_events(times),
                                  jevtgen.group_into_events(times))
    # BGR18 without its table (a download, not shipped): the JAX package's error
    for module in (evtgen, jevtgen):
        with pytest.raises(FileNotFoundError, match="set_bgr18_table_path"):
            module.get_neutrino_inelasticity(4, rng_a, model="bgr18", nu_energies=np.ones(4),
                                             flavors=np.ones(4), ncccs=np.array(["cc"] * 4))


def _input_sha1(path):
    """The digest of tests/golden/generate_veff_fullscale_golden.py:54, read
    back from an HDF5 file."""
    h = hashlib.sha1()
    with h5py.File(path) as f:
        for k in sorted(f.keys()):
            arr = np.asarray(f[k])
            if arr.dtype.kind in "OU":
                arr = arr.astype("S")
            h.update(k.encode())
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("campaign,golden", [
    ("FULLSCALE_LIST", "veff_fullscale_reference.npz"),
    ("FULLSCALE_PA_LIST", "veff_fullscale_pa_reference.npz")])
def test_campaign_list_digest_equals_the_golden(campaign, golden, tmp_path):
    data, attrs = convert.fullscale_event_list(getattr(convert, campaign))
    digest = evtgen.list_digest(data)
    assert digest == np.load(os.path.join(HERE, "golden", golden))["input_sha1"].item().decode()
    path = str(tmp_path / "list.hdf5")
    evtgen.write_events_to_hdf5(path, data, attrs)
    assert _input_sha1(path) == digest


def _assert_inputs_equal(got, ref):
    for f in dataclasses.fields(io_hdf5.EventInput):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if f.name == "attrs":
            assert sorted(a) == sorted(b)
            for k in b:
                assert type(a[k]) is type(b[k]), k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif b is None:
            assert a is None, f.name
        else:
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_gen2_tau_list_equals_its_export():
    data, attrs = convert.gen2_tau_event_list()
    got = io_input.from_generated(data, attrs)
    ref = io_input.read_input(io_input.INPUT_GEN2)
    for name in io_input._ARRAYS:
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None, name
        else:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert sorted(got.attrs) == sorted(ref.attrs)
    for k in ref.attrs:
        np.testing.assert_array_equal(got.attrs[k], ref.attrs[k], err_msg=k)


@pytest.mark.parametrize("name", ["default ccnc/ctw", "stochastic tau secondaries"])
def test_in_memory_input_equals_the_hdf5_round_trip(name, tmp_path):
    kw = dict(OPTION_SETS[name])
    args = [kw.pop(k) for k in ("n_events", "Emin", "Emax", "volume")]
    path = str(tmp_path / "list.hdf5")
    data, attrs = evtgen.generate_eventlist_cylinder(path, *args, **kw)
    got = io_input.from_generated(data, attrs)
    _assert_inputs_equal(got, io_hdf5.read_input_hdf5(path))
    for key in ("volume", "n_events", "total_number_of_events"):
        assert key in got.attrs
    assert io_input.read_input(got) is got
