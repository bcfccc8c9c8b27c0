"""The port's BGR18/HEDIS cross-section path held to the JAX package, on the
synthetic table of tests/test_bgr18.py (dsigma/dy = A(E) y^-0.7 on 21
energies x 200 y values, six flavors, nc and cc; ``convert.make_bgr18_table``
writes it, and the first test holds it to that file's own construction).

The module fixture points both packages at the table and, on exit, back at
their old paths with their caches cleared. Against the JAX package:

* ``integrate_pwpl`` at rtol 1e-12, and against its closed form;
* ``get_nu_cross_section(..., "hedis_bgr18")`` for the six flavors x total /
  cc / nc / array inttype, on and between the grid's energy nodes, at rtol
  1e-12, and the interaction length;
* the inelasticity draws and ``get_ccnc`` bit-equal given the same
  ``np.random.default_rng(seed)``, and both generators' lists bit-equal at
  seed 5;
* ``earth_attenuation.get_weight`` in each mode at rtol 1e-12 (the 'simple'
  mode asks for flavor 0, which a BGR18 table does not hold: both packages
  raise the same error);
* a 400-event float64 ``Simulation`` with BGR18 weights on the CPU: the same
  triggered set, weights at rtol 1e-12 and Veff at rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_bgr18 as jt
from nuradiomc_tpu.sim import cross_sections as jxs
from nuradiomc_tpu.sim import earth_attenuation as jea
from nuradiomc_tpu.sim import evtgen as jevt
from nuradiomc_tpu.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu.utils import units
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim import cross_sections as txs
from nuradiomc_tpu_torch.sim import earth_attenuation as tea
from nuradiomc_tpu_torch.sim import evtgen as tevt
from nuradiomc_tpu_torch.sim import io_input
from torch_port_inputs import write_input_hdf5

torch.set_num_threads(1)
FLAVORS = [12, -12, 14, -14, 16, -16]
INTTYPES = ["total", "cc", "nc", "array"]
MODES = ["simple", "core_mantle_crust_simple", "core_mantle_crust", "PREM", "None"]
# the campaign's volume, cut so that a few hundred events trigger often
VOLUME = {"fiducial_rmin": 0, "fiducial_rmax": 1 * units.km,
          "fiducial_zmin": -1 * units.km, "fiducial_zmax": 0}
MIN_W = 1e-5


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = convert.make_bgr18_table(str(tmp_path_factory.mktemp("bgr18") / "bgr18_synth.npz"))
    old = jxs._BGR18_PATH, txs._BGR18_PATH
    jxs.set_bgr18_table_path(path)
    txs.set_bgr18_table_path(path)
    yield path
    jxs.set_bgr18_table_path(old[0])
    txs.set_bgr18_table_path(old[1])


def test_table_is_the_jax_tests_table(table):
    got = np.load(table)
    np.testing.assert_array_equal(got["nu_energies_ref"], jt.E_GRID)
    np.testing.assert_array_equal(got["y_ref"], jt.Y_GRID)
    np.testing.assert_array_equal(got["flavors_ref"], jt.FLAVORS)
    assert list(got["ncccs_ref"]) == ["NC", "CC"]
    assert convert.BGR18_SLOPE == jt.B_SLOPE
    for iF in range(len(jt.FLAVORS)):
        for iI in range(2):
            for iE in range(len(jt.E_GRID)):
                np.testing.assert_array_equal(got["dsigma_dy_ref"][iF, iI, iE],
                                              jt._amplitude(iE, iF, iI) * jt.Y_GRID ** jt.B_SLOPE)


def test_missing_table_names_the_setter(table, tmp_path):
    txs.set_bgr18_table_path(str(tmp_path / "absent.npz"))
    try:
        with pytest.raises(FileNotFoundError, match="set_bgr18_table_path"):
            txs.get_nu_cross_section(1e18, 12, "cc", "hedis_bgr18")
    finally:
        txs.set_bgr18_table_path(table)


@pytest.mark.parametrize("low, high", [(None, None), (0, 1), (0, None), (None, 1)])
def test_integrate_pwpl(table, low, high):
    y = 2.5 * jt.Y_GRID ** jt.B_SLOPE
    b1 = jt.B_SLOPE + 1
    lo = jt.Y_GRID[0] if low is None else low
    hi = jt.Y_GRID[-1] if high is None else high
    got = txs.integrate_pwpl(y, jt.Y_GRID, low=low, high=high)
    np.testing.assert_allclose(got, 2.5 * (hi ** b1 - lo ** b1) / b1, rtol=1e-12)
    np.testing.assert_allclose(got, jxs.integrate_pwpl(y, jt.Y_GRID, low=low, high=high),
                               rtol=1e-12)
    total, (cum, x) = txs.integrate_pwpl(y, jt.Y_GRID, low=low, high=high, full_output=True)
    jtotal, (jcum, jx) = jxs.integrate_pwpl(y, jt.Y_GRID, low=low, high=high, full_output=True)
    np.testing.assert_allclose(total, jtotal, rtol=1e-12)
    np.testing.assert_allclose(cum, jcum, rtol=1e-12)
    np.testing.assert_array_equal(x, jx)
    # the whole table at once, as the reader integrates it
    dsdy = np.load(table)["dsigma_dy_ref"]
    np.testing.assert_allclose(txs.integrate_pwpl(dsdy, jt.Y_GRID, low=low, high=high),
                               jxs.integrate_pwpl(dsdy, jt.Y_GRID, low=low, high=high),
                               rtol=1e-12)


def _energies():
    nodes = jt.E_GRID
    mids = 0.5 * (nodes[1:] + nodes[:-1])
    drawn = 10 ** np.random.default_rng(1).uniform(15, 20, 40)
    return np.concatenate([nodes, mids, drawn])


@pytest.mark.parametrize("inttype", INTTYPES)
@pytest.mark.parametrize("flavor", FLAVORS)
def test_cross_section(table, flavor, inttype):
    energy = _energies()
    if inttype == "array":
        it = np.random.default_rng(2).choice(["cc", "nc", "CC"], len(energy))
    else:
        it = inttype
    for model in ("hedis_bgr18", "hedis", "bgr18"):
        got = txs.get_nu_cross_section(energy, flavor, it, model)
        want = jxs.get_nu_cross_section(energy, flavor, it, model)
        assert got.shape == energy.shape
        np.testing.assert_allclose(got, want, rtol=1e-12)
    # at the nodes, the closed form A(E) / (B + 1) per ice nucleus / 18
    iF = FLAVORS.index(flavor)
    scale = units.cm ** 2 / 18 / (jt.B_SLOPE + 1)
    amp = np.array([[jt._amplitude(iE, iF, iI) for iI in (0, 1)]
                    for iE in range(len(jt.E_GRID))]) * scale
    n = len(jt.E_GRID)
    is_cc = np.char.lower(np.broadcast_to(np.asarray(it), energy.shape).astype(str)) == "cc"
    closed = {"total": amp.sum(1), "cc": amp[:, 1], "nc": amp[:, 0],
              "array": np.where(is_cc[:n], amp[:, 1], amp[:, 0])}[inttype]
    np.testing.assert_allclose(txs.get_nu_cross_section(energy, flavor, it, "hedis_bgr18")[:n],
                               closed, rtol=1e-9)
    np.testing.assert_allclose(
        txs.get_interaction_length(energy, flavor=flavor, inttype=it,
                                   cross_section_type="hedis_bgr18"),
        jxs.get_interaction_length(energy, flavor=flavor, inttype=it,
                                   cross_section_type="hedis_bgr18"), rtol=1e-12)
    with pytest.raises(ValueError):
        txs.get_nu_cross_section(jt.E_GRID[0] / 10, flavor, "cc", "hedis_bgr18")


@pytest.mark.parametrize("model", ["hedis_bgr18", "bgr18", "hedis"])
def test_draws_are_bit_equal(table, model):
    rng = np.random.default_rng(7)
    n = 5000
    energies = 10 ** rng.uniform(15, 20, n)
    flavors = rng.choice(FLAVORS, n)
    ncccs = rng.choice(["cc", "nc"], n)
    got = tevt.get_neutrino_inelasticity(n, np.random.default_rng(8), model,
                                         nu_energies=energies, flavors=flavors, ncccs=ncccs)
    want = jevt.get_neutrino_inelasticity(n, np.random.default_rng(8), model,
                                          nu_energies=energies, flavors=flavors, ncccs=ncccs)
    np.testing.assert_array_equal(got, want)
    assert np.all((got > 0) & (got <= 1))
    np.testing.assert_array_equal(
        txs.get_neutrino_inelasticity_bgr18(n, np.random.default_rng(9), energies, flavors, ncccs),
        jxs.get_neutrino_inelasticity_bgr18(n, np.random.default_rng(9), energies, flavors, ncccs))
    # scalar arguments broadcast the same way in both packages
    np.testing.assert_array_equal(
        tevt.get_neutrino_inelasticity(300, np.random.default_rng(10), model),
        jevt.get_neutrino_inelasticity(300, np.random.default_rng(10), model))
    got = tevt.get_ccnc(n, energies, flavors, np.random.default_rng(11), model)
    want = jevt.get_ccnc(n, energies, flavors, np.random.default_rng(11), model)
    np.testing.assert_array_equal(got, want)
    assert 0 < np.mean(got == "cc") < 1


def _generate(evtgen, kind):
    if kind == "cylinder":
        return evtgen.generate_eventlist_cylinder(
            None, 4000, 1e17, 1e19, VOLUME, cross_sections_model="hedis_bgr18", seed=5)
    return evtgen.generate_unforced(
        None, 3000, 1e17, 1e19, VOLUME, cross_sections_model="hedis_bgr18", seed=5)


@pytest.mark.parametrize("kind", ["cylinder", "unforced"])
def test_generators_are_bit_equal(table, kind):
    data, attrs = _generate(tevt, kind)
    jdata, jattrs = _generate(jevt, kind)
    assert sorted(data) == sorted(jdata)
    assert len(data["event_group_ids"]) > 0
    for key in data:
        np.testing.assert_array_equal(data[key], jdata[key], err_msg=key)
    assert sorted(attrs) == sorted(jattrs)
    for key in attrs:
        np.testing.assert_array_equal(attrs[key], jattrs[key], err_msg=key)
    # not the CTW list: the table's cc fractions and inelasticities drew it
    ctw, _ = tevt.generate_eventlist_cylinder(None, 4000, 1e17, 1e19, VOLUME, seed=5)
    if kind == "cylinder":
        assert not np.array_equal(data["inelasticity"], ctw["inelasticity"])


@pytest.mark.parametrize("mode", MODES)
def test_weights(table, mode):
    rng = np.random.default_rng(12)
    n = 300
    args = (rng.uniform(0, np.pi, n), 10 ** rng.uniform(15.5, 19.5, n), rng.choice(FLAVORS, n))
    kw = dict(mode=mode, cross_section_type="hedis_bgr18",
              vertex_position=np.stack([rng.uniform(-1e3, 1e3, n), rng.uniform(-1e3, 1e3, n),
                                        rng.uniform(-2.5e3, 0, n)], -1),
              phi_nu=rng.uniform(0, 2 * np.pi, n))
    if mode == "simple":
        # get_simple_weight asks the cross section of flavor 0
        with pytest.raises(IndexError):
            jea.get_weight(*args, **kw)
        with pytest.raises(IndexError):
            tea.get_weight(*args, **kw)
        return
    got = tea.get_weight(*args, **kw)
    np.testing.assert_allclose(got, jea.get_weight(*args, **kw), rtol=1e-12)
    assert np.all((got >= 0) & (got <= 1))
    if mode != "None":
        ctw = tea.get_weight(*args, **{**kw, "cross_section_type": "ctw"})
        assert not np.allclose(got, ctw, rtol=1e-3)


BGR18_WEIGHTS = {"weights": {"weight_mode": "core_mantle_crust_simple",
                             "cross_section_type": "hedis_bgr18"}}


@pytest.fixture(scope="module")
def campaign(table, tmp_path_factory):
    """400 events at 1e18 eV drawn with the table, through both packages'
    Simulation in float64 with BGR18 weights."""
    data, attrs = tevt.generate_eventlist_cylinder(
        None, 400, 1e18, 1e18, VOLUME, cross_sections_model="hedis_bgr18", seed=14)
    inp = io_input.from_generated(data, attrs)
    res = convert.fullscale_simulation(inp, BGR18_WEIGHTS, device="cpu", dtype=torch.float64,
                                       chunk_size=512).run()
    path = str(tmp_path_factory.mktemp("bgr18_sim") / "in.hdf5")
    write_input_hdf5(inp, path)
    jres = Simulation(
        path, convert.DIPOLE_DETECTOR,
        config={"sampling_rate": 2.0, "propagation": {"ice_model": "southpole_2015"},
                "signal": {"model": "Alvarez2000"}, **BGR18_WEIGHTS},
        filter_chain=[FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
                      FilterStage((0, 500 * units.MHz), "butter", {"order": 10})],
        trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
        antenna_replacements={"XFDTD_Vpol_CrossFeed_150mmHole_n1.78": "analytic_VPol"},
        chunk_size=512, dtype=jnp.float64).run()
    return res, jres


def test_simulation_triggered_set(campaign):
    res, jres = campaign
    mine = set(res["group_ids"][res["triggered"] & (res["weights"] >= MIN_W)].tolist())
    ref = set(np.asarray(jres["group_ids"])[np.asarray(jres["triggered"])
                                          & (np.asarray(jres["weights"]) >= MIN_W)].tolist())
    assert len(ref) >= 10
    assert mine == ref, sorted(mine ^ ref)


def test_simulation_weights_and_veff(campaign):
    res, jres = campaign
    np.testing.assert_array_equal(res["group_ids"], np.asarray(jres["group_ids"]))
    np.testing.assert_allclose(res["weights"], np.asarray(jres["weights"]), rtol=1e-12)
    assert np.all((res["weights"] >= 0) & (res["weights"] <= 1))
    assert res["veff"] > 0
    np.testing.assert_allclose(res["veff"], float(jres["veff"]), rtol=1e-9)
