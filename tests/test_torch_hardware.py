"""The port's RNO-G hardware-response and detector modules held to the JAX
package's, on the CPU in float64:

* ``detector/hardware_response.py``: the ARIANNA amp 100/200/300 responses
  against tests/golden/hardware_responses.npz at rtol 1e-9, as the JAX
  package's test holds them; the response chain and its delay; the two
  incorporator modules (ARIANNA and RNO-G: amp types from the detector,
  cable loss, an RNOGDetector signal chain, phase-only, relative and
  minimum-gain modes, both directions) on the same spectra, within 1e-12 of
  each channel's peak (the multiply runs on the module's device);
* ``detector/rnog_detector.py``: tests/test_rnog_detector.py's export
  through both packages: every accessor equal, the composed signal chain at
  rtol 1e-12, the time validity and the ``.json.xz`` read;
* ``detector/detector_sql.py``: the SQL round trip of tests/test_e2e.py's
  detector, the buffered dict equal to the JAX package's, the port's
  ``Detector`` from the sqlite file equal to the one from the dict, the
  per-field accessors and commissioning; tests/test_detector_sql.py's run
  through the port's ``Simulation`` (200 events, seed 7) with the same
  triggered set from the file as from the dict, and as the JAX package's;
* ``reco/rnog.crRNOGTemplateCreator``: tests/test_rnog.py's two templates,
  each within 1e-10 of its peak, in the same pickle layout.
(The copies of the numpy functions and tables are held to their originals in
tests/test_torch_isolation.py.)
"""

import copy
import datetime
import json
import lzma
import pickle

import numpy as np
import pytest
import torch

from nuradiomc_tpu.detector import detector_sql as jsql
from nuradiomc_tpu.detector import hardware_response as jhr
from nuradiomc_tpu.detector import rnog_detector as jrd
from nuradiomc_tpu.detector.detector import Detector as JDetector
from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.reco import rnog as jrnog
from nuradiomc_tpu_torch.detector import detector_sql as tsql
from nuradiomc_tpu_torch.detector import hardware_response as thr
from nuradiomc_tpu_torch.detector import rnog_detector as trd
from nuradiomc_tpu_torch.detector.detector import Detector as TDetector
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.reco import rnog as trnog
from test_e2e import DETECTOR
from test_rnog_detector import make_export


def test_amp_responses_against_the_golden():
    import os
    with np.load(os.path.join(os.path.dirname(__file__), "golden",
                              "hardware_responses.npz")) as g:
        ff = g["ff"]
        for amp in ("100", "200", "300"):
            np.testing.assert_allclose(thr.get_amplifier_response(ff, amp), g[f"amp_{amp}"],
                                       rtol=1e-9)
        np.testing.assert_allclose(thr.get_cable_response_parametrized(ff, "LMR_400", 50.0),
                                   g["cable_lmr400_50m"], rtol=1e-9)


def test_response_chain_and_delay():
    ff = np.linspace(0.05, 1.0, 500)
    pair = []
    for mod in (thr, jhr):
        chain = (mod.Response(ff, np.exp(-2j * np.pi * ff * 7.5), name="cable")
                 * mod.Response(ff, 2.0 * np.ones_like(ff), name="amp"))
        pair.append((chain(ff[10:-10]), chain.calculate_time_delay((0.1, 0.5)),
                     chain.get_names()))
    np.testing.assert_array_equal(pair[0][0], pair[1][0])
    assert pair[0][1:] == pair[1][1:]


def _rnog_detector_dict():
    chans = {}
    for cid, (amp, cab) in enumerate([("rno_surface", None), ("iglu", None),
                                      ("phased_array", None), ("deep_impulse", "LMR_400")]):
        ch = copy.deepcopy(list(DETECTOR["channels"].values())[0])
        ch.update(channel_id=cid, amp_type=amp, ant_position_z=-100.0 - cid)
        if cab:
            ch.update(cab_type=cab, cab_length=30.0)
        chans[str(cid)] = ch
    return {"channels": chans, "stations": copy.deepcopy(DETECTOR["stations"])}


def _station(ev, sid, n=1024, fs=3.2, seed=4):
    rng = np.random.default_rng(seed)
    st = ev.Station(sid)
    for cid in range(4):
        ch = ev.Channel(cid)
        ch.set_trace(rng.normal(size=n) * 1e-5, fs)
        st.add_channel(ch)
    return st


def _spectra(st):
    return [np.asarray(st.get_channel(c).get_frequency_spectrum()) for c in range(4)]


def _close(a_list, b_list, tol=1e-12):
    for a, b in zip(a_list, b_list):
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) <= tol * np.max(np.abs(b)), np.max(np.abs(a - b))


@pytest.mark.parametrize("sim_to_data", [True, False])
def test_ariana_incorporator_matches_the_jax_package(sim_to_data):
    det_dict = _rnog_detector_dict()
    for cid, amp in enumerate(("100", "200", "300", "100")):
        det_dict["channels"][str(cid)]["amp_type"] = amp
    sid = DETECTOR["stations"]["1"]["station_id"]
    out = []
    for ev, mod, det, kw in ((jev, jhr, JDetector(det_dict), {}),
                             (tev, thr, TDetector(det_dict), {"device": "cpu"})):
        st = _station(ev, sid)
        inc = mod.hardwareResponseIncorporator(**kw)
        inc.begin()
        inc.run(None, st, det, sim_to_data=sim_to_data)
        out.append(_spectra(st))
    _close(out[1], out[0])


RNOG_MODES = [dict(sim_to_data=True), dict(sim_to_data=False, mingainlin=0.01),
              dict(sim_to_data=True, phase_only=True), dict(sim_to_data=True, mode="relative"),
              dict(sim_to_data=True, temp=250.0)]


@pytest.mark.parametrize("kw", RNOG_MODES, ids=lambda k: "-".join(map(str, k.items())))
def test_rnog_incorporator_matches_the_jax_package(kw):
    det_dict = _rnog_detector_dict()
    sid = DETECTOR["stations"]["1"]["station_id"]
    out = []
    for ev, mod, det, dkw in ((jev, jhr, JDetector(det_dict), {}),
                              (tev, thr, TDetector(det_dict), {"device": "cpu"})):
        st = _station(ev, sid, seed=9)
        inc = mod.rnogHardwareResponseIncorporator(**dkw)
        inc.begin()
        inc.run(None, st, det, **kw)
        out.append(_spectra(st))
    _close(out[1], out[0])


def _export_file(tmp_path, xz=False):
    path = str(tmp_path / ("rnog.json.xz" if xz else "rnog.json"))
    with (lzma.open(path, "wt") if xz else open(path, "w")) as f:
        json.dump(make_export(), f)
    return path


def test_rnog_detector_matches_the_jax_package(tmp_path):
    path = _export_file(tmp_path)
    when = datetime.datetime(2023, 6, 1)
    dets = []
    for mod in (jrd, trd):
        d = mod.RNOGDetector(path)
        d.update(when)
        dets.append(d)
    j, t = dets
    assert t.get_station_ids() == j.get_station_ids() == [11]
    for name in ("get_absolute_position", "get_number_of_samples", "get_number_of_channels",
                 "get_channel_ids", "get_devices", "get_site", "get_sampling_frequency"):
        np.testing.assert_array_equal(getattr(t, name)(11), getattr(j, name)(11), err_msg=name)
    assert t.get_sampling_frequency(11, trigger=True) == j.get_sampling_frequency(11, trigger=True)
    for cid in (0, 1):
        assert t.get_channel(11, cid) == j.get_channel(11, cid)
        for name in ("get_relative_position", "get_channel_orientation", "get_antenna_model",
                     "get_antenna_type", "get_noise_temperature", "is_channel_noiseless",
                     "get_signal_chain_components", "get_time_delay", "get_cable_delay"):
            np.testing.assert_array_equal(getattr(t, name)(11, cid), getattr(j, name)(11, cid),
                                          err_msg=name)
        ff = np.linspace(0.05, 1.0, 200)
        rt, rj = t.get_signal_chain_response(11, cid), j.get_signal_chain_response(11, cid)
        np.testing.assert_allclose(rt(ff), rj(ff), rtol=1e-12)
        assert rt.get_names() == rj.get_names() and rt.time_delay == rj.time_delay
    np.testing.assert_array_equal(t.get_relative_position_device(11, 5),
                                  j.get_relative_position_device(11, 5))
    assert json.loads(t.export_as_string()) == json.loads(j.export_as_string())
    # the RNO-G incorporator's filter from the detector's own signal chain
    ff = np.fft.rfftfreq(2048, 1 / 3.2)
    for cid in (0, 1):
        for kw in ({"sim_to_data": True}, {"sim_to_data": False, "mingainlin": 0.01}):
            got = thr.rnogHardwareResponseIncorporator(device="cpu").get_filter(
                ff, 11, cid, t, **kw)
            want = jhr.rnogHardwareResponseIncorporator().get_filter(ff, 11, cid, j, **kw)
            _close([np.asarray(got)], [np.asarray(want)])


def test_rnog_detector_time_validity_and_xz(tmp_path):
    path = _export_file(tmp_path, xz=True)
    det = trd.RNOGDetector(path, selected_stations=[11])
    det.update(datetime.datetime(2022, 1, 1))
    assert det.get_station_ids() == [11]
    with pytest.raises(ValueError):
        det.update(datetime.datetime(2027, 1, 1))
    with pytest.raises(NotImplementedError):
        trd.RNOGDetector()


def test_sql_round_trip_matches_the_jax_package(tmp_path):
    buffers = []
    for mod, name in ((jsql, "j.sqlite"), (tsql, "t.sqlite")):
        db = mod.export_detector_to_sql(DETECTOR, str(tmp_path / name))
        buffers.append(db.buffer())
        db.close()
    assert buffers[0] == buffers[1]
    path = str(tmp_path / "t.sqlite")
    det_sql = TDetector(path, default_station=101)
    det_json = TDetector(DETECTOR, default_station=101)
    assert det_sql.get_station_ids() == det_json.get_station_ids()
    sid = det_json.get_station_ids()[0]
    assert det_sql.get_channel_ids(sid) == det_json.get_channel_ids(sid)
    for cid in det_json.get_channel_ids(sid):
        np.testing.assert_allclose(det_sql.get_relative_position(sid, cid),
                                   det_json.get_relative_position(sid, cid))
        np.testing.assert_allclose(det_sql.get_antenna_orientation(sid, cid),
                                   det_json.get_antenna_orientation(sid, cid))
        for name in ("get_cable_delay", "get_number_of_samples", "get_sampling_frequency",
                     "get_antenna_model"):
            assert getattr(det_sql, name)(sid, cid) == getattr(det_json, name)(sid, cid), name


def test_sql_accessors_and_commissioning(tmp_path):
    """tests/test_detector_sql.py's accessor test on the port's backend."""
    dd = copy.deepcopy(DETECTOR)
    ch2 = copy.deepcopy(list(dd["channels"].values())[0])
    ch2["channel_id"] = 1
    ch2["ant_position_z"] = -110.0
    dd["channels"]["2"] = ch2
    chans = list(dd["channels"].values())
    sid = chans[0]["station_id"]
    chans[0]["decommission_time"] = "2018-01-01 00:00:00"
    sql = tsql.export_detector_to_sql(dd, str(tmp_path / "det.sqlite"))
    sql.update(datetime.datetime(2017, 6, 1))
    n_before = sql.get_number_of_channels(sid)
    assert len(sql.get_everything(sid)) == n_before
    assert sql.get_relative_position(sid, chans[0]["channel_id"]) == [
        chans[0]["ant_position_x"], chans[0]["ant_position_y"], chans[0]["ant_position_z"]]
    assert sql.get_amplifier_type(sid, chans[1]["channel_id"]) == chans[1]["amp_type"]
    sql.update(datetime.datetime(2020, 6, 1))
    assert sql.get_number_of_channels(sid) == n_before - 1
    with pytest.raises(KeyError):
        sql.get_relative_position(sid, chans[0]["channel_id"])
    st = sql.get_everything_stations()
    assert len(st) >= 1 and "easting" in st[0]
    assert isinstance(sql.to_detector(), TDetector)
    sql.close()


def test_sql_detector_through_the_port_simulation(tmp_path):
    """tests/test_detector_sql.py's run: 200 events (seed 7) through the
    port's Simulation from the sqlite file and from the dict give the same
    triggered set, the JAX package's from the dict."""
    import jax.numpy as jnp
    from nuradiomc_tpu.sim import evtgen as jevtgen
    from nuradiomc_tpu.sim.simulation import FilterStage as JStage
    from nuradiomc_tpu.sim.simulation import Simulation as JSimulation
    from nuradiomc_tpu.sim.simulation import TriggerSpec as JTrigger
    from nuradiomc_tpu_torch.sim import evtgen, io_input
    from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
    from nuradiomc_tpu_torch.utils import units

    volume = {"fiducial_rmin": 0, "fiducial_rmax": 3 * units.km,
              "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0}
    data, attrs = evtgen.generate_eventlist_cylinder(None, 200, 1e18, 1e18, volume, seed=7)
    path = str(tmp_path / "det.sqlite")
    tsql.export_detector_to_sql(DETECTOR, path).close()
    config = {"sampling_rate": 2.0, "propagation": {"ice_model": "southpole_2015"},
              "signal": {"model": "Alvarez2000"}}
    replace = {"XFDTD_Vpol_CrossFeed_150mmHole_n1.78": "analytic_VPol"}
    chain = [((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
             ((0, 500 * units.MHz), "butter", {"order": 10})]
    res = [Simulation(io_input.from_generated(data, attrs), det, config=config,
                      filter_chain=[FilterStage(*c) for c in chain],
                      trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
                      antenna_replacements=replace, chunk_size=256, device="cpu",
                      dtype=torch.float64).run()["triggered"]
           for det in (path, DETECTOR)]
    np.testing.assert_array_equal(res[0], res[1])
    infile = str(tmp_path / "in.hdf5")
    jevtgen.generate_eventlist_cylinder(infile, 200, 1e18, 1e18, volume, seed=7)
    ref = JSimulation(infile, DETECTOR, config=config,
                      filter_chain=[JStage(*c) for c in chain],
                      trigger=JTrigger(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
                      antenna_replacements=replace, chunk_size=256,
                      dtype=jnp.float64).run()["triggered"]
    np.testing.assert_array_equal(np.asarray(res[0]), np.asarray(ref))
    assert np.asarray(ref).any()


CR_DETECTOR = {"channels": {"1": {
    "adc_n_samples": 2048, "adc_sampling_frequency": 3.2,
    "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
    "ant_position_x": 0.0, "ant_position_y": 0.0, "ant_position_z": -2.0,
    "ant_rotation_phi": 160.0, "ant_rotation_theta": 90.0,
    "ant_type": "analytic_LPDA", "amp_type": "rno_surface",
    "cab_time_delay": 0.0, "adc_nbits": None,
    "channel_id": 0, "station_id": 101}},
    "stations": {"1": {"station_id": 101, "pos_altitude": 0,
                       "pos_easting": 0, "pos_northing": 0}}}


def _templates(mod, tmp, **kw):
    creator = mod.crRNOGTemplateCreator(**kw)
    creator.begin(CR_DETECTOR, str(tmp))
    creator.set_template_parameter(
        template_run_id=(0, 0), template_event_id=(0, 1), template_station_id=(101, 101),
        template_channel_id=(0, 0), efield_width=(5, 2), antenna_rotation=(160, 160),
        cr_zenith=(55, 55), cr_azimuth=(0, 0))
    events = creator.run(return_templates=True, bandpass_filter={
        "passband": [0.08, 0.18], "filter_type": "butter", "order": 4})
    with open(tmp / "templates_cr_station_101.pickle", "rb") as f:
        return pickle.load(f), events


def test_cr_template_creator_matches_the_jax_package(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want, jevents = _templates(jrnog, tmp_path / "j")
    got, tevents = _templates(trnog, tmp_path / "t", device="cpu")
    assert len(tevents) == len(jevents) == 2
    zen, az = np.deg2rad(55), np.deg2rad(0)
    assert list(got[0]) == list(want[0]) == [zen]
    assert list(got[0][zen]) == list(want[0][zen]) == [az]
    leaf_t, leaf_j = got[0][zen][az], want[0][zen][az]
    assert set(leaf_t) == set(leaf_j) == {5, 2}
    for width in (5, 2):
        a, b = np.asarray(leaf_t[width]), np.asarray(leaf_j[width])
        assert a.shape == b.shape and np.max(np.abs(b)) > 0
        assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b))
