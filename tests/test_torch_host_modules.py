"""The port's host-only copies held to their JAX-package originals on the
same inputs: detector/ska.py (with data/detectors/ska_channels.json),
sim/io_ascii.py, sim/nuradio_proposal.py, sim/proposal_table_manager.py,
sim/eventbrowser.py, detector/browser.py, utils/plotting.py,
utils/dataservers.py (``file://`` servers only), utils/templates.py,
utils/framework_utilities.py, utils/particle_names.py and utils/logging.py.
Outputs are compared exactly: files byte for byte (the plots' PNGs too),
arrays and objects by value.
"""

import io
import json
import logging
import os
import pickle
import tarfile

import numpy as np
import pytest

from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.framework import parameters as jpar
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.framework import parameters as tpar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ska_detector():
    from nuradiomc_tpu.detector import ska as jska
    from nuradiomc_tpu_torch.detector import ska as tska
    with open(jska._CHANNEL_FILE, "rb") as a, open(tska._CHANNEL_FILE, "rb") as b:
        assert a.read() == b.read()
    assert tska._CHANNEL_FILE.startswith(os.path.join(ROOT, "nuradiomc_tpu_torch") + os.sep)
    dets = tska.SKADetector(), jska.SKADetector()
    for det in dets:
        det.add_station_position(0, [0.0, 0.0, 460.0])
        for aid, (x, y) in enumerate([(0, 0), (1.5, 0), (0, 1.5)]):
            det.add_antenna_position(0, aid, [x, y, 0.0])
    a, b = dets
    assert a.get_station_ids() == b.get_station_ids()
    cids = b.get_channel_ids(0)
    assert a.get_channel_ids(0) == cids == [0, 1, 10, 11, 20, 21]
    for cid in cids:
        for fn in ("get_channel_group_id", "get_antenna_model", "get_cable_delay",
                   "get_number_of_samples", "get_sampling_frequency", "get_channel"):
            assert repr(getattr(a, fn)(0, cid)) == repr(getattr(b, fn)(0, cid)), fn
        np.testing.assert_array_equal(a.get_relative_position(0, cid),
                                      b.get_relative_position(0, cid))
        np.testing.assert_array_equal(a.get_antenna_orientation(0, cid),
                                      b.get_antenna_orientation(0, cid))
    np.testing.assert_array_equal(a.get_absolute_position(0), b.get_absolute_position(0))
    assert (a.get_site(0), a.get_site_coordinates(0)) == (b.get_site(0), b.get_site_coordinates(0))


def test_ska_layout_reader(tmp_path):
    from nuradiomc_tpu.detector import ska as jska
    from nuradiomc_tpu_torch.detector import ska as tska
    np.savetxt(tmp_path / "layout.txt", [[10.0, 5.0], [900.0, 0.0]])
    for name, pos in (("s0", [[0.0, 0.0], [3.0, 1.0]]), ("s1", [[1.0, 1.0]])):
        (tmp_path / name).mkdir()
        np.savetxt(tmp_path / name / "layout.txt", pos)
    a, b = tska.SKADetector(), jska.SKADetector()
    a.read_antenna_positions(str(tmp_path))
    b.read_antenna_positions(str(tmp_path))
    assert a.get_station_ids() == b.get_station_ids() == [0]
    assert a.get_channel_ids(0) == b.get_channel_ids(0)
    for cid in b.get_channel_ids(0):
        np.testing.assert_array_equal(a.get_relative_position(0, cid),
                                      b.get_relative_position(0, cid))


def test_io_ascii(tmp_path):
    h5py = pytest.importorskip("h5py")
    from nuradiomc_tpu.sim import evtgen as jevtgen, io_ascii as jascii
    from nuradiomc_tpu_torch.sim import io_ascii as tascii
    inp = str(tmp_path / "in.hdf5")
    vol = {"fiducial_rmin": 0, "fiducial_rmax": 2000.0, "fiducial_zmin": -2000.0,
           "fiducial_zmax": 0}
    jevtgen.generate_eventlist_cylinder(inp, 40, 1e18, 1e19, vol, seed=3)
    for pkg, tag in ((tascii, "t"), (jascii, "j")):
        pkg.hdf5_to_ascii(inp, str(tmp_path / f"{tag}.txt"))
        pkg.ascii_to_hdf5(str(tmp_path / f"{tag}.txt"), str(tmp_path / f"{tag}.hdf5"),
                          volume_attrs={"n_events": 40})
        pkg.hdf5_to_arasim(str(tmp_path / f"{tag}.hdf5"), str(tmp_path / f"{tag}_ara.txt"),
                           200.0)
        pkg.ara_eventlist_to_hdf5(str(tmp_path / f"{tag}_ara.txt"),
                                  str(tmp_path / f"{tag}_ara.hdf5"))
    for name in ("{}.txt", "{}_ara.txt"):
        with open(tmp_path / name.format("t")) as a, open(tmp_path / name.format("j")) as b:
            assert a.read() == b.read()
    a, b = (tascii.read_ascii_eventlist(str(tmp_path / "t.txt")),
            jascii.read_ascii_eventlist(str(tmp_path / "j.txt")))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    for name in ("{}.hdf5", "{}_ara.hdf5"):
        with h5py.File(tmp_path / name.format("t")) as fa, \
                h5py.File(tmp_path / name.format("j")) as fb:
            assert sorted(fa.keys()) == sorted(fb.keys())
            assert dict(fa.attrs) == dict(fb.attrs)
            for k in fb.keys():
                np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]))
    assert (tascii.ASCII_HEADER, tascii.ARA_VERSION) == (jascii.ASCII_HEADER, jascii.ARA_VERSION)


def test_io_ascii_imports_h5py_only_inside_its_hdf5_functions():
    import inspect

    from nuradiomc_tpu_torch.sim import io_ascii
    src = inspect.getsource(io_ascii)
    assert "\nimport h5py" not in src and src.count("    import h5py") == 4


def test_nuradio_proposal():
    from nuradiomc_tpu.sim import nuradio_proposal as jnp_
    from nuradiomc_tpu_torch.sim import nuradio_proposal as tnp_
    E = 10 ** np.linspace(17, 19.5, 6)
    codes = [13, -13, 15, -15, 15, 13]
    a, b = tnp_.ProposalFunctions(seed=5), jnp_.ProposalFunctions(seed=5)
    sa = a.get_secondaries_array(E, codes, propagation_length_nu=4000.0)
    sb = b.get_secondaries_array(E, codes, propagation_length_nu=4000.0)
    assert [[str(s) for s in x] for x in sa] == [[str(s) for s in x] for x in sb]
    assert sum(len(x) for x in sb) > 0
    assert a.get_decays(E, codes) == b.get_decays(E, codes)


def test_proposal_table_manager():
    from nuradiomc_tpu.sim import proposal_table_manager as jptm
    from nuradiomc_tpu_torch.sim import proposal_table_manager as tptm
    assert tptm.get_compiler() == jptm.get_compiler()
    assert tptm.produce_proposal_tables("SouthPole") == jptm.produce_proposal_tables("SouthPole")
    assert tptm.produce_proposal_tables_tarball("SouthPole") is None
    with pytest.raises(ImportError):
        tptm.download_proposal_tables("SouthPole")
    tptm.main(["create", "all"])


def _nur_file(tmp_path):
    """tests/test_fluxes_browser.py's event with a sim station and a shower,
    written by the JAX package's writer."""
    from nuradiomc_tpu.sim import io_nur
    evt = jev.Event(0, 7)
    st = jev.Station(11)
    for cid in (0, 1):
        ch = jev.Channel(cid)
        ch.set_trace(np.sin(np.linspace(0, 20 + cid, 256)), 2.0)
        st.add_channel(ch)
    trig = jev.Trigger("hl", [0, 1], "high_low")
    trig.set_triggered(True)
    trig.set_trigger_time(17.5)
    st.set_trigger(trig)
    sim = jev.SimStation(11)
    ef = jev.ElectricField([0])
    ef.set_trace(np.outer([0.0, 1.0, 0.5], np.sin(np.linspace(0, 9, 128))), 2.0)
    sim.add_electric_field(ef)
    st.set_sim_station(sim)
    evt.set_station(st)
    sh = jev.Shower(3)
    shp = jpar.showerParameters
    sh[shp.energy] = 2e18
    sh[shp.zenith] = 0.9
    sh[shp.azimuth] = 1.2
    sh[shp.type] = "had"
    sh[shp.vertex] = np.array([100.0, -50.0, -700.0])
    evt.add_sim_shower(sh)
    path = str(tmp_path / "e.nur")
    w = io_nur.EventWriter(path)
    w.run(evt)
    w.end()
    return path


def test_eventbrowser(tmp_path):
    from nuradiomc_tpu.sim import eventbrowser as jeb
    from nuradiomc_tpu_torch.sim import eventbrowser as teb
    path = _nur_file(tmp_path)
    for pkg, tag in ((teb, "t"), (jeb, "j")):
        (tmp_path / f"png_{tag}").mkdir()
        pkg.main([path, "--html", str(tmp_path / f"html_{tag}")])
        pkg.main([path, "--out", str(tmp_path / f"png_{tag}")])
    with open(tmp_path / "html_t" / "index.html") as a, \
            open(tmp_path / "html_j" / "index.html") as b:
        assert a.read() == b.read()
    with open(tmp_path / "png_t" / "event_7_station_11.png", "rb") as a, \
            open(tmp_path / "png_j" / "event_7_station_11.png", "rb") as b:
        assert a.read() == b.read()


def test_detector_browser(tmp_path):
    from nuradiomc_tpu.detector import browser as jbr
    from nuradiomc_tpu_torch.detector import browser as tbr
    chans = {str(c + 1): {
        "adc_n_samples": 256, "adc_sampling_frequency": 1.0,
        "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
        "ant_position_x": float(c), "ant_position_y": 0.0,
        "ant_position_z": -50.0 - 10 * c, "ant_rotation_phi": 90.0,
        "ant_rotation_theta": 90.0, "ant_type": "analytic_VPol",
        "amp_type": "", "cab_time_delay": 0.0, "adc_nbits": None,
        "channel_id": c, "station_id": 3} for c in range(4)}
    det_file = str(tmp_path / "det.json")
    with open(det_file, "w") as f:
        json.dump({"channels": chans, "stations": {"1": {
            "station_id": 3, "pos_altitude": 0, "pos_easting": 0, "pos_northing": 0}}}, f)
    for pkg, tag in ((tbr, "t"), (jbr, "j")):
        pkg.main([det_file, "--out", str(tmp_path / tag)])
    with open(tmp_path / "t" / "station_3.png", "rb") as a, \
            open(tmp_path / "j" / "station_3.png", "rb") as b:
        assert a.read() == b.read()


def test_plotting():
    from nuradiomc_tpu.utils import plotting as jplot
    from nuradiomc_tpu_torch.utils import plotting as tplot
    rng = np.random.default_rng(0)
    xx, yy, zz = rng.uniform(-1e3, 1e3, 200), rng.uniform(-1e3, 1e3, 200), \
        rng.uniform(-2e3, 0, 200)
    w = rng.uniform(0, 1, 200)
    out = []
    for pkg in (tplot, jplot):
        fig, ax = pkg.plot_vertex_distribution(xx, yy, zz, weights=w, trigger_name="pa")
        buf = io.BytesIO()
        fig.savefig(buf, format="png")
        out.append((buf.getvalue(), ax.get_title(), ax.get_xlim(), ax.get_ylim()))
    assert out[0] == out[1]


def test_dataservers(tmp_path):
    from nuradiomc_tpu.utils import dataservers as jds
    from nuradiomc_tpu_torch.utils import dataservers as tds
    server = tmp_path / "server"
    (server / "AntennaModels").mkdir(parents=True)
    payload = b"antenna pickle bytes" * 100
    (server / "AntennaModels" / "m.pkl").write_bytes(payload)
    inner = tmp_path / "payload.dat"
    inner.write_bytes(b"x" * 64)
    with tarfile.open(server / "lib.tar.gz", "w:gz") as t:
        t.add(inner, arcname="payload.dat")
    dead = f"file://{tmp_path / 'dead'}"
    for pkg, tag in ((tds, "t"), (jds, "j")):
        got = pkg.download_from_dataserver("AntennaModels/m.pkl", str(tmp_path / tag / "m.pkl"),
                                           dataservers=[dead, f"file://{server}"])
        assert open(got, "rb").read() == payload
        pkg.download_from_dataserver("lib.tar.gz", str(tmp_path / tag / "lib.tar.gz"),
                                     dataservers=[f"file://{server}"])
        assert (tmp_path / tag / "payload.dat").read_bytes() == b"x" * 64
        with pytest.raises(IOError):
            pkg.download_from_dataserver("m.pkl", str(tmp_path / tag / "x.pkl"),
                                         dataservers=[f"file://{server}"],
                                         expected_sha1="0" * 40)
    assert tds.sha1_of(str(tmp_path / "t" / "m.pkl")) == jds.sha1_of(str(tmp_path / "j" / "m.pkl"))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


def test_templates(tmp_path):
    from nuradiomc_tpu.utils.templates import Templates as JT
    from nuradiomc_tpu_torch.utils.templates import Templates as TT
    rng = np.random.default_rng(0)
    zen_c, az_c = np.deg2rad([60, 50, 70]), np.deg2rad([0, 22.5, 45])
    cr = [{z: {a: {ch: rng.normal(size=32) for ch in range(6)} for a in az_c} for z in zen_c}
          for _ in range(2)]
    zen_n, az_n = np.deg2rad([100, 120, 140]), np.deg2rad([0, 22.5, 45])
    dchs = [0.0] + list(np.deg2rad([-0.5, -1, -1.5, -2, -3, -4, -5]))
    nu = {z: {a: {d: {ch: rng.normal(size=32) for ch in range(6)} for d in dchs} for a in az_n}
          for z in zen_n}
    with open(tmp_path / "templates_cr_station_51.pickle", "wb") as f:
        pickle.dump(cr, f)
    with open(tmp_path / "templates_nu_station_51.pickle", "wb") as f:
        pickle.dump(nu, f)
    a, b = TT(str(tmp_path)), JT(str(tmp_path))
    for name, args in (("get_cr_ref_templates", (51,)), ("get_cr_ref_template", (51,)),
                       ("get_set_of_cr_templates_full", (51, 5)),
                       ("get_set_of_cr_templates", (51, 4)), ("get_nu_ref_templates", (51,)),
                       ("get_nu_ref_template", (51,)), ("get_set_of_nu_templates", (51, 10))):
        assert repr(getattr(a, name)(*args)) == repr(getattr(b, name)(*args)), name
    with pytest.raises(IOError):
        a.get_cr_ref_templates(99)


def test_framework_utilities():
    from nuradiomc_tpu.utils import framework_utilities as jfu
    from nuradiomc_tpu_torch.utils import framework_utilities as tfu

    def event(ev, par):
        chp = par.channelParameters
        station = ev.Station(7)
        for cid, (snr, xc) in enumerate([(3.0, 0.5), (5.0, 0.7), (4.5, 0.1)]):
            ch = ev.Channel(cid)
            ch.set_trace(np.zeros(16), 1.0)
            ch[chp.SNR] = snr
            ch[chp.cr_xcorrelations] = {"cr_max_xcorr": xc}
            station.add_channel(ch)
        evt = ev.Event(0, 0)
        evt.set_station(station)
        return evt, station

    (te, ts), (je, js) = event(tev, tpar), event(jev, jpar)
    tchp, jchp = tpar.channelParameters, jpar.channelParameters
    assert tfu.get_averaged_channel_parameter(te, tchp.SNR) == \
        jfu.get_averaged_channel_parameter(je, jchp.SNR)
    assert tfu.get_averaged_channel_parameter(ts, tchp.cr_xcorrelations) == \
        jfu.get_averaged_channel_parameter(js, jchp.cr_xcorrelations)
    with pytest.raises(KeyError):
        tfu.get_averaged_channel_parameter(ts, tchp.signal_time)


def test_particle_names():
    from nuradiomc_tpu.utils import particle_names as jpn
    from nuradiomc_tpu_torch.utils import particle_names as tpn
    assert tpn.particle_names == jpn.particle_names
    assert (tpn.primary_names, tpn.em_primary_names) == (jpn.primary_names, jpn.em_primary_names)
    for pid, name in jpn.particle_names.items():
        assert tpn.particle_name(pid) == jpn.particle_name(pid)
        assert tpn.particle_id(name) == jpn.particle_id(name)
    for bad, err in ((999, ValueError), ("12", TypeError)):
        with pytest.raises(err):
            tpn.particle_name(bad)


def test_logging(caplog):
    from nuradiomc_tpu.utils import logging as jlog
    from nuradiomc_tpu_torch.utils import logging as tlog
    assert tlog.LOGGING_STATUS == jlog.LOGGING_STATUS == 25
    logger = tlog.setup_logger("nrt_port_status", level=tlog.LOGGING_STATUS)
    assert isinstance(logger, tlog.NuRadioLogger) and logger.level == jlog.LOGGING_STATUS
    assert logging.getLevelName(tlog.LOGGING_STATUS) == "STATUS"
    with caplog.at_level(tlog.LOGGING_STATUS, logger="nrt_port_status"):
        logger.status("production %d%% done", 50)
        logger.info("hidden at STATUS level")
    msgs = [r for r in caplog.records if r.name == "nrt_port_status"]
    assert [(r.levelname, r.message) for r in msgs] == [("STATUS", "production 50% done")]
    assert logging.getLoggerClass() is not tlog.NuRadioLogger
