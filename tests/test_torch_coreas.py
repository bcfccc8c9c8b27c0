"""The port's CoREAS input (sim/io_coreas.py), reader modules
(reco/coreas_readers.py) and per-ray-solution amplitudes
(reco/custom_deltaT.py) against the JAX package's, on the CPU in float64.

The CoREAS file is tests/test_coreas_readers.py's synthetic star, written
with h5py from ``convert.make_coreas_star``'s in-memory mapping, so the port
reads the same content both ways: from the file (``read_CORSIKA7``) and from
the mapping (``coreas_event``). Events of the two packages compare as trees
(``reco.examples.event_tree``), arrays bit for bit where the port keeps the
host arithmetic and to 1e-12 of peak where it runs on tensors; the core
draws and the interpolation weights are equal.
"""

import h5py
import numpy as np
import pytest

from nuradiomc_tpu.detector.detector import Detector as JDetector
from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.reco import coreas_readers as jcr
from nuradiomc_tpu.reco import custom_deltaT as jdt
from nuradiomc_tpu.sim import io_coreas as jio
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.detector.detector import Detector as TDetector
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.reco import coreas_readers as tcr
from nuradiomc_tpu_torch.reco import custom_deltaT as tdt
from nuradiomc_tpu_torch.reco import examples
from nuradiomc_tpu_torch.sim import io_coreas as tio
from nuradiomc_tpu_torch.utils import units


def _write(node, group):
    for key, value in node.attrs.items():
        group.attrs[key] = value
    for name, child in node.items():
        if isinstance(child, convert.H5Dataset):
            ds = group.create_dataset(name, data=np.asarray(child))
            for key, value in child.attrs.items():
                ds.attrs[key] = value
        else:
            _write(child, group.create_group(name))


@pytest.fixture(scope="module")
def star():
    return convert.make_coreas_star(radii_cm=np.array([2000.0, 8000.0, 20000.0]), n_t=256)


@pytest.fixture(scope="module")
def corsika_file(star, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("coreas") / "coreas.hdf5")
    with h5py.File(path, "w") as f:
        _write(star, f)
    return path


def _same(a, b):
    examples.assert_same_tree(examples.event_tree(a), examples.event_tree(b))


def _close_trees(a, b, tol=1e-12, path="event"):
    """assert_same_tree, with arrays within ``tol`` of their peak."""
    if isinstance(b, dict):
        assert sorted(map(str, a)) == sorted(map(str, b)), path
        for k in b:
            _close_trees(a[k], b[k], tol, f"{path}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close_trees(x, y, tol, f"{path}[{i}]")
    elif isinstance(b, np.ndarray) and b.dtype.kind in "fc" and b.size:
        assert np.asarray(a).shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.max(np.abs(b)), err_msg=path)
    else:
        examples.assert_same_tree(a, b, path)


def test_file_and_mapping_read_equal_the_original(star, corsika_file):
    want = jio.read_CORSIKA7(corsika_file)
    _same(tio.read_CORSIKA7(corsika_file), want)
    _same(tio.coreas_event(star), want)
    _same(tio.read_coreas(star, declination=0.1), jio.read_CORSIKA7(corsika_file, 0.1))


def test_simulation_weights_and_interpolator_match(corsika_file):
    jevt, tevt = jio.read_CORSIKA7(corsika_file), tio.read_CORSIKA7(corsika_file)
    efs = jevt.get_station(0).get_sim_station().get_electric_fields()
    pos = np.array([ef.get_position() for ef in efs])
    shower = jevt.get_first_sim_shower()
    for site in ("summit", "auger"):
        np.testing.assert_array_equal(
            tio.calculate_simulation_weights(pos, shower[jio.shp.zenith],
                                             shower[jio.shp.azimuth], site=site),
            jio.calculate_simulation_weights(pos, shower[jio.shp.zenith],
                                             shower[jio.shp.azimuth], site=site))
    ji, ti = jio.coreasInterpolator(jevt), tio.coreasInterpolator(tevt)
    queries = [pos[3], pos[3] * 1.05, np.array([30.0, 10.0]), np.array([-120.0, 40.0]),
               np.array([900.0, 0.0])]
    traces, starts = ti.get_interp_efields(queries, device="cpu")
    for q, tr, t0 in zip(queries, traces.numpy(), starts):
        assert ti.get_interp_fluence_value(q) == ji.get_interp_fluence_value(q)
        want, want_t0 = ji.get_interp_efield(q)
        np.testing.assert_array_equal(ti.get_interp_efield(q)[0], want)
        np.testing.assert_allclose(tr, want, rtol=0, atol=1e-15 * np.max(np.abs(want)) + 0)
        assert t0 == want_t0


def test_read_coreas_station_and_shower_match(corsika_file):
    jdet, tdet = (D(convert.coreas_lpda_detector()) for D in (JDetector, TDetector))
    for jr, tr in ((jcr.readCoREASStation(), tcr.readCoREASStation()),):
        jr.begin([corsika_file], station_id=7)
        tr.begin([corsika_file], station_id=7)
        for a, b in zip(tr.run(tdet), jr.run(jdet)):
            _same(a, b)
    jr, tr = jcr.readCoREASShower(), tcr.readCoREASShower()
    jr.begin([corsika_file])
    tr.begin([corsika_file])
    (a,), (b,) = list(tr.run()), list(jr.run())
    _same(a, b)
    jdet = JDetector(convert.coreas_lpda_detector(station_id=0), default_station=0)
    tdet = TDetector(convert.coreas_lpda_detector(station_id=0), default_station=0)
    jr.begin([corsika_file], det=jdet)
    tr.begin([corsika_file], det=tdet)
    (a, da), (b, db) = next(iter(tr.run())), next(iter(jr.run()))
    _same(a, b)
    for sid in (0, 5, 23):
        np.testing.assert_array_equal(da.get_absolute_position(sid), db.get_absolute_position(sid))


def test_random_core_positions_equal_the_original():
    for seed in (3, 11):
        np.testing.assert_array_equal(tcr.get_random_core_positions(-100, 100, -50, 50, 10, seed),
                                      jcr.get_random_core_positions(-100, 100, -50, 50, 10, seed))


@pytest.mark.parametrize("source", ["file", "mapping"])
def test_read_coreas_detector_matches(star, corsika_file, source):
    cores = tcr.get_random_core_positions(-60, 60, -60, 60, 6, seed=3)
    jr = jcr.readCoREASDetector()
    jr.begin(corsika_file)
    want = list(jr.run(JDetector(convert.coreas_lpda_detector()), cores))
    tr = tcr.readCoREASDetector(device="cpu")
    tr.begin(corsika_file if source == "file" else star)
    got = list(tr.run(TDetector(convert.coreas_lpda_detector()), cores))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        _close_trees(examples.event_tree(a), examples.event_tree(b))


def test_read_coreas_detector_in_chunks_matches(star, corsika_file, monkeypatch):
    """Cores in chunks of 4 (the last one short): each chunk's events are
    yielded before the next chunk is made, and they equal the JAX reader's."""
    cores = tcr.get_random_core_positions(-60, 60, -60, 60, 6, seed=3)
    jr = jcr.readCoREASDetector()
    jr.begin(corsika_file)
    want = list(jr.run(JDetector(convert.coreas_lpda_detector()), cores))
    monkeypatch.setattr(tcr, "rows_per_chunk", lambda nbytes, device, n_rows: min(4, n_rows))
    tr = tcr.readCoREASDetector(device="cpu")
    tr.begin(star)
    events = tr.run(TDetector(convert.coreas_lpda_detector()), cores)
    got = [next(events)]
    assert tr.last_chunk == 4
    got += list(events)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        _close_trees(examples.event_tree(a), examples.event_tree(b))


def test_simulation_selector_matches(corsika_file):
    for scale in (1.0, 1e-9):
        out = []
        for io, cr, kw in ((jio, jcr, {}), (tio, tcr, {"device": "cpu"})):
            evt = io.read_CORSIKA7(corsika_file)
            sim = evt.get_station(0).get_sim_station()
            rng = np.random.default_rng(0)
            for ef in sim.get_electric_fields():
                tr = np.asarray(ef.get_trace())
                ef.set_trace(scale * tr + 1e-6 * rng.normal(size=tr.shape),
                             ef.get_sampling_rate())
            sel = cr.simulationSelector(**kw)
            sel.begin()
            out.append(sel.run(evt, sim, None))
        assert out[1] is out[0]


def test_amplitude_per_ray_solution_matches(corsika_file):
    out = []
    for ev, io, dt, D, kw in ((jev, jio, jdt, JDetector, {}),
                              (tev, tio, tdt, TDetector, {"device": "cpu"})):
        det = D(convert.coreas_lpda_detector())
        evt = io.read_CORSIKA7(corsika_file)
        src = evt.get_station(0).get_sim_station()
        station = ev.Station(7)
        sim = io.create_sim_station(7, evt)
        for k, ef0 in enumerate(src.get_electric_fields()[:3]):
            io.add_electric_field_to_sim_station(
                sim, [0, 1, 2, 3][k:], np.asarray(ef0.get_trace()), 0.0,
                (50 + 5 * k) * units.deg, (30 + 40 * k) * units.deg, ef0.get_sampling_rate())
        station.set_sim_station(sim)
        evt2 = ev.Event(0, 0)
        evt2.set_station(station)
        mod = dt.calculateAmplitudePerRaySolution(**kw)
        mod.begin()
        mod.run(evt2, station, det)
        out.append([(ef[io.efp.max_amp_antenna], ef[io.efp.max_amp_antenna_envelope])
                    for ef in sim.get_electric_fields()])
    for (aj, ej), (at, et) in zip(*out):
        assert sorted(at) == sorted(aj)
        for cid in aj:
            assert at[cid] == pytest.approx(aj[cid], rel=1e-12)
            assert et[cid] == pytest.approx(ej[cid], rel=1e-12)
