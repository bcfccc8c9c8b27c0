"""The port's vertex reconstruction against the JAX package's, on the CPU in
float64.

* The travel-time table at tests/test_vertex.py's ``TABLE_KW`` grid (370 x
  293 points) for the antenna at -60 m: the same header, slot validity equal
  in every point of every ray type (0 points differ on this grid; a point
  where a refracted ray sits at the turning point is the one place two
  correct solvers may disagree, ROADMAP "The turning point"), and travel
  times within 1e-6 relative (the refracted rays differ by up to 3.6e-7
  there, the direct and reflected ones by 1e-12).
* The nearest-bin lookup on random points: equal, NaN outside alike.
* 2D and 3D vertices on tests/test_vertex.py's events: equal, with tables on
  the same grid at 16 m steps (both packages' tables built once per depth).
"""

import numpy as np
import pytest
import torch

import test_vertex as jtv
from nuradiomc_tpu.detector.detector import Detector as JDetector
from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.models import ice as jice
from nuradiomc_tpu.reco import vertex as jvertex
from nuradiomc_tpu_torch.detector.detector import Detector as TDetector
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.models import ice as tice
from nuradiomc_tpu_torch.reco import vertex as tvertex

JICE = jice.get_ice_model("greenland_simple")
TICE = tice.get_ice_model("greenland_simple")
COARSE_KW = dict(jtv.TABLE_KW, d_x=16.0, d_z=16.0)
TT_RTOL = 1e-6


@pytest.fixture(scope="module")
def tables_60():
    return (jvertex.build_travel_time_table(JICE, -60.0, **jtv.TABLE_KW),
            tvertex.build_travel_time_table(TICE, -60.0, device="cpu", **jtv.TABLE_KW))


def test_table_matches(tables_60):
    (hj, tj), (ht, tt) = tables_60
    assert hj == ht
    tt = tt.numpy()
    assert tt.shape == tj.shape == (3, 370, 293)
    np.testing.assert_array_equal(tt > 0, tj > 0)
    assert (tj > 0).sum(axis=(1, 2)).min() > 1000          # every ray type occurs
    ok = tj > 0
    np.testing.assert_allclose(tt[ok], tj[ok], rtol=TT_RTOL)


def test_table_chunks_agree():
    """A chunk that splits the grid gives the same table as one chunk."""
    kw = dict(x_min=20.0, x_max=420.0, d_x=20.0, z_min=-500.0, z_max=-30.0, d_z=20.0)
    _, a = tvertex.build_travel_time_table(TICE, -80.0, device="cpu", **kw)
    _, b = tvertex.build_travel_time_table(TICE, -80.0, device="cpu", chunk=97, **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_lookup_matches(tables_60):
    (hj, tj), (ht, tt) = tables_60
    rng = np.random.default_rng(3)
    d = rng.uniform(-50.0, 1600.0, 5000)
    z = rng.uniform(-1300.0, 0.0, 5000)
    for rt in ("direct", "refracted", "reflected"):
        ref = jvertex.lookup_travel_time(hj, tj, rt, d, z)
        got = tvertex.lookup_travel_time(ht, tt, rt, torch.as_tensor(d),
                                         torch.as_tensor(z)).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got[~np.isnan(got)], ref[~np.isnan(ref)], rtol=TT_RTOL)


@pytest.fixture(scope="module")
def coarse_tables():
    """Both packages' tables for the four string depths, built once."""
    out = {}
    for z in jtv.DEPTHS:
        key = round(float(z), 3)
        out[key] = (jvertex.build_travel_time_table(JICE, z, **COARSE_KW),
                    tvertex.build_travel_time_table(TICE, z, device="cpu", **COARSE_KW))
    return out


def _first_arrivals(positions, vertex):
    """First-arrival travel time at each channel, one batched solve of the
    port's solver (the same input for both packages)."""
    from nuradiomc_tpu_torch.ops import raytrace as trt
    x1 = torch.tensor([list(vertex)] * len(positions), dtype=torch.float64)
    geom = trt.to_2d(x1, torch.tensor(positions, dtype=torch.float64))
    sols = trt.find_solutions(geom.x1y, geom.x1z, geom.x2y, geom.x2z, TICE)
    tt = torch.where(sols.mask, sols.travel_time, torch.inf)
    return tt.min(dim=-1).values.tolist()


def _string_event(ev, sid, positions, vertex, seed0):
    """tests/test_vertex.py's synthetic pulses: a 0.25 GHz pulse at each
    channel's first arrival."""
    fs, n = 2.0, 2048
    t = np.arange(n) / fs
    arrivals = _first_arrivals(positions, vertex)
    t0 = min(arrivals) - 300.0
    st = ev.Station(sid)
    for cid, tt_c in enumerate(arrivals):
        t_arr = tt_c - t0
        tr = 0.2 * np.exp(-0.5 * ((t - t_arr) / 3.0) ** 2) * np.sin(2 * np.pi * 0.25 * (t - t_arr))
        ch = ev.Channel(cid)
        ch.set_trace(tr + np.random.default_rng(seed0 + cid).normal(0, 1e-3, n), fs)
        st.add_channel(ch)
    evt = ev.Event(0, 0)
    evt.set_station(st)
    return evt, st


def _detector_dict(positions, sid):
    chans = {}
    for cid, (x, y, z) in enumerate(positions):
        chans[str(cid + 1)] = {
            "adc_n_samples": 2048, "adc_sampling_frequency": 2.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
            "ant_position_x": x, "ant_position_y": y, "ant_position_z": z,
            "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
            "ant_type": "analytic_VPol", "amp_type": "", "cab_time_delay": 0.0,
            "adc_nbits": None, "channel_id": cid, "station_id": sid}
    return {"channels": chans, "stations": {"1": {"station_id": sid, "pos_altitude": 0,
                                                  "pos_easting": 0, "pos_northing": 0}}}


def _run_both(positions, vertex, seed0, cls, run_kw, coarse_tables):
    sid = 21 if cls == "neutrino2DVertexReconstructor" else 22
    d = _detector_dict(positions, sid)
    out = []
    for i, (ev, mod, det, kw) in enumerate(((jev, jvertex, JDetector(d), {}),
                                            (tev, tvertex, TDetector(d), {"device": "cpu"}))):
        evt, st = _string_event(ev, sid, positions, vertex, seed0)
        reco = getattr(mod, cls)(JICE if i == 0 else TICE, table_kwargs=COARSE_KW, **kw)
        reco._tables = {k: v[i] for k, v in coarse_tables.items()}
        reco.begin(sid, list(range(len(positions))), det)
        out.append(reco.run(evt, st, **run_kw))
    return out


def test_2d_vertex_equal(coarse_tables):
    (rj, zj), (rt, zt) = _run_both([(0.0, 0.0, z) for z in jtv.DEPTHS], (620.0, 0.0, -480.0),
                                   0, "neutrino2DVertexReconstructor",
                                   dict(max_distance=1400.0, z_width=1100.0,
                                        grid_spacing=20.0), coarse_tables)
    assert (rt, zt) == (rj, zj)


def test_3d_vertex_equal(coarse_tables):
    positions = [(0.0, 0.0, -60.0), (0.0, 0.0, -100.0), (40.0, 30.0, -80.0),
                 (40.0, 30.0, -120.0)]
    vj, vt = _run_both(positions, (380.0, 290.0, -620.0), 10,
                       "neutrino3DVertexReconstructor",
                       dict(max_distance=1200.0, z_range=(-1100.0, -50.0),
                            coarse_steps=20, n_zoom=3), coarse_tables)
    np.testing.assert_array_equal(np.asarray(vt), np.asarray(vj))
    assert abs(np.hypot(vt[0], vt[1]) - np.hypot(380.0, 290.0)) < 300.0
