"""The port's atmosphere, refractivity and radio-interferometric (RIT)
reconstruction against the JAX package's, on the CPU in float64.

The input is tests/test_rit.py's line emitter (``convert.make_rit_event``:
30 antennas over +-400 m, 2048 samples at 1 GHz), the same numpy arrays
through both packages. Closed forms (time shifts, the atmosphere) agree to
1e-12 relative; a beamformed trace and its signal to 1e-12 of peak; the
profiles and lateral maxima, which sum interpolations whose abscissae move
by an ulp of the shifts, to 1e-9 relative, as does the SVD axis fit built
on them; the Gauss fit of X_RIT to curve_fit's own xtol (1.49e-8), where
the least squares stops; grid decisions (the depths sampled, the summed grid lengths, the
chosen grid points) are equal.
"""

import numpy as np
import pytest
import torch

from nuradiomc_tpu.models import atmosphere as jatm
from nuradiomc_tpu.reco import rit as jrit
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.models import atmosphere as tatm
from nuradiomc_tpu_torch.reco import rit as trit

C = 0.299792458
B_FIELD = np.array([0.0, 18.0, -49.0])
CURVE_FIT_XTOL = 1.49012e-08      # scipy.optimize.curve_fit's (leastsq's) default


@pytest.fixture(scope="module")
def event():
    return convert.make_rit_event()


def test_atmosphere_copy_equals_the_original():
    for model in (1, 17):
        a, b = tatm.Atmosphere(model), jatm.Atmosphere(model)
        h = np.linspace(-100.0, 1.2e5, 301)
        np.testing.assert_array_equal(a.get_vertical_depth(h), b.get_vertical_depth(h))
        np.testing.assert_array_equal(a.get_density(h), b.get_density(h))
        X = np.linspace(0.0, 1000.0, 51)
        np.testing.assert_array_equal(a.get_vertical_height(X), b.get_vertical_height(X))
        for zen in (0.0, 0.6, 1.2):
            assert a.get_distance_xmax_geometric(zen, 650.0, 1400.0) == \
                b.get_distance_xmax_geometric(zen, 650.0, 1400.0)


@pytest.mark.parametrize("model", [1, 17])
def test_refractivity_time_delays_match(event, model):
    positions = event[0]
    port = tatm.Refractivity(tatm.Atmosphere(model))
    ref = jatm.Refractivity(jatm.Atmosphere(model))
    points = event[4] + np.array([[0.0, 0.0, 0.0], [500.0, 0.0, 0.0], [10.0, 20.0, -30.0],
                                  [0.0, 0.0, 2e4]])
    got = port.time_delay(torch.as_tensor(points)[:, None, :], torch.as_tensor(positions),
                          C).numpy()
    want = np.array([ref.time_delay(p, positions, C) for p in points])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    n_got = port.effective_refractivity(torch.as_tensor(points)[:, None, :],
                                        torch.as_tensor(positions)).numpy()
    n_want = np.array([ref.effective_refractivity(p, positions) for p in points])
    np.testing.assert_allclose(n_got, n_want, rtol=1e-12)


@pytest.mark.parametrize("offset", [[0.0, 0.0, 0.0], [500.0, 0.0, 0.0], [10.0, 20.0, -30.0]])
def test_interfere_traces_and_signal_match(event, offset):
    positions, traces, times, _, source, _ = event
    target = source + np.asarray(offset)
    want, tstep = jrit.interfere_traces(target, positions, traces, times,
                                        jatm.Refractivity(jatm.Atmosphere(17)))
    got, step = trit.interfere_traces(target, positions, traces, times,
                                      tatm.Refractivity(tatm.Atmosphere(17)), device="cpu")
    assert got.shape == want.shape and step == tstep
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    for kind in ("power", "amplitude", "hilbert_sum"):
        s = float(trit.get_signal(torch.as_tensor(want)[None], [tstep], kind=kind)[0])
        assert s == pytest.approx(jrit.get_signal(want, tstep, kind=kind), rel=1e-12), kind


def test_get_signal_pads_a_short_trace():
    rng = np.random.default_rng(3)
    for n in (64, 65):
        tr = rng.normal(size=n)
        for kind in ("power", "hilbert_sum"):
            got = float(trit.get_signal(torch.as_tensor(tr)[None], [1.0], kind=kind)[0])
            assert got == pytest.approx(jrit.get_signal(tr, 1.0, kind=kind), rel=1e-12)


def test_summed_grids_follow_numpy_arange(event):
    positions, traces, times, _, source, _ = event
    refr = tatm.Refractivity(tatm.Atmosphere(17))
    points = source + np.random.default_rng(1).normal(0, 300.0, (40, 3))
    shifts = refr.time_delay(torch.as_tensor(points)[:, None, :],
                             torch.as_tensor(positions), C).numpy()
    start, step, delta, length = trit.summed_grids(shifts, times)
    for p in range(len(points)):
        tn = times - shifts[p][:, None]
        ts = tn[0, 1] - tn[0, 0]
        grid = np.arange(tn.min(), tn.max() + ts, ts)
        assert (length[p], step[p]) == (len(grid), ts)
        np.testing.assert_array_equal(start[p] + np.arange(len(grid)) * delta[p], grid)


@pytest.fixture(scope="module")
def depth_results(event):
    positions, traces, times, axis, _, _ = event
    out = {}
    for name, mod, kw in (("jax", jrit, {}), ("port", trit, {"device": "cpu"})):
        reco = mod.efieldInterferometricDepthReco(**kw)
        reco.begin()
        out[name] = reco.reconstruct_interferometric_depth(
            traces, times, positions, axis, np.zeros(3), return_profile=True)
    return out


def test_longitudinal_profile_and_depth_match(depth_results):
    (dj, fj, sj, sfj, pj), (dt, ft, st, sft, pt) = depth_results["jax"], depth_results["port"]
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(st, sj, rtol=1e-9)
    np.testing.assert_allclose(sft, sfj, rtol=1e-9)
    # the Gauss fit to curve_fit's own stopping rule (xtol), which ends the
    # two fits of profiles equal to 1e-14 that far apart
    np.testing.assert_allclose(pt, pj, rtol=CURVE_FIT_XTOL)
    assert abs(pt[1] - 650.0) < 30.0            # tests/test_rit.py's bound


def test_lateral_plane_signals_match(event):
    positions, traces, times, axis, _, _ = event
    frame = trit.shower_frame(np.deg2rad(32.0), np.deg2rad(250.0), B_FIELD)
    xs = np.linspace(-250.0, 250.0, 7)
    ys = np.linspace(-250.0, 250.0, 7)
    p_axis = axis * jatm.Atmosphere(17).get_distance_xmax_geometric(np.deg2rad(32.0), 650.0)
    results = []
    for mod, kw in ((jrit, {}), (trit, {"device": "cpu"})):
        reco = mod.efieldInterferometricAxisReco(**kw)
        reco.begin()
        results.append(reco.find_maximum_in_plane(xs, ys, p_axis, positions, traces, times,
                                                  frame))
    (kj, sj), (kt, st) = results
    assert tuple(kt) == tuple(kj)
    np.testing.assert_allclose(st, sj, rtol=1e-9)


def test_axis_reconstruction_matches(event):
    positions, traces, times, _, _, _ = event
    zen_g = np.deg2rad(32.5)
    az = np.deg2rad(70.0)
    guess = np.array([np.sin(zen_g) * np.cos(az), np.sin(zen_g) * np.sin(az), np.cos(zen_g)])
    kw = dict(depths=(450.0, 650.0, 850.0), grid_size=250.0)
    results = []
    for mod, dev in ((jrit, {}), (trit, {"device": "cpu"})):
        reco = mod.efieldInterferometricAxisReco(**dev)
        reco.begin()
        results.append(reco.reconstruct_shower_axis(traces, times, positions, guess,
                                                    np.array([60.0, 0.0, 0.0]), B_FIELD,
                                                    **kw))
    (zj, aj, cj), (zt, at, ct) = results
    np.testing.assert_allclose([zt, at], [zj, aj], rtol=1e-9)
    np.testing.assert_allclose(ct, cj, rtol=1e-9, atol=1e-9)


def test_frame_and_axis_fit_copies_equal_the_originals():
    for zen, az in ((0.3, 1.0), (1.1, 4.0)):
        for a, b in zip(trit.shower_frame(zen, az, B_FIELD), jrit.shower_frame(zen, az, B_FIELD)):
            np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(2).normal(size=(5, 3)) * 100 + np.array([0, 0, 5e3])
    for a, b in zip(trit.fit_axis_through_points(pts, 10.0),
                    jrit.fit_axis_through_points(pts, 10.0)):
        np.testing.assert_array_equal(a, b)


def test_depth_reco_run_from_a_shower():
    """run() with a shower object: axis and core from its parameters."""
    from nuradiomc_tpu.framework.event import Shower as JShower
    from nuradiomc_tpu.framework.parameters import showerParameters as jshp
    from nuradiomc_tpu_torch.framework.event import Shower as TShower
    from nuradiomc_tpu_torch.framework.parameters import showerParameters as tshp
    positions, traces, times, _, _, _ = convert.make_rit_event(n_ant=12)
    got = []
    for mod, Shower, shp, kw in ((jrit, JShower, jshp, {}),
                                 (trit, TShower, tshp, {"device": "cpu"})):
        sh = Shower(0)
        sh[shp.zenith], sh[shp.azimuth], sh[shp.core] = np.deg2rad(32.0), np.deg2rad(70.0), \
            np.zeros(3)
        reco = mod.efieldInterferometricDepthReco(**kw)
        reco.begin()
        got.append(reco.run(None, traces=traces, times=times, station_positions=positions,
                            shower=sh))
    assert got[1] == pytest.approx(got[0], rel=CURVE_FIT_XTOL)


def test_ragged_envelope_and_signals_match_per_length():
    """The Bluestein batch of rows of mixed lengths against scipy's Hilbert
    transform of each row at its own length (1e-12 of peak), and the
    signals of an Interferometer's points against the JAX package's
    get_signal of each point's beamformed trace."""
    from scipy import signal as scisig
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 257))
    lengths = np.array([257, 256, 130, 129, 3, 2])
    env = trit.ragged_hilbert_envelope(torch.as_tensor(x), torch.as_tensor(lengths)).numpy()
    for r, n in enumerate(lengths):
        want = np.abs(scisig.hilbert(x[r, :n]))
        np.testing.assert_allclose(env[r, :n], want, rtol=0, atol=1e-12 * want.max())
        assert np.all(env[r, n:] == 0)


def test_interferometer_signals_match_per_point(event):
    positions, traces, times, _, source, _ = event
    points = source + np.random.default_rng(5).normal(0, 200.0, (12, 3))
    itf = trit.Interferometer(traces, times, positions, tatm.Refractivity(tatm.Atmosphere(17)),
                              "cpu")
    got = itf.signals(points)
    ref = jatm.Refractivity(jatm.Atmosphere(17))
    for p, s in zip(points, got):
        summed, tstep = jrit.interfere_traces(p, positions, traces, times, ref)
        assert s == pytest.approx(jrit.get_signal(summed, tstep), rel=1e-12)


@pytest.mark.parametrize("kind", ["hilbert_sum", "amplitude"])
def test_interferometer_signal_kinds_match_per_point(event, kind):
    """The other signal kinds over points of mixed grid lengths, each of
    whose envelopes (and, for hilbert_sum, the envelope of its rolled and
    padded trace) is a row of one ragged batch, against the JAX package's
    get_signal of each point's beamformed trace (1e-12 relative)."""
    positions, traces, times, _, source, _ = event
    points = source + np.random.default_rng(6).normal(0, 300.0, (10, 3))
    itf = trit.Interferometer(traces, times, positions, tatm.Refractivity(tatm.Atmosphere(17)),
                              "cpu")
    got = itf.signals(points, kind, window_width=4000.0)      # wider than the traces
    lengths = trit.summed_grids(itf.time_shifts(points).numpy(), times)[3]
    assert len(np.unique(lengths)) > 1 and lengths.max() < 4000
    ref = jatm.Refractivity(jatm.Atmosphere(17))
    for p, s in zip(points, got):
        summed, tstep = jrit.interfere_traces(p, positions, traces, times, ref)
        assert s == pytest.approx(jrit.get_signal(summed, tstep, 4000.0, kind), rel=1e-12)
