"""The port's further reconstruction modules (reco/advanced.py) against the
JAX package's, on the CPU in float64.

The noise adders are seed-exact: both packages draw from numpy's Philox on
the host in the same order (the port as one ``uniform`` call per pixel), so
the spectra after the galactic (channel and efield) and ice thermal noise
adders agree to 1e-12 of their peak, not statistically. Closed forms agree
to 1e-12 relative, least-squares directions to 1e-9, the grid fit's chosen
point exactly.
"""

import copy

import numpy as np
import pytest

from nuradiomc_tpu.detector.detector import Detector as JDetector
from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.framework import parameters as jpar
from nuradiomc_tpu.reco import advanced as jadv
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.detector.detector import Detector as TDetector
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.framework import parameters as tpar
from nuradiomc_tpu_torch.reco import advanced as tadv
from nuradiomc_tpu_torch.utils import units

RTOL = 1e-12


class Pkg:
    def __init__(self, ev, par, adv, Detector, kw):
        self.ev, self.par, self.adv, self.Detector, self.kw = ev, par, adv, Detector, kw

    def make(self, cls, *args):
        return getattr(self.adv, cls)(*args, **self.kw)


JAX = Pkg(jev, jpar, jadv, JDetector, {})
PORT = Pkg(tev, tpar, tadv, TDetector, {"device": "cpu"})


def _of_peak(got, want, tol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.max(np.abs(want)))


class GalacticDet:
    """tests/test_reco_advanced.py's station: a surface LPDA and an in-ice
    channel at Moore's Bay."""

    def get_site_coordinates(self, station_id):
        return -78.74, 165.02

    def get_relative_position(self, station_id, channel_id):
        return np.array([3.0, 0.0, 1.0]) if channel_id == 0 \
            else np.array([0.0, 0.0, -2.0])

    def get_antenna_orientation(self, station_id, channel_id):
        return np.deg2rad([180.0, 0.0, 90.0, 90.0])

    def get_antenna_model(self, station_id, channel_id):
        return "analytic_LPDA"


def _galactic_station(p, n=4096, fs=2.0):
    rng = np.random.default_rng(5)
    evt, st = p.ev.Event(0, 0), p.ev.Station(3)
    for cid in (0, 1):
        ch = p.ev.Channel(cid)
        ch.set_trace(rng.normal(0, 1e-6, n), fs)
        st.add_channel(ch)
    evt.set_station(st)
    st.set_station_time(1.4e9)
    return evt, st


@pytest.mark.parametrize("begin, run", [
    ({"seed": 1, "n_pixels": 64}, {}),
    ({"seed": 7, "n_pixels": 192, "scaling": 2.0}, {"passband": [30 * units.MHz, 300 * units.MHz]}),
    ({"seed": 3, "n_side": 2, "skymodel": "callable"}, {"excluded_channels": [1]})])
def test_channel_galactic_noise_is_seed_exact(begin, run):
    out = []
    for p in (JAX, PORT):
        evt, st = _galactic_station(p)
        kw = dict(begin)
        if kw.get("skymodel") == "callable":
            kw["skymodel"] = lambda f, l, b: 100 * p.adv.cane_galactic_temperature(f) \
                * units.kelvin * (1 + 0.5 * np.sin(l) * np.cos(b))
        g = p.make("channelGalacticNoiseAdder")
        g.begin(**kw)
        g.run(evt, st, GalacticDet(), **run)
        out.append(np.array([st.get_channel(c).get_frequency_spectrum() for c in (0, 1)]))
    _of_peak(out[1], out[0])
    assert np.max(np.abs(out[0])) > 0


def _efield_station(p, n_efields=2):
    evt, station = p.ev.Event(0, 0), p.ev.Station(7)
    sim = p.ev.SimStation(7)
    fs, N = 2.0, 512
    ff = np.fft.rfftfreq(N, 1 / fs)
    band = (ff > 0.15) & (ff < 0.45)
    for k in range(n_efields):
        spec = np.zeros((3, len(ff)), dtype=complex)
        spec[1, band] = np.exp(-((ff[band] - 0.25) / 0.1) ** 2) * np.exp(2j * np.pi * ff[band] * 30)
        spec[2, band] = 0.5 * np.exp(-((ff[band] - 0.3) / 0.08) ** 2)
        ef = p.ev.ElectricField([0, 1], position=np.array([2.0 * k, -1.0, -3.0 * k]),
                                shower_id=k, ray_tracing_id=0)
        ef.set_frequency_spectrum(spec * (1.0 + 0.5 * k), fs)
        sim.add_electric_field(ef)
    station.set_sim_station(sim)
    evt.set_station(station)
    return evt, sim


def test_efield_galactic_noise_is_seed_exact():
    det = TDetector(convert.coreas_lpda_detector())
    out = []
    for p in (JAX, PORT):
        evt, sim = _efield_station(p)
        adder = p.make("efieldGalacticNoiseAdder")
        adder.begin(n_pixels=48, seed=3)
        adder.run(evt, sim, det, passband=[30 * units.MHz, 300 * units.MHz])
        out.append(np.array([ef.get_frequency_spectrum() for ef in sim.get_electric_fields()]))
    _of_peak(out[1], out[0])


def _string_detector(p, depths=(-60.0, -80.0, -100.0, -120.0)):
    chans = {str(cid + 1): {
        "adc_n_samples": 2048, "adc_sampling_frequency": 2.0,
        "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
        "ant_position_x": 0.0, "ant_position_y": 0.0, "ant_position_z": z,
        "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
        "ant_type": "analytic_VPol", "amp_type": "", "cab_time_delay": 0.0,
        "adc_nbits": None, "channel_id": cid, "station_id": 21}
        for cid, z in enumerate(depths)}
    return p.Detector({"channels": chans, "stations": {"1": {
        "station_id": 21, "pos_altitude": 0, "pos_easting": 0, "pos_northing": 0}}})


def test_ice_thermal_noise_is_seed_exact():
    thetas = np.linspace(0, np.pi, 20)
    temps = {z: (thetas, 250.0 + 50 * np.cos(thetas)) for z in (-60.0, -80.0, -100.0, -120.0)}
    out = []
    for p in (JAX, PORT):
        st = p.ev.Station(21)
        for cid in range(4):
            ch = p.ev.Channel(cid)
            ch.set_trace(np.zeros(1024), 2.0)
            st.add_channel(ch)
        adder = p.make("channelIceThermalNoiseAdder")
        adder.begin(temps, nr_phi_bins=8, seed=1)
        adder.run(p.ev.Event(0, 0), st, _string_detector(p))
        out.append(np.array([st.get_channel(c).get_frequency_spectrum() for c in range(4)]))
    _of_peak(out[1], out[0])
    with pytest.raises(KeyError):
        adder = PORT.make("channelIceThermalNoiseAdder")
        adder.begin({-60.0: temps[-60.0]}, nr_phi_bins=4, seed=1)
        adder.run(None, st, _string_detector(PORT))


def _lpda_station(p, fs=5.0, n=512, zen=np.deg2rad(55.0), az=np.deg2rad(127.0)):
    """Four downward LPDAs, a plane-wave pulse and its arrival times."""
    det = p.Detector(convert.coreas_lpda_detector())
    chp = p.par.channelParameters
    rng = np.random.default_rng(4)
    u = np.array([np.sin(zen) * np.cos(az), np.sin(zen) * np.sin(az), np.cos(zen)])
    evt, st = p.ev.Event(0, 0), p.ev.Station(7)
    t = np.arange(n) / fs
    for cid in range(4):
        dt = -np.dot(det.get_relative_position(7, cid), u) / 0.299792458
        ch = p.ev.Channel(cid)
        ch.set_trace(np.exp(-0.5 * ((t - 40.0 - dt) / 1.5) ** 2) * np.sin(2 * np.pi * 0.2 * t)
                     + rng.normal(0, 0.01, n), fs)
        ch[chp.signal_time] = dt
        st.add_channel(ch)
    evt.set_station(st)
    return evt, st, det


def test_template_correlation_matches():
    tpl = np.exp(-0.5 * ((np.arange(64) - 32) / 3.0) ** 2) * np.sin(np.arange(64))
    out = []
    for p in (JAX, PORT):
        evt, st, det = _lpda_station(p)
        m = p.make("channelTemplateCorrelation")
        m.begin({"default": tpl, 2: 0.5 * tpl[::-1]})
        m.run(evt, st, det, cosmic_ray=True)
        out.append([st.get_channel(c)[p.par.channelParameters.cr_xcorrelations]
                    for c in range(4)])
    for a, b in zip(*out):
        assert b["cr_xcorr_time"] == a["cr_xcorr_time"]
        assert b["cr_ref_xcorr_time"] == a["cr_ref_xcorr_time"]
        assert b["cr_max_xcorr"] == pytest.approx(a["cr_max_xcorr"], rel=RTOL)


def test_wave_fitters_match():
    """tests/test_reco_advanced.py's geometry: a source for the spherical
    fit, then a far source for the plane-wave fit."""
    positions = [(0, 0, -100), (20, 0, -100), (0, 20, -100), (0, 0, -140)]
    src = np.array([150.0, 80.0, -400.0])
    far = np.array([5000.0, 2000.0, 3000.0]) / np.linalg.norm([5000.0, 2000.0, 3000.0])
    out = []
    for p in (JAX, PORT):
        chp, stnp = p.par.channelParameters, p.par.stationParameters
        det = p.Detector({"channels": {str(c + 1): {
            "adc_n_samples": 256, "adc_sampling_frequency": 1.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
            "ant_position_x": x, "ant_position_y": y, "ant_position_z": z,
            "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
            "ant_type": "analytic_VPol", "amp_type": "", "cab_time_delay": 0.0,
            "adc_nbits": None, "channel_id": c, "station_id": 3}
            for c, (x, y, z) in enumerate(positions)}, "stations": {"1": {"station_id": 3}}})
        evt, st = p.ev.Event(0, 0), p.ev.Station(3)
        for cid, pos in enumerate(positions):
            ch = p.ev.Channel(cid)
            ch.set_trace(np.zeros(64), 1.0)
            ch[chp.signal_time] = np.linalg.norm(src - np.asarray(pos, float)) * 1.75 / 0.299792458
            st.add_channel(ch)
        evt.set_station(st)
        fit = p.make("sphericalWaveFitter")
        fit.begin(channel_ids=[0, 1, 2, 3])
        pos, chi2 = fit.run(evt, st, det, start_pulser_position=[100, 100, -350])
        for cid, q in enumerate(positions):
            st.get_channel(cid)[chp.signal_time] = -np.dot(np.asarray(q, float), far) / 0.299792458
        p.make("planeWaveDirectionFitter").run(evt, st, det, channel_ids=[0, 1, 2, 3])
        out.append((pos, chi2, st[stnp.zenith], st[stnp.azimuth]))
    (pj, cj, zj, aj), (pt, ct, zt, at) = out
    np.testing.assert_array_equal(pt, pj)            # the chosen grid point
    assert ct == pytest.approx(cj, rel=1e-9)
    np.testing.assert_allclose([zt, at], [zj, aj], rtol=1e-9)
    assert abs(zt - np.arccos(far[2])) < np.deg2rad(2.0)


@pytest.mark.parametrize("site, quad", [("southpole", 0.1), ("southpole", -2.5),
                                        ("summit", 0.1), ("auger", -5.0)])
def test_cosmic_ray_energy_matches(site, quad):
    rng = np.random.default_rng(11)
    n, fs = 512, 1.0
    tt = np.arange(n) / fs
    trace = np.zeros((3, n))
    trace[1] = 60e-3 * np.exp(-0.5 * ((tt - 200.0) / 8.0) ** 2) * np.cos(2 * np.pi * 0.15 * tt)
    trace[2] = 25e-3 * np.exp(-0.5 * ((tt - 200.0) / 8.0) ** 2) * np.sin(2 * np.pi * 0.15 * tt)
    trace += rng.normal(0, 1e-4, trace.shape)
    out = []
    for p in (JAX, PORT):
        efp, stnp = p.par.electricFieldParameters, p.par.stationParameters
        evt, st = p.ev.Event(0, 1), p.ev.Station(42)
        st[stnp.zenith], st[stnp.azimuth] = np.deg2rad(55.0), np.deg2rad(230.0)
        ef = p.ev.ElectricField([0])
        ef.set_trace(trace, fs)
        ef[efp.cr_spectrum_slope] = -2.5
        ef[efp.cr_spectrum_quadratic_term] = quad
        st.add_electric_field(ef)
        evt.set_station(st)
        rec = p.make("cosmicRayEnergyReconstructor")
        rec.begin(site=site)
        out.append(rec.run(evt, st))
    assert out[1] == pytest.approx(out[0], rel=RTOL)
    with pytest.raises(ValueError):
        PORT.make("cosmicRayEnergyReconstructor").begin(site="nowhere")


def test_antenna_dedispersion_matches():
    out = []
    for p in (JAX, PORT):
        evt, st, det = _lpda_station(p)
        m = p.make("channelAntennaDedispersion")
        m.begin()
        m.run(evt, st, det)
        out.append(np.array([st.get_channel(c).get_frequency_spectrum() for c in range(4)]))
    _of_peak(out[1], out[0])


def test_sky_helpers_equal_the_originals():
    f = np.array([10, 30, 100, 300, 1000]) * units.MHz
    np.testing.assert_array_equal(tadv.cane_galactic_temperature(f),
                                  jadv.cane_galactic_temperature(f))
    for a, b in zip(tadv.fibonacci_sky(192), jadv.fibonacci_sky(192)):
        np.testing.assert_array_equal(a, b)
    l, b_ = jadv.fibonacci_sky(64)
    for a, b in zip(tadv.galactic_to_equatorial(l, b_), jadv.galactic_to_equatorial(l, b_)):
        np.testing.assert_array_equal(a, b)
    ra, dec = jadv.galactic_to_equatorial(l, b_)
    for a, b in zip(tadv.equatorial_to_horizontal(ra, dec, 7.3, 72.57),
                    jadv.equatorial_to_horizontal(ra, dec, 7.3, 72.57)):
        np.testing.assert_array_equal(a, b)
    for site in tadv.MAGNETIC_FIELD_VECTORS:
        np.testing.assert_array_equal(tadv.MAGNETIC_FIELD_VECTORS[site],
                                      jadv.MAGNETIC_FIELD_VECTORS[site])
        assert tadv.get_angle_to_magnetic_field_vector(0.7, 2.0, site) == \
            jadv.get_angle_to_magnetic_field_vector(0.7, 2.0, site)
    assert copy.deepcopy(tadv.cosmicRayEnergyReconstructor.ELEVATIONS) == \
        jadv.cosmicRayEnergyReconstructor.ELEVATIONS
