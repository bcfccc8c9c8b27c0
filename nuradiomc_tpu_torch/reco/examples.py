"""Stations and events of the reconstruction examples, for either package.

The functions here take the event data model's module (``framework.event``) and
the parameter module (``framework.parameters``) of the package to build in,
so the port's tests can put the same inputs through the JAX package and the
port, and ``chip_smoke.py`` phase 12 drives the port on them:

* ``SIMPLE_DETECTOR`` / :func:`simple_event`:
  ``examples/03_reconstruction/simple_reconstruction.py``'s two-channel
  station and its band-limited efield;
* ``RECO_CHAIN_DETECTOR`` / :func:`reco_chain_event`:
  ``examples/04_vertex_direction_reco/run_reco_chain.py``'s eight channels on
  three strings and its synthetic event (vertex (380, 240, -600) m, zenith
  120 deg, azimuth 35 deg, log10 E 17.5, greenland_simple, GL1), made with
  the direction reconstructor's own forward model;
* ``SQUARE_DETECTOR`` / :func:`plane_wave_event` /
  :func:`beamforming_event`: ``tests/test_direction.py``'s four LPDAs in a
  6 m square and its plane waves;
* ``MIXED_DETECTOR`` / :func:`ift_event`: ``tests/test_ift_efield.py``'s
  four LPDAs of different rotations and its smooth-spectrum pulse from
  135 deg zenith (``IFT_TRUTH``).

Numbers come from numpy with fixed seeds, as in the scripts they copy.
"""

from __future__ import annotations

import numpy as np

from nuradiomc_tpu_torch.utils.constants import speed_of_light


def _channel(cid, sid, pos, ant, n=256, fs=1.0, delay=0.0, ori_theta=0.0, rot_phi=90.0):
    return {"adc_n_samples": n, "adc_sampling_frequency": fs,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": ori_theta,
            "ant_position_x": pos[0], "ant_position_y": pos[1], "ant_position_z": pos[2],
            "ant_rotation_phi": rot_phi, "ant_rotation_theta": 90.0,
            "ant_type": ant, "amp_type": "", "cab_time_delay": delay,
            "channel_id": cid, "station_id": sid, "adc_nbits": None}


def _detector(sid, chans):
    return {"channels": {str(i + 1): c for i, c in enumerate(chans)},
            "stations": {"1": {"station_id": sid, "pos_altitude": 0,
                               "pos_easting": 0, "pos_northing": 0}}}


# ---- examples/03_reconstruction/simple_reconstruction.py --------------------

SIMPLE_DETECTOR = _detector(42, [
    _channel(0, 42, (0.0, 0.0, -10.0), "analytic_VPol", delay=5.0),
    _channel(1, 42, (1.0, 0.0, -10.0), "analytic_HPol", delay=5.0)])


def simple_event(ev, par):
    """The example's station 42 with a band-limited efield (60 deg, 30 deg)."""
    efp, stnp = par.electricFieldParameters, par.stationParameters
    evt = ev.Event(0, 0)
    station = ev.Station(42)
    sim = ev.SimStation(42)
    fs, N = 2.0, 512
    ff = np.fft.rfftfreq(N, 1 / fs)
    spec = np.zeros((3, len(ff)), dtype=complex)
    band = (ff > 0.15) & (ff < 0.45)
    spec[1, band] = np.exp(-((ff[band] - 0.25) / 0.1) ** 2)
    spec[2, band] = 0.4 * np.exp(-((ff[band] - 0.3) / 0.08) ** 2)
    ef = ev.ElectricField([0, 1])
    ef.set_frequency_spectrum(spec * 1e-4, fs)
    ef[efp.zenith] = np.deg2rad(60.0)
    ef[efp.azimuth] = np.deg2rad(30.0)
    sim.add_electric_field(ef)
    station.set_sim_station(sim)
    station[stnp.zenith] = np.deg2rad(60.0)
    station[stnp.azimuth] = np.deg2rad(30.0)
    evt.set_station(station)
    return evt, station


# ---- examples/04_vertex_direction_reco/run_reco_chain.py ---------------------

RECO_CHAIN_POSITIONS = [(0.0, 0.0, -60.0), (0.0, 0.0, -80.0), (0.0, 0.0, -100.0),
                        (40.0, 30.0, -60.0), (40.0, 30.0, -90.0), (40.0, 30.0, -120.0),
                        (-30.0, 40.0, -70.0), (-30.0, 40.0, -110.0)]
RECO_CHAIN_DETECTOR = _detector(1, [_channel(c, 1, p, "analytic_VPol", n=1024, fs=2.0)
                                    for c, p in enumerate(RECO_CHAIN_POSITIONS)])
GREENLAND = "greenland_simple"
RECO_CHAIN_TRUTH = {"vertex": np.array([380.0, 240.0, -600.0]),
                    "zenith": np.deg2rad(120.0), "azimuth": np.deg2rad(35.0),
                    "log10_energy": 17.5}


def _host(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def reco_chain_event(ev, dir_reco, det, traces=None):
    """The example's station 1 and event: channels of 1024 samples at 2 GHz
    holding ``dir_reco``'s forward-model traces at the truth (a
    neutrinoDirectionReconstructor of either package, begun with the ice
    model and GL1) plus white noise of 3% of their peak (numpy seed 0).
    Pass ``traces`` to put given noiseless traces in instead. Returns
    (event, station, noise level)."""
    t = RECO_CHAIN_TRUTH
    n_ch = len(RECO_CHAIN_POSITIONS)
    st = ev.Station(1)
    for cid in range(n_ch):
        ch = ev.Channel(cid)
        ch.set_trace(np.zeros(1024), 2.0)
        st.add_channel(ch)
    evt = ev.Event(0, 0)
    evt.set_station(st)
    if traces is None:
        dir_reco.run(evt, st, det, vertex=t["vertex"], use_channels=list(range(n_ch)),
                     zenith_range=(t["zenith"] - .01, t["zenith"] + .01),
                     azimuth_range=(t["azimuth"] - .01, t["azimuth"] + .01),
                     energy_range=(t["log10_energy"] - .01, t["log10_energy"] + .01),
                     coarse_steps=(2, 2, 2), n_zoom=0)
        traces = _host(dir_reco.forward(t["zenith"], t["azimuth"], t["log10_energy"]))
    rng = np.random.default_rng(0)
    noise = 0.03 * np.max(np.abs(traces))
    for cid in range(n_ch):
        st.get_channel(cid).set_trace(traces[cid] + rng.normal(0, noise, 1024), 2.0)
    return evt, st, noise


# ---- tests/test_direction.py ------------------------------------------------

SQUARE_DETECTOR = _detector(7, [_channel(c, 7, (x, y, -1.0), "analytic_LPDA", n=512,
                                         ori_theta=180.0)
                                for c, (x, y) in enumerate([(3, 0), (0, 3), (-3, 0), (0, -3)])])


def _delay(zenith, azimuth, p, n=1.0):
    v = np.array([np.sin(zenith) * np.cos(azimuth), np.sin(zenith) * np.sin(azimuth),
                  np.cos(zenith)])
    return -n / speed_of_light * np.dot(v, p)


def _square_positions():
    return [np.array([c["ant_position_x"], c["ant_position_y"], c["ant_position_z"]])
            for c in SQUARE_DETECTOR["channels"].values()]


def plane_wave_event(ev, zenith=np.deg2rad(55.0), azimuth=np.deg2rad(127.0)):
    """A plane wave of a 0.3 GHz pulse over the square at 5 GHz
    (test_direction.test_reconstructs_known_direction)."""
    fs, N = 5.0, 512
    t = np.arange(N) / fs
    evt = ev.Event(0, 0)
    st = ev.Station(7)
    for cid, p in enumerate(_square_positions()):
        d = _delay(zenith, azimuth, p)
        ch = ev.Channel(cid)
        ch.set_trace(np.exp(-0.5 * ((t - 50.0 - d) / 2.0) ** 2)
                     * np.sin(2 * np.pi * 0.3 * (t - 50.0 - d)), fs, trace_start_time=0.0)
        st.add_channel(ch)
    evt.set_station(st)
    return evt, st


def beamforming_event(ev, vel_theta, zenith=np.deg2rad(122.0), azimuth=np.deg2rad(203.0)):
    """A theta-polarized plane wave through the square's LPDAs at 1 GHz
    (test_direction.test_beamforming_fitter_recovers_direction);
    ``vel_theta(cid, freqs, zenith, azimuth)`` gives a channel's VEL_theta."""
    fs, N = 1.0, 512
    t = np.arange(N) / fs
    freqs = np.fft.rfftfreq(N, 1.0 / fs)
    E_spec = np.fft.rfft(np.exp(-0.5 * ((t - 200.0) / 3.0) ** 2)
                         * np.sin(2 * np.pi * 0.2 * (t - 200.0)))
    evt = ev.Event(0, 0)
    st = ev.Station(7)
    for cid, p in enumerate(_square_positions()):
        d = _delay(zenith, azimuth, p)
        ch = ev.Channel(cid)
        ch.set_frequency_spectrum(np.asarray(vel_theta(cid, freqs, zenith, azimuth))
                                  * E_spec * np.exp(-2j * np.pi * freqs * d), fs)
        ch.set_trace_start_time(0.0)
        st.add_channel(ch)
    evt.set_station(st)
    return evt, st


# ---- tests/test_ift_efield.py -----------------------------------------------

MIXED_DETECTOR = _detector(7, [_channel(c, 7, (x, y, -1.0), "analytic_LPDA", n=512,
                                        ori_theta=180.0, rot_phi=45.0 + 90.0 * c)
                               for c, (x, y) in enumerate([(3, 0), (0, 3), (-3, 0), (0, -3)])])
# 135 deg zenith arrives exactly 45 deg off the downward LPDAs' axis, the
# edge between two of the analytic LPDA's phase sectors, which the port
# decides on the host (antenna.lpda_sector_host)
IFT_TRUTH = {"zenith": np.deg2rad(135.0), "azimuth": np.deg2rad(60.0), "pol": 0.6,
             "band": (0.08, 0.45), "noise": 2e-6}


def ift_true_spectrum(ff):
    """The falling-exponential spectrum with a pulse at 250 ns."""
    band = (ff >= IFT_TRUTH["band"][0]) & (ff <= IFT_TRUTH["band"][1])
    E = np.zeros(len(ff), dtype=complex)
    E[band] = 1e-3 * np.exp(-(ff[band] - 0.08) * 6.0) * np.exp(-2j * np.pi * ff[band] * 250.0)
    return E


def ift_event(ev, par, vel):
    """The four channels' spectra: the pulse at polarization angle 0.6
    folded through ``vel(cid, freqs, zenith, azimuth) -> (VEL_theta,
    VEL_phi)`` plus complex white noise of 2e-6 (numpy seed 0)."""
    stnp = par.stationParameters
    zen, az, pol = IFT_TRUTH["zenith"], IFT_TRUTH["azimuth"], IFT_TRUTH["pol"]
    fs, n = 1.0, 512
    ff = np.fft.rfftfreq(n, 1.0 / fs)
    E_true = ift_true_spectrum(ff)
    st = ev.Station(7)
    st[stnp.zenith] = zen
    st[stnp.azimuth] = az
    rng = np.random.default_rng(0)
    for cid in range(4):
        vt, vp = (np.asarray(x) for x in vel(cid, ff, zen, az))
        V = vt * np.cos(pol) * E_true + vp * np.sin(pol) * E_true
        V = V + IFT_TRUTH["noise"] * (rng.normal(size=len(ff)) + 1j * rng.normal(size=len(ff)))
        ch = ev.Channel(cid)
        ch.set_frequency_spectrum(V, fs)
        st.add_channel(ch)
    evt = ev.Event(0, 0)
    evt.set_station(st)
    return evt, st



# the bounds tests/test_vertex.py:154-157 (3D vertex) and
# tests/test_nu_direction.py:62-64 (direction and energy) hold a fit to
VERTEX_BOUNDS = {"azimuth_deg": 15.0, "slope": 0.3, "range_m": 300.0}
DIRECTION_BOUNDS = {"zenith_deg": 1.0, "azimuth_deg": 1.5, "log10_energy": 0.15}


# ---- comparing events of either package --------------------------------------

def _params(obj):
    return {f"{type(k).__name__}.{k.name}": v for k, v in obj._parameters.items()}


def _trace(bt):
    if bt.get_trace() is None:
        return None
    return (np.asarray(bt.get_trace()), bt.get_sampling_rate(), bt.get_trace_start_time())


def _station_tree(st):
    return {"params": _params(st),
            "channels": {ch.get_id() if not hasattr(ch, "get_unique_identifier")
                         else ch.get_unique_identifier(): (_trace(ch), _params(ch))
                         for ch in st.iter_channels()},
            "efields": [(list(ef.get_channel_ids()), _trace(ef), _params(ef),
                         np.asarray(ef.get_position()))
                        for ef in st.get_electric_fields()],
            "triggers": {name: dict(vars(t)) for name, t in st.get_triggers().items()}}


def event_tree(event):
    """An event as nested plain values (parameters keyed by enum and member
    name, traces as (array, sampling rate, start time), triggers as their
    attribute dicts), so events of the two packages, or an event and its copy
    read back from a file, compare with :func:`assert_same_tree`."""
    stations = {}
    for st in event.get_stations():
        tree = _station_tree(st)
        if st.has_sim_station():
            tree["sim_station"] = _station_tree(st.get_sim_station())
        stations[st.get_id()] = tree
    return {"id": (event.get_run_number(), event.get_id()), "params": _params(event),
            "stations": stations,
            "showers": [_params(s) for s in event.get_showers()],
            "sim_showers": [_params(s) for s in event.get_sim_showers()],
            "particles": [_params(p) for p in event.get_particles()]}


def assert_same_tree(a, b, path="event"):
    """Raise AssertionError unless two :func:`event_tree` values are equal,
    arrays bit for bit."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(map(str, a)) == sorted(map(str, b)), path
        for k in b:
            assert_same_tree(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, path
        assert np.array_equal(x, y, equal_nan=x.dtype.kind in "fc"), path
    elif isinstance(b, float) and np.isnan(b):
        assert isinstance(a, float) and np.isnan(a), path
    else:
        assert a == b, (path, a, b)
