"""The port's LOFAR pipeline (reco/lofar.py) and TBB reader
(reco/lofar_tbb.py) against the JAX package's, on the CPU in float64.

The station is tests/test_lofar.py's (24 dual-polarised antennas, 8192
samples at 200 MHz, a plane-wave pulse on the even channels) with two
phase-stable CW lines added (``convert.make_lofar_station``), the same
numpy traces in both packages' events. Decisions and flags are equal (the
dirty channels, the reference antenna, the good antennas, the pulse
windows, the chosen grid points); phase stabilities and calibrated spectra
agree to 1e-12, SNRs to 1e-9, the beam-search powers to 1e-10 at every zoom
level, the plane-wave least squares to 1e-9. The TBB files are written
with h5py in the TBB DAL1 layout by this file's own writer, to
tests/test_lofar_tbb.py's recipe.
"""

import json


import numpy as np
import pytest
import torch

from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.framework import parameters as jpar
from nuradiomc_tpu.reco import lofar as jlofar
from nuradiomc_tpu.reco import lofar_tbb as jtbb
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.framework import parameters as tpar
from nuradiomc_tpu_torch.reco import examples
from nuradiomc_tpu_torch.reco import lofar as tlofar
from nuradiomc_tpu_torch.reco import lofar_tbb as ttbb

FS = convert.LOFAR_FS
ZEN, AZI = np.deg2rad(35.0), np.deg2rad(120.0)
CW = ((600 / 4096 * FS, 0.1), (1500 / 4096 * FS, 0.1))
GUESS = (ZEN + np.deg2rad(3), AZI - np.deg2rad(4))


class Pkg:
    def __init__(self, ev, par, lofar, kw):
        self.ev, self.par, self.lofar, self.kw = ev, par, lofar, kw

    def make(self, cls, *args):
        return getattr(self.lofar, cls)(*args, **self.kw)


JAX = Pkg(jev, jpar, jlofar, {})
PORT = Pkg(tev, tpar, tlofar, {"device": "cpu"})


def _event(p, det, **kw):
    event = p.ev.Event(run_number=0, event_id=1)
    event.set_station(convert.make_lofar_station(p.ev, det, 2, ZEN, AZI, **kw))
    return event


def _rfi_traces(flag_blocks=False):
    rng = np.random.default_rng(3)
    n_ant, L, n_blocks = 16, 4096, 8
    n = L * n_blocks
    tt = np.arange(n) / FS
    traces = rng.standard_normal((n_ant, n))
    for line_bin in (600, 1500):
        f = line_bin / L * FS
        phases = rng.uniform(0, 2 * np.pi, n_ant)
        traces += 2.0 * np.cos(2 * np.pi * f * tt[None, :] + phases[:, None])
    if flag_blocks:
        traces[3, 5 * L:5 * L + 1500] = 0.0          # a data-loss block
        traces[7, :1200] = 0.0
    return traces


@pytest.mark.parametrize("flag_blocks, flagged", [(False, None), (True, [2, 9])])
def test_find_rfi_matches(flag_blocks, flagged):
    traces = _rfi_traces(flag_blocks)
    want = jlofar.find_rfi(traces, FS, rfi_block_length=4096, flagged_antennas=flagged)
    got = tlofar.find_rfi(traces, FS, rfi_block_length=4096, flagged_antennas=flagged,
                          device="cpu")
    assert got["ref_antenna"] == want["ref_antenna"]
    for key in ("dirty_channels", "dirty_channels_block", "antenna_is_good"):
        np.testing.assert_array_equal(got[key], want[key])
    assert 600 in got["dirty_channels_block"] and 1500 in got["dirty_channels_block"]
    np.testing.assert_allclose(got["phase_stability"], want["phase_stability"], rtol=0,
                               atol=1e-12)
    for key in ("avg_power_spectrum", "avg_antenna_power", "cleaned_power"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)


def test_median_averages_the_middle_pair():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(6, 5)))
    for dim in (0, 1):
        np.testing.assert_array_equal(tlofar.median(x, dim).numpy(), np.median(x.numpy(), dim))


def test_station_rfi_filter_matches():
    rng = np.random.default_rng(4)
    n_ant, L = 12, 4096
    n = L * 4
    tt = np.arange(n) / FS
    traces = rng.standard_normal((n_ant, n))
    traces += 3.0 * np.cos(2 * np.pi * (800 / L * FS) * tt + rng.uniform(0, 2 * np.pi,
                                                                       n_ant)[:, None])
    traces[5] *= 4.0
    out = []
    for p in (JAX, PORT):
        event, station = p.ev.Event(0, 1), p.ev.Station(2)
        for ant in range(n_ant):
            ch = p.ev.Channel(ant)
            ch.set_trace(traces[ant], FS)
            station.add_channel(ch)
        event.set_station(station)
        mod = p.make("stationRFIFilter")
        mod.begin(rfi_cleaning_trace_length=L)
        mod.run(event)
        stnp = p.par.stationParameters
        out.append((station.get_parameter(stnp.dirty_fft_channels),
                    station.get_parameter(stnp.flagged_channels),
                    np.array([station.get_channel(c).get_frequency_spectrum()
                              for c in range(n_ant)])))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1] == out[0][1] and 5 in out[1][1]
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=0,
                               atol=1e-12 * np.abs(out[0][2]).max())


@pytest.fixture(scope="module")
def chains():
    """Both packages' chain on the same station: RFI filter, galactic
    calibration, pulse finder, plane-wave and beamforming fits, with the
    state after each step."""
    det = convert.LofarDetector(n_ant=24)
    out = {}
    for name, p in (("jax", JAX), ("port", PORT)):
        event = _event(p, det, cw_lines=CW)
        station = event.get_station(2)
        stnp, chp = p.par.stationParameters, p.par.channelParameters
        rfi = p.make("stationRFIFilter")
        rfi.begin(rfi_cleaning_trace_length=1024)
        rfi.run(event)
        cal = p.make("stationGalacticCalibrator")
        cal.begin()
        cal.run(event, det, unix_time=1386848000.0)
        calibrated = np.array([ch.get_frequency_spectrum() for ch in station.iter_channels()])
        finder = p.make("stationPulseFinder")
        finder.begin(window=256, noise_window=2000, cr_snr=6.5, good_channels=6)
        finder.run(event, det, GUESS)
        pulses = {ch.get_id(): (ch.get_parameter(chp.signal_regions),
                                ch.get_parameter(chp.SNR), ch.get_parameter(chp.signal_time),
                                ch.get_parameter(chp.noise_rms),
                                ch.get_parameter(chp.maximum_amplitude_envelope),
                                ch.get_parameter(chp.maximum_amplitude))
                  for ch in station.iter_channels()}
        plane = p.make("planeWaveDirectionFitter")
        plane.begin(cr_snr=6.5)
        plane.run(event, det)
        plane_dir = (station.get_parameter(stnp.cr_zenith), station.get_parameter(stnp.cr_azimuth))
        beam = p.make("beamformingDirectionFitter")
        beam.begin(cr_snr=6.5)
        beam.run(event, det)
        beam_dir = (station.get_parameter(stnp.cr_zenith), station.get_parameter(stnp.cr_azimuth))
        out[name] = dict(event=event, station=station, det=det, calibrated=calibrated,
                         pulses=pulses, plane=plane_dir, beam=beam_dir, beam_module=beam,
                         dirty=station.get_parameter(stnp.dirty_fft_channels),
                         triggered=station.get_parameter(stnp.triggered),
                         dominant=station.get_parameter(stnp.cr_dominant_polarisation))
    return out


def test_chain_rfi_and_calibration_match(chains):
    j, t = chains["jax"], chains["port"]
    np.testing.assert_array_equal(t["dirty"], j["dirty"])
    assert len(t["dirty"]) > 0
    np.testing.assert_allclose(t["calibrated"], j["calibrated"], rtol=0,
                               atol=1e-12 * np.abs(j["calibrated"]).max())


def test_chain_pulse_finder_matches(chains):
    j, t = chains["jax"], chains["port"]
    assert t["triggered"] == j["triggered"] is True
    np.testing.assert_array_equal(t["dominant"], j["dominant"])
    for cid, (win, snr, t_sig, rms, env, amp) in j["pulses"].items():
        win_t, snr_t, t_sig_t, rms_t, env_t, amp_t = t["pulses"][cid]
        assert list(win_t) == list(win)
        assert snr_t == pytest.approx(snr, rel=1e-9)
        assert t_sig_t == t_sig
        for a, b in ((rms_t, rms), (env_t, env), (amp_t, amp)):
            assert a == pytest.approx(b, rel=1e-9)


def test_chain_direction_fits_match(chains):
    j, t = chains["jax"], chains["port"]
    np.testing.assert_allclose(t["plane"], j["plane"], rtol=1e-9)
    np.testing.assert_allclose(t["beam"], j["beam"], rtol=1e-12)
    assert abs(t["plane"][0] - ZEN) < np.deg2rad(2.0)
    assert abs(t["beam"][0] - ZEN) < np.deg2rad(1.5)
    assert abs((t["beam"][1] - AZI + np.pi) % (2 * np.pi) - np.pi) < np.deg2rad(1.5)


def test_beam_search_levels_match(chains):
    """Every zoom level's grid powers against the JAX package's beamformer
    (vmapped as its fit does) on the same grid, and the same chosen point."""
    import jax
    import jax.numpy as jnp
    t = chains["port"]
    station, det = t["station"], t["det"]
    levels = t["beam_module"].levels
    assert len(levels) == 4 and levels[0][2].shape == (15, 15)
    ids = [ch.get_id() for ch in station.iter_channels() if ch.get_id() % 2 == 0]
    spectra = jnp.asarray(np.array([station.get_channel(c).get_frequency_spectrum()
                                    for c in ids]))
    freqs = jnp.asarray(station.get_channel(0).get_frequencies())
    positions = jnp.asarray(np.array([det.get_relative_position(2, c) for c in ids]))
    n = station.get_channel(0).get_number_of_samples()

    def peak_power(zenith, azimuth):
        d = jnp.array([jnp.sin(zenith) * jnp.cos(azimuth), jnp.sin(zenith) * jnp.sin(azimuth),
                       jnp.cos(zenith)])
        beamed = jlofar.beamformer(spectra, freqs, jlofar.geometric_delay_far_field(positions, d))
        return jnp.max(jnp.fft.irfft(beamed, n) ** 2)

    batched = jax.jit(jax.vmap(jax.vmap(peak_power, (None, 0)), (0, None)))
    for zen_grid, azi_grid, power in levels:
        want = np.asarray(batched(jnp.asarray(zen_grid), jnp.asarray(azi_grid)))
        np.testing.assert_allclose(power, want, rtol=1e-10)
        assert np.argmax(power) == np.argmax(want)


def test_check_for_good_ant_and_visualizer(chains, tmp_path):
    t = chains["port"]
    good = tlofar.check_for_good_ant(t["event"], t["det"])
    assert good == jlofar.check_for_good_ant(chains["jax"]["event"], chains["jax"]["det"])
    station = t["station"]
    n = 512
    pulse = np.exp(-0.5 * ((np.arange(n) - 200) / 10.0) ** 2)
    ef = tev.ElectricField([0, 1], position=np.array([30.0, -20.0, 0.0]))
    ef.set_trace(np.vstack([np.zeros(n), pulse, 0.4 * pulse]), 0.2)
    station.add_electric_field(ef)
    vis = tlofar.pipelineVisualizer(device="cpu")
    vis.begin()
    paths = vis.run(t["event"], t["det"], save_dir=str(tmp_path), polarization=True,
                    direction=True, time_fluence=True)
    assert len(paths) == 3


def test_helpers_match():
    assert tlofar.local_apparent_sidereal_time(946728000.0, 6.87) == \
        jlofar.local_apparent_sidereal_time(946728000.0, 6.87)
    p = np.random.default_rng(1).normal(size=9)
    assert tlofar.fourier_series(1.3, p) == jlofar.fourier_series(1.3, p)
    assert tlofar.median_sorted_by_power(range(10)) == jlofar.median_sorted_by_power(range(10))
    rng = np.random.default_rng(5)
    ts = rng.normal(size=4096)
    ts[2000:2010] += 10
    want = jlofar.find_snr_of_timeseries(ts, 0.2, 1900, 2156, 100, 1500, 16, True)
    got = tlofar.find_snr_of_timeseries(torch.as_tensor(ts), 0.2, 1900, 2156, 100, 1500, 16,
                                        True)
    np.testing.assert_allclose([float(x) for x in got], want, rtol=1e-12)
    pos = rng.normal(size=(5, 3)) * 50
    np.testing.assert_allclose(
        tlofar.geometric_delays_near_field(torch.as_tensor(pos), torch.tensor([1.0, 2, 300])),
        np.asarray(jlofar.geometric_delays_near_field(pos, np.array([1.0, 2, 300]))), rtol=1e-12)


def test_galactic_calibrator_refuses_other_orientations():
    class BadDet(convert.LofarDetector):
        def get_antenna_orientation(self, s, c):
            return np.deg2rad([90.0, 90.0, 90.0, 0.0])
    det = BadDet(n_ant=4)
    cal = PORT.make("stationGalacticCalibrator")
    cal.begin()
    with pytest.raises(ValueError):
        cal.run(_event(PORT, det, n_samples=4096), det, unix_time=1386848000.0)


# ---- the TBB reader -------------------------------------------------------

def _local_to_itrf(local_positions):
    """Invert convert_itrf_to_local (the rotation is orthonormal)."""
    basis = ttbb.convert_itrf_to_local(ttbb.CS002_ITRF + np.eye(3))
    return ttbb.CS002_ITRF + np.asarray(local_positions) @ np.linalg.inv(basis)


def write_tbb(path, dipoles, station_id=2, time_s=1270000000):
    """A TBB file of ``dipoles``: name -> (trace int16, sample number,
    calibration delay in s, local position [3])."""
    import h5py
    with h5py.File(path, "w") as f:
        f.attrs["ANTENNA_SET"] = np.array([b"LBA_OUTER"])
        f.attrs["FILTER_SELECTION"] = np.array([b"LBA_10_90"])
        grp = f.create_group(f"Station{ttbb.SID_TO_SNAME[station_id]}")
        for dip, (trace, sn, delay, pos) in dipoles.items():
            ds = grp.create_dataset(dip, data=np.asarray(trace, np.int16))
            for key, value in (("STATION_ID", station_id), ("SAMPLE_FREQUENCY_VALUE", 200.0),
                               ("SAMPLE_FREQUENCY_UNIT", b"MHz"), ("TIME", time_s),
                               ("SAMPLE_NUMBER", sn), ("DATA_LENGTH", len(trace)),
                               ("DIPOLE_CALIBRATION_DELAY_VALUE", delay)):
                ds.attrs[key] = np.array([value])
            ds.attrs["ANTENNA_POSITION_VALUE"] = _local_to_itrf(pos)
    return path


def _name(station_id, rcu):
    return f"{station_id:03d}000{rcu:03d}"


class FakeTBBDetector:
    """A detector keyed by the NRR channel ids of CS002 (2000000 + rcu)."""

    def __init__(self, local_positions):
        self.positions = {2000000 + 2 * ant + pol: np.asarray(pos)
                          for ant, pos in enumerate(local_positions) for pol in range(2)}

    def get_channel_group_id(self, station_id, channel_id):
        return channel_id - channel_id % 2

    def get_relative_position(self, station_id, channel_id):
        return self.positions[channel_id]

    def get_antenna_orientation(self, station_id, channel_id):
        phi = 135.0 if channel_id % 2 == 0 else 225.0
        return np.deg2rad([90.0, phi, 90.0, phi + 90.0])

    def get_number_of_channels(self, station_id):
        return len(self.positions)

    def get_site_coordinates(self, station_id=None):
        return 52.91, 6.87


@pytest.fixture(scope="module")
def tbb_event_dir(tmp_path_factory):
    """One CS002 station: 16 dual-polarised antennas, a plane-wave pulse from
    (35 deg, 120 deg) at the LORA trigger time, one dipole starting late (its
    antenna is dropped), and the LORA json beside the file."""
    tmp = tmp_path_factory.mktemp("tbb")
    rng = np.random.default_rng(7)
    n_ant, n_total, time_s = 16, 16384, 1270000000
    event_id = time_s - 1262304000
    clock_ns = ttbb.get_clock_corrections("LBA", time_s)["CS002"] * 1e9
    sample_numbers = np.full(2 * n_ant, 200)
    sample_numbers[5] = 230
    nominal = int(sample_numbers.max())
    s_trig = 10000                          # aligned sample of the trigger
    local_pos = np.zeros((n_ant, 3))
    local_pos[:, :2] = rng.uniform(-150, 150, (n_ant, 2))
    delays_ns = -(local_pos @ tlofar.spherical_to_cartesian(ZEN, AZI)) / 0.299792458
    tt = np.arange(n_total)
    dipoles = {}
    for ant in range(n_ant):
        t0 = s_trig + delays_ns[ant] * FS
        pulse = 2000.0 * np.exp(-0.5 * ((tt - t0) / 3.0) ** 2) \
            * np.cos(2 * np.pi * 0.275 * (tt - t0))
        for pol, amp in ((0, 1.0), (1, 0.3)):
            i = 2 * ant + pol
            sn = int(sample_numbers[i])
            trace = rng.normal(0.0, 20.0, n_total + nominal - sn)
            trace[nominal - sn:] += amp * pulse
            dipoles[_name(2, i)] = (np.round(trace).astype(np.int16), sn, 0.0, local_pos[ant])
    write_tbb(tmp / f"CS002_{ttbb.tbb_filetag_from_unix(time_s)}_R000_tbb.h5", dipoles,
              time_s=time_s)
    with open(tmp / f"{event_id}.json", "w") as f:
        json.dump({"LORA": {
            "utc_time_stamp": time_s, "time_stamp_ns": clock_ns + (s_trig + nominal) / 0.2,
            "zenith_rad": float(ZEN + np.deg2rad(2.0)),
            "azimuth_rad": float(AZI - np.deg2rad(3.0)),
            "core_x_m": 10.0, "core_y_m": -5.0, "energy_GeV": 2.1e8}}, f)
    return tmp, event_id, local_pos


def test_tbb_files_and_stations_match(tmp_path):
    rng = np.random.default_rng(1)
    pos = [0.0, 0.0, 0.0]

    def tr(k):
        return (k * np.ones(100) + rng.integers(0, 3, 100)).astype(np.int16)

    write_tbb(tmp_path / "a.h5", {_name(2, 0): (tr(1), 10, 1e-9, pos),
                                  _name(2, 2): (tr(2), 12, 2e-9, [1.0, 2.0, 3.0]),
                                  _name(2, 4): (tr(3), 10, 0.0, pos)})
    write_tbb(tmp_path / "b.h5", {_name(2, 1): (tr(4), 11, 0.0, pos),
                                  _name(2, 3): (tr(5), 10, 3e-9, pos),
                                  _name(2, 7): (tr(6), 10, 0.0, pos)})
    files = [str(tmp_path / "a.h5"), str(tmp_path / "b.h5")]
    for kw in ({}, {"only_complete_pairs": False}, {"bad_antennas": [(_name(2, 0), 0)]},
               {"polarization_flips": [_name(2, 2)], "additional_ant_delays":
                {_name(2, 2): (1e-9, 2e-9)}, "station_delay": 5e-9}):
        a, b = ttbb.TBBStation(files, **kw), jtbb.TBBStation(files, **kw)
        assert a.get_antenna_names() == b.get_antenna_names()
        for fn in ("get_timing_calibration_delays", "get_total_delays",
                   "get_lofar_centered_positions"):
            np.testing.assert_array_equal(getattr(a, fn)(), getattr(b, fn)())
        ga, oka = a.get_all_data(0, 80)
        gb, okb = b.get_all_data(0, 80)
        np.testing.assert_array_equal(ga, gb)
        np.testing.assert_array_equal(oka, okb)
        a.close()
        b.close()


def test_tbb_helpers_match():
    assert ttbb.get_clock_corrections("LBA", 1270000000) == \
        jtbb.get_clock_corrections("LBA", 1270000000)
    assert ttbb.lora_timestamp_to_blocknumber(1270000000, 5e8, 1270000000, 200) == \
        jtbb.lora_timestamp_to_blocknumber(1270000000, 5e8, 1270000000, 200)
    for f in ("tbbid_to_nrrid", ):
        assert getattr(ttbb, f)("002000017", "lba_inner") == getattr(jtbb, f)("002000017",
                                                                               "lba_inner")
    assert ttbb.tbb_filetag_from_unix(1270000000) == jtbb.tbb_filetag_from_unix(1270000000)


def test_read_lofar_data_event_matches(tbb_event_dir):
    tmp, event_id, local_pos = tbb_event_dir
    det = FakeTBBDetector(local_pos)
    events = []
    for mod in (ttbb, jtbb):
        reader = mod.readLOFARData(tbb_directory=str(tmp), json_directory=str(tmp))
        reader.begin(event_id)
        events.append(next(reader.run(det, trace_length=4096)))
    examples.assert_same_tree(examples.event_tree(events[0]), examples.event_tree(events[1]))
    # the port's pulse finder and plane-wave fit on the port's event
    finder = tlofar.stationPulseFinder(device="cpu")
    finder.begin(window=256, noise_window=1500, cr_snr=6.5, good_channels=6)
    shower = events[0].get_hybrid_information().get_hybrid_shower("LORA")
    finder.run(events[0], det, (shower.get_parameter(tpar.showerParameters.zenith),
                                shower.get_parameter(tpar.showerParameters.azimuth)))
    fitter = tlofar.planeWaveDirectionFitter(device="cpu")
    fitter.begin(cr_snr=6.5)
    fitter.run(events[0], det)
    zen = events[0].get_station(2).get_parameter(tpar.stationParameters.cr_zenith)
    assert abs(zen - np.deg2rad(35.0)) < np.deg2rad(2.0)
