"""The port's channel processing, efield converters and analytic-pulse fit
against the JAX package's, on the CPU in float64.

The event is ``examples/03_reconstruction/simple_reconstruction.py``'s: a
band-limited efield on a two-channel (VPol + HPol) station, folded into
voltages, Rayleigh noise (seed 42), a butterworth band-pass, the channel
observables and the unfolded efield. The same inputs (numpy, fixed seeds) go
through both packages; traces and spectra agree within 1e-10 of each
trace's peak (RTOL), observables within rtol 1e-10, and the noise is the
same draw (numpy's Philox on the host in both).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.detector.detector import Detector as JDetector
from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.framework import parameters as jpar
from nuradiomc_tpu.reco import analytic_efield as janalytic
from nuradiomc_tpu.reco import channel_processing as jcp
from nuradiomc_tpu.reco import efield_converters as jec
from nuradiomc_tpu.utils import fft as jfft
from nuradiomc_tpu.utils import geometry as jgeometry
from nuradiomc_tpu.ops import trace as jtrace
from nuradiomc_tpu_torch.detector.detector import Detector as TDetector
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.framework import parameters as tpar
from nuradiomc_tpu_torch.reco import analytic_efield as tanalytic
from nuradiomc_tpu_torch.reco import channel_processing as tcp
from nuradiomc_tpu_torch.reco import efield_converters as tec
from nuradiomc_tpu_torch.reco import examples
from nuradiomc_tpu_torch.utils import fft as tfft
from nuradiomc_tpu_torch.utils import geometry as tgeometry
from nuradiomc_tpu_torch.ops import trace as ttrace

RTOL = 1e-10
CPU = "cpu"


# simple_reconstruction.py's station, its two channels in one channel group
# (for the per-group unfolding)
DET = copy.deepcopy(examples.SIMPLE_DETECTOR)
for _c in DET["channels"].values():
    _c["channel_group_id"] = 0


class Pkg:
    def __init__(self, ev, par, det, cp, ec, analytic, kw):
        self.ev, self.par, self.det, self.cp, self.ec = ev, par, det, cp, ec
        self.analytic, self.kw = analytic, kw

    def make(self, module, cls, *args):
        return getattr(module, cls)(*args, **self.kw)


JAX = Pkg(jev, jpar, JDetector(DET), jcp, jec, janalytic, {})
PORT = Pkg(tev, tpar, TDetector(DET), tcp, tec, tanalytic, {"device": CPU})


def _chain(p):
    """The example's chain: fold, noise, band-pass, observables, unfold."""
    evt, station = examples.simple_event(p.ev, p.par)
    conv = p.make(p.ec, "efieldToVoltageConverter")
    conv.begin()
    conv.run(evt, station, p.det)
    folded = {c.get_id(): np.array(c.get_trace()) for c in station.iter_channels()}
    noise = p.make(p.cp, "channelGenericNoiseAdder")
    noise.begin(seed=42)
    noise.run(evt, station, p.det, amplitude=1e-6, type="rayleigh")
    bp = p.make(p.cp, "channelBandPassFilter")
    bp.run(evt, station, p.det, passband=[0.1, 0.5], filter_type="butter", order=4)
    rec = p.make(p.cp, "channelSignalReconstructor")
    rec.begin()
    rec.run(evt, station, p.det)
    unfold = p.make(p.ec, "voltageToEfieldConverter")
    unfold.begin()
    unfold.run(evt, station, p.det, use_channels=[0, 1])
    return evt, station, folded


@pytest.fixture(scope="module")
def chains():
    return _chain(JAX), _chain(PORT)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(np.max(np.abs(b)), 1e-300))


def test_example_chain_traces_and_observables(chains):
    (_, jst, jfold), (_, tst, tfold) = chains
    chp = jpar.channelParameters
    for cid in (0, 1):
        _close(tfold[cid], jfold[cid])
        a, b = tst.get_channel(cid), jst.get_channel(cid)
        assert a.get_trace_start_time() == b.get_trace_start_time()
        _close(a.get_trace(), b.get_trace())
        for key in ("maximum_amplitude", "maximum_amplitude_envelope", "P2P_amplitude",
                    "noise_rms"):
            np.testing.assert_allclose(a[getattr(tpar.channelParameters, key)],
                                       b[getattr(chp, key)], rtol=RTOL)
        assert a[tpar.channelParameters.signal_time] == b[chp.signal_time]
        sa, sb = a[tpar.channelParameters.SNR], b[chp.SNR]
        assert sorted(sa) == sorted(sb)
        for k in sb:
            np.testing.assert_allclose(sa[k], sb[k], rtol=RTOL)


def test_example_chain_unfolded_efield(chains):
    (_, jst, _), (_, tst, _) = chains
    a, b = tst.get_electric_fields()[-1], jst.get_electric_fields()[-1]
    _close(a.get_frequency_spectrum(), b.get_frequency_spectrum())
    assert a.get_trace_start_time() == b.get_trace_start_time()
    np.testing.assert_array_equal(a.get_position(), b.get_position())


def test_noise_is_the_same_draw():
    a = tcp.channelGenericNoiseAdder(device=CPU)
    b = jcp.channelGenericNoiseAdder()
    a.begin(seed=7)
    b.begin(seed=7)
    for kind in ("rayleigh", "perfect_white"):
        _close(a.bandlimited_noise(0.05, 0.4, 512, 2.0, 1e-3, kind).numpy(),
               b.bandlimited_noise(0.05, 0.4, 512, 2.0, 1e-3, kind))


def _noisy_station(p, n=512, fs=2.0, seed=3):
    rng = np.random.default_rng(seed)
    evt = p.ev.Event(0, 1)
    st = p.ev.Station(42)
    t = np.arange(n) / fs
    for cid in (0, 1):
        ch = p.ev.Channel(cid)
        tr = 0.1 * np.exp(-0.5 * ((t - 100.0 - 7 * cid) / 3.0) ** 2) * np.sin(0.9 * t)
        ch.set_trace(tr + rng.normal(0, 2e-3, n), fs, trace_start_time=3.0 * cid)
        st.add_channel(ch)
    evt.set_station(st)
    return evt, st


@pytest.mark.parametrize("case", ["resample_down", "resample_up", "cable_delay",
                                  "length", "adc_floor", "adc_counts", "hann", "fir",
                                  "rectangular"])
def test_channel_modules_match(case):
    out = []
    for p in (JAX, PORT):
        evt, st = _noisy_station(p)
        if case.startswith("resample"):
            m = p.make(p.cp, "channelResampler")
            m.run(evt, st, p.det, sampling_rate=1.0 if case == "resample_down" else 3.2)
        elif case == "cable_delay":
            m = p.make(p.cp, "channelAddCableDelay")
            m.run(evt, st, p.det, mode="subtract")
        elif case == "length":
            m = p.make(p.cp, "channelLengthAdjuster")
            m.begin(number_of_samples=128, offset=40)
            m.run(evt, st, p.det)
        elif case.startswith("adc"):
            m = p.make(p.cp, "analogToDigitalConverter")
            m.run(evt, st, p.det, adc_n_bits=8, adc_voltage_range=(-0.05, 0.05),
                  adc_sampling_frequency=1.0,
                  output="voltage" if case == "adc_floor" else "counts")
        else:
            m = p.make(p.cp, "channelBandPassFilter")
            kind = {"hann": "hann_tapered", "fir": "FIR hamming",
                    "rectangular": "rectangular"}[case]
            m.run(evt, st, p.det, passband=[0.1, 0.4], filter_type=kind, order=20)
        out.append([(c.get_sampling_rate(), c.get_trace_start_time(),
                     np.array(c.get_trace())) for c in st.iter_channels()])
    for (fa, ta, xa), (fb, tb, xb) in zip(out[1], out[0]):
        assert (fa, ta) == (fb, tb)
        if case.startswith("adc"):
            np.testing.assert_array_equal(xa, xb)
        else:
            _close(xa, xb)


def _efield_station(p, zen=np.deg2rad(60.0), az=np.deg2rad(30.0)):
    efp, stnp = p.par.electricFieldParameters, p.par.stationParameters
    evt, st = _noisy_station(p)
    sim = p.ev.SimStation(42)
    rng = np.random.default_rng(11)
    ef = p.ev.ElectricField([0, 1], position=[0.0, 0.0, -10.0])
    ef.set_trace(rng.normal(0, 1e-3, (3, 256)), 2.0, trace_start_time=12.0)
    ef[efp.zenith] = zen
    ef[efp.azimuth] = az
    ef[efp.ray_path_type] = "direct"
    sim.add_electric_field(ef)
    sim[stnp.zenith] = zen
    sim[stnp.azimuth] = az
    st.set_sim_station(sim)
    st[stnp.zenith] = zen
    st[stnp.azimuth] = az
    st.add_electric_field(ef)
    return evt, st


@pytest.mark.parametrize("case", ["per_efield", "per_group", "per_channel",
                                  "efield_reco", "efield_band", "efield_resample"])
def test_efield_modules_match(case):
    got = []
    for p in (JAX, PORT):
        evt, st = _efield_station(p)
        if case == "per_efield":
            m = p.make(p.ec, "efieldToVoltageConverterPerEfield")
            m.begin()
            m.run(evt, st, p.det)
            got.append([c.get_frequency_spectrum() for c in st.get_sim_station().iter_channels()])
        elif case == "per_group":
            m = p.make(p.ec, "voltageToEfieldConverterPerChannelGroup")
            m.begin()
            m.run(evt, st, p.det)
            got.append([st.get_electric_fields()[-1].get_frequency_spectrum()])
        elif case == "per_channel":
            m = p.make(p.ec, "voltageToEfieldConverterPerChannel")
            m.begin()
            m.run(evt, st, p.det, pol=0.3)
            # an antenna's cross-polarized VEL is zero up to rounding, and a
            # division by it is rounding: compare where |VEL| is above 1e-9
            # of its maximum
            ff = st.get_channel(0).get_frequencies()
            out = []
            for e in st.get_electric_fields()[1:]:
                cid = e.get_channel_ids()[0]
                vel = np.abs(np.asarray(jec.get_channel_vel(JAX.det, 42, cid, ff,
                                                            np.deg2rad(60.0),
                                                            np.deg2rad(30.0))))
                good = vel > 1e-9 * vel.max()
                out.append(np.asarray(e.get_frequency_spectrum())[1:][good])
            got.append(out)
        elif case == "efield_reco":
            m = p.make(p.ec, "electricFieldSignalReconstructor")
            m.begin()
            m.run(evt, st, p.det)
            ef = st.get_electric_fields()[0]
            efp = p.par.electricFieldParameters
            got.append([np.atleast_1d(ef[efp.signal_time]),
                        ef[efp.signal_energy_fluence],
                        np.atleast_1d(ef[efp.polarization_angle])])
        elif case == "efield_band":
            m = p.make(p.cp, "electricFieldBandPassFilter")
            m.run(evt, st, p.det, passband=[0.1, 0.4], filter_type="butter", order=6)
            got.append([st.get_electric_fields()[0].get_trace()])
        else:
            m = p.make(p.cp, "electricFieldResampler")
            m.run(evt, st, p.det, sampling_rate=3.0)
            got.append([st.get_electric_fields()[0].get_trace()])
    assert len(got[0]) == len(got[1]) > 0
    for a, b in zip(got[1], got[0]):
        _close(a, b)


@pytest.mark.parametrize("n_channels", [2, 3])
def test_stacked_lstsq_matches(n_channels):
    rng = np.random.default_rng(n_channels)
    L = rng.normal(size=(40, n_channels, 2)) + 1j * rng.normal(size=(40, n_channels, 2))
    b = rng.normal(size=(40, n_channels)) + 1j * rng.normal(size=(40, n_channels))
    _close(tec.stacked_lstsq(torch.as_tensor(L), torch.as_tensor(b)).numpy(),
           jec.stacked_lstsq(L, b))


def test_channel_vel_matches():
    ff = np.fft.rfftfreq(512, 0.5)
    zen = np.array([0.3, 1.2, 2.0])
    for cid in (0, 1):
        a = tec.get_channel_vel(PORT.det, 42, cid, ff, zen, 0.7, device=CPU)
        for i, z in enumerate(zen):
            b = jec.get_channel_vel(JAX.det, 42, cid, ff, z, 0.7)
            # both components at once: a cross-polarized VEL is rounding-level
            _close(np.stack([a[0][i].numpy(), a[1][i].numpy()]), np.stack(b))


def test_analytic_efield_fit_matches():
    """voltageToAnalyticEfieldConverter on a cosmic-ray-like pulse
    folded through four LPDAs: the same Nelder-Mead path in both packages."""
    results = []
    for p in (JAX, PORT):
        det = _four_lpda(p)
        evt, st = _cr_station(p, det)
        m = p.make(p.analytic, "voltageToAnalyticEfieldConverter")
        m.begin()
        ef = m.run(evt, st, det, use_channels=[0, 1, 2, 3],
                   bandpass=[80 * 1e-3, 300 * 1e-3])
        efp = p.par.electricFieldParameters
        results.append((np.array(ef.get_trace()), ef[efp.cr_spectrum_slope],
                        ef[efp.polarization_angle]))
    (ta, sa, pa), (tb, sb, pb) = results[1], results[0]
    np.testing.assert_allclose([sa, pa], [sb, pb], rtol=1e-8)
    _close(ta, tb, rtol=1e-8)


def _four_lpda(p):
    chans = {}
    for cid, (x, y) in enumerate([(3, 0), (0, 3), (-3, 0), (0, -3)]):
        chans[str(cid + 1)] = {
            "adc_n_samples": 256, "adc_sampling_frequency": 1.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": 180.0,
            "ant_position_x": x, "ant_position_y": y, "ant_position_z": -1.0,
            "ant_rotation_phi": 90.0 + 90.0 * (cid % 2), "ant_rotation_theta": 90.0,
            "ant_type": "analytic_LPDA", "amp_type": "", "cab_time_delay": 0.0,
            "adc_nbits": None, "channel_id": cid, "station_id": 7}
    d = {"channels": chans, "stations": {"1": {"station_id": 7, "pos_altitude": 0,
                                               "pos_easting": 0, "pos_northing": 0}}}
    return JDetector(d) if p is JAX else TDetector(d)


def _cr_station(p, det):
    stnp = p.par.stationParameters
    fs, n = 1.0, 256
    ff = np.fft.rfftfreq(n, 1 / fs)
    zen, az = np.deg2rad(40.0), np.deg2rad(70.0)
    pulse_t = janalytic.analytic_pulse_freq(2.0, -3.0, 0.0, n, fs, bandpass=[0.08, 0.3])
    pulse_p = janalytic.analytic_pulse_freq(6.0, -3.0, 0.0, n, fs, bandpass=[0.08, 0.3])
    evt = p.ev.Event(0, 3)
    st = p.ev.Station(7)
    rng = np.random.default_rng(5)
    for cid in range(4):
        vt, vp = jec.get_channel_vel(_four_lpda(JAX), 7, cid, ff, zen, az)
        V = (np.asarray(vt) * pulse_t + np.asarray(vp) * pulse_p) \
            * np.exp(-2j * np.pi * ff * 100.0)
        tr = jfft.freq2time(V, fs, n=n)
        ch = p.ev.Channel(cid)
        ch.set_trace(np.asarray(tr) + rng.normal(0, 1e-6, n), fs, trace_start_time=0.0)
        st.add_channel(ch)
    st[stnp.zenith] = zen
    st[stnp.azimuth] = az
    evt.set_station(st)
    return evt, st


def test_time_offset_calculator_matches():
    """channelTimeOffsetCalculator: the rays to each channel solved on the
    port's device in one batch, the ray-type hypothesis and offsets equal."""
    from test_vertex import _det_string, DEPTHS
    from nuradiomc_tpu.models import ice as jice
    from nuradiomc_tpu_torch.models import ice as tice

    jdet = _det_string()
    tdet = TDetector(_string_dict())
    results = []
    for p, det, ice in ((JAX, jdet, jice.get_ice_model("greenland_simple")),
                        (PORT, tdet, tice.get_ice_model("greenland_simple"))):
        fs, n = 2.0, 1024
        evt = p.ev.Event(0, 0)
        st = p.ev.Station(21)
        rng = np.random.default_rng(2)
        for cid in range(len(DEPTHS)):
            ch = p.ev.Channel(cid)
            t = np.arange(n) / fs
            ch.set_trace(0.1 * np.exp(-0.5 * ((t - 200 - 10 * cid) / 3) ** 2)
                         * np.sin(0.8 * t) + rng.normal(0, 1e-3, n), fs)
            st.add_channel(ch)
        st[p.par.stationParameters.nu_vertex] = np.array([300.0, 0.0, -400.0])
        evt.set_station(st)
        tpl = p.ev.Channel(0)
        tt = np.arange(512) / fs
        tpl.set_trace(np.exp(-0.5 * ((tt - 60) / 2.5) ** 2) * np.sin(2 * np.pi * 0.25 * tt), fs)
        m = p.make(p.cp, "channelTimeOffsetCalculator")
        m.begin(tpl, ice)
        best = m.run(evt, st, det, channel_ids=(0, 1, 2, 3), passband=(0.1, 0.5))
        chp = p.par.channelParameters
        results.append((best, [(st.get_channel(c)[chp.signal_time_offset],
                                st.get_channel(c)[chp.signal_receiving_zenith])
                               for c in range(4)]))
    assert results[0][0] == results[1][0]
    np.testing.assert_allclose(np.array(results[1][1]), np.array(results[0][1]),
                               rtol=1e-9, atol=1e-9)


def _string_dict():
    from test_vertex import DEPTHS
    chans = {}
    for cid, z in enumerate(DEPTHS):
        chans[str(cid + 1)] = {
            "adc_n_samples": 2048, "adc_sampling_frequency": 2.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
            "ant_position_x": 0.0, "ant_position_y": 0.0, "ant_position_z": z,
            "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
            "ant_type": "analytic_VPol", "amp_type": "", "cab_time_delay": 0.0,
            "adc_nbits": None, "channel_id": cid, "station_id": 21}
    return {"channels": chans, "stations": {"1": {"station_id": 21, "pos_altitude": 0,
                                                  "pos_easting": 0, "pos_northing": 0}}}


def test_completions_match():
    """utils/fft.freqs_np, the Fresnel transmission and the trace operations
    the reco modules use."""
    np.testing.assert_array_equal(tfft.freqs_np(512, 2.0), jfft.freqs_np(512, 2.0))
    zen = np.linspace(0.0, np.pi, 37)
    for name in ("fresnel_angle", "fresnel_t_p", "fresnel_t_s"):
        for n2, n1 in ((1.3, 1.0), (1.0, 1.3)):
            a = getattr(tgeometry, name)(torch.as_tensor(zen), n_2=n2, n_1=n1).numpy()
            b = np.asarray(getattr(jgeometry, name)(zen, n_2=n2, n_1=n1))
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=1e-12)
    rng = np.random.default_rng(9)
    tr = rng.normal(size=(3, 256))
    spec = np.fft.rfft(tr) / 2.0 * np.sqrt(2.0)
    ff = np.fft.rfftfreq(256, 0.5)
    _close(ttrace.shift_spectrum(torch.as_tensor(spec), torch.as_tensor(ff), 0.37).numpy(),
           np.asarray(jtrace.shift_spectrum(spec, ff, 0.37)))
    _close(ttrace.hilbert_envelope(torch.as_tensor(tr)).numpy(),
           np.asarray(jtrace.hilbert_envelope(tr)))
    for n_out in (128, 512):
        _close(ttrace.resample_spectrum(torch.as_tensor(spec), 256, n_out).numpy(),
               np.asarray(jtrace.resample_spectrum(jnp.asarray(spec), 256, n_out)))
