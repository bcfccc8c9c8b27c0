"""The port's trace statistics, ElectricField.get_stokes_parameters and
cleaning modules against the JAX package's, on the CPU in float64.

The same seeded numpy traces go through both packages (even and odd
lengths, since the Hilbert transform and the segment split treat them
differently). Closed forms and transforms agree to 1e-12 relative (traces to
1e-12 of their peak), the least-squares sine subtraction to 1e-9; the
cleaning modules keep the JAX package's sample counts and start times
exactly.
"""

import numpy as np
import pytest
import torch

from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.reco import cleaning as jcl
from nuradiomc_tpu.utils import trace_stats as jts
from nuradiomc_tpu_torch.detector.detector import Detector as TDetector
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.reco import cleaning as tcl
from nuradiomc_tpu_torch.utils import trace_stats as tts
from nuradiomc_tpu.detector.detector import Detector as JDetector

RTOL = 1e-12


def _pulse(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return rng.normal(0, 1.0, n) + 20 * np.exp(-0.5 * ((t - 0.45 * n) / 5.0) ** 2)


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.max(np.abs(want)))


@pytest.mark.parametrize("n", [4096, 4095])
@pytest.mark.parametrize("name, args", [
    ("get_split_trace_noise_RMS", ()), ("get_signal_to_noise_ratio", (1.0, 10)),
    ("get_impulsivity", ()), ("get_entropy", ()), ("get_kurtosis", ()),
    ("get_teager_kaiser_energy", ()), ("get_hilbert_envelope", ()),
    ("peak_to_peak_amplitudes", (7,)), ("peak_to_peak_amplitudes", (8,))])
def test_trace_statistic_matches(n, name, args):
    trace = _pulse(n)
    _close(getattr(tts, name)(torch.as_tensor(trace), *args), getattr(jts, name)(trace, *args))


def test_statistics_batch_over_leading_axes():
    traces = np.stack([_pulse(1000, s) for s in range(3)])
    got = tts.get_impulsivity(torch.as_tensor(traces)).numpy()
    _close(got, [jts.get_impulsivity(t) for t in traces])
    got = tts.get_split_trace_noise_RMS(torch.as_tensor(traces), 5, 3).numpy()
    _close(got, [jts.get_split_trace_noise_RMS(t, 5, 3) for t in traces])


def test_entropy_of_a_constant_trace():
    flat = np.zeros(512) + 1e-9
    _close(tts.get_entropy(torch.as_tensor(flat)), jts.get_entropy(flat))


def test_signal_to_noise_refuses_a_short_window():
    with pytest.raises(ValueError):
        tts.get_signal_to_noise_ratio(torch.zeros(16, dtype=torch.float64), 1.0, 1)


@pytest.mark.parametrize("use_envelope", [False, True])
def test_coherent_sum_matches(use_envelope):
    rng = np.random.default_rng(1)
    t = np.arange(2048)
    base = np.exp(-0.5 * ((t - 1000) / 4.0) ** 2) * np.sin(0.5 * t)
    traces = [np.roll(base, s) + rng.normal(0, 0.05, 2048) for s in (0, 37, -81, 140)]
    got = tts.get_coherent_sum(torch.as_tensor(np.array(traces[1:])),
                               torch.as_tensor(traces[0]), use_envelope)
    _close(got, jts.get_coherent_sum(traces[1:], traces[0], use_envelope))


@pytest.mark.parametrize("n", [512, 511])
@pytest.mark.parametrize("window", [None, 1, 64])
def test_stokes_match(n, window):
    rng = np.random.default_rng(2)
    u, v = rng.normal(size=n), rng.normal(size=n)
    got = tts.get_stokes(torch.as_tensor(u), torch.as_tensor(v), window_samples=window)
    _close(got, jts.get_stokes(u, v, window_samples=window))


@pytest.mark.parametrize("window", [None, 64])
def test_electric_field_stokes_parameters_match(window):
    """The satellite: ElectricField.get_stokes_parameters restored in the
    port's event data model, on the port's get_stokes."""
    n = 512
    t = np.arange(n)
    pulse = np.exp(-0.5 * ((t - 200) / 10.0) ** 2) * np.sin(2 * np.pi * t / 16)
    trace = np.vstack([np.zeros(n), pulse, 0.4 * np.roll(pulse, 3)])
    out = []
    for ev in (jev, tev):
        ef = ev.ElectricField([0, 1])
        ef.set_trace(trace, 0.2)
        out.append(np.asarray(ef.get_stokes_parameters(window_samples=window)))
    _close(out[1], out[0])


def _station(ev, n=2048, fs=2.0, trigger=False):
    t = np.arange(n) / fs
    rng = np.random.default_rng(0)
    evt, st = ev.Event(0, 0), ev.Station(3)
    for cid in range(3):
        ch = ev.Channel(cid)
        ch.set_trace(rng.normal(0, 0.01, n)
                     + 0.5 * np.sin(2 * np.pi * (0.2 + 0.05 * cid) * t + 0.7),
                     fs, trace_start_time=3.0)
        st.add_channel(ch)
    if trigger:
        trig = ev.Trigger("t", [0], pre_trigger_times=55.0)
        trig.set_triggered(True)
        trig.set_trigger_time(350.0)
        st.set_trigger(trig)
    evt.set_station(st)
    return evt, st


def _det(Detector, n_samples=128):
    chans = {str(c + 1): {
        "adc_n_samples": n_samples, "adc_sampling_frequency": 1.0,
        "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
        "ant_position_x": 0.0, "ant_position_y": 0.0, "ant_position_z": -1.0,
        "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
        "ant_type": "analytic_VPol", "amp_type": "", "cab_time_delay": 0.0,
        "adc_nbits": None, "channel_id": c, "station_id": 3} for c in range(3)}
    return Detector({"channels": chans, "stations": {"1": {"station_id": 3}}})


@pytest.mark.parametrize("name, begin, kw, rtol", [
    ("channelStopFilter", None, {}, RTOL),
    ("channelStopFilter", None, {"filter_size": 0.2, "prepend": 33.0, "append": 0.0}, RTOL),
    ("channelCWNotchFilter", {"threshold_db": 10}, {}, RTOL),
    ("channelCWNotchFilter", {"threshold_db": 6, "notch_halfwidth_bins": 4}, {}, RTOL),
    ("channelSinewaveSubtraction", {"cw_frequency": 0.2}, {}, 1e-9),
    ("channelTimeWindow", None, {"window": [100.0, 700.0]}, RTOL),
    ("channelReadoutWindowCutter", None, {}, RTOL)])
def test_cleaning_module_matches(name, begin, kw, rtol):
    out = []
    for ev, mod, Detector, dev in ((jev, jcl, JDetector, {}),
                                   (tev, tcl, TDetector, {"device": "cpu"})):
        evt, st = _station(ev, trigger=True)
        m = getattr(mod, name)(**dev)
        if begin:
            m.begin(**begin)
        m.run(evt, st, _det(Detector), **kw)
        out.append([(np.array(c.get_trace()), c.get_trace_start_time())
                    for c in st.iter_channels()])
    for (a, ta), (b, tb) in zip(*out):
        assert b.shape == a.shape and tb == ta
        _close(b, a, rtol)


def test_readout_window_cutter_pads_outside_the_trace():
    """A window that starts before the trace: zeros where it has no sample."""
    out = []
    for ev, mod, Detector, dev in ((jev, jcl, JDetector, {}),
                                   (tev, tcl, TDetector, {"device": "cpu"})):
        evt, st = _station(ev, n=256, trigger=True)
        st.get_trigger("t").set_trigger_time(10.0)
        getattr(mod, "channelReadoutWindowCutter")(**dev).run(evt, st, _det(Detector, 256))
        out.append([np.array(c.get_trace()) for c in st.iter_channels()])
    for a, b in zip(*out):
        np.testing.assert_array_equal(b, a)
