"""Analytic-pulse E-field reconstruction (cosmic-ray style, torch).

Counterpart of ``nuradiomc_tpu/reco/analytic_efield.py``, a re-implementation of NuRadioReco/modules/voltageToAnalyticEfieldConverter.py
(:240-731) and utilities/analytic_pulse.py (:30-121): instead of unfolding the
antenna response bin by bin (which amplifies noise where the gain is small),
the E-field is parameterized as an analytic frequency-domain pulse

    |E(f)| ~ A * 10^(slope*f + quad*(f-f0)^2),  phase(f) = p0 + p1*f

and the (amplitude_theta, amplitude_phi, slope, quadratic) parameters are fit
to ALL channels simultaneously by folding the candidate pulse through each
antenna response and comparing to the measured voltage traces. The antenna
responses and the channels' alignment are computed on the module's device;
the Nelder-Mead fits evaluate small numpy objectives on the host, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy import optimize, signal

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.framework.event import ElectricField
from nuradiomc_tpu_torch.ops import trace as trace_ops
from nuradiomc_tpu_torch.reco.base import Module, host, register_run, spectrum_tensor
from nuradiomc_tpu_torch.reco.direction import get_time_delay_from_direction
from nuradiomc_tpu_torch.reco.efield_converters import get_channel_vel
from nuradiomc_tpu_torch.utils import fft, units
from nuradiomc_tpu_torch.utils.constants import Z_0

stnp = par.stationParameters
efp = par.electricFieldParameters

# energy fluence <-> |E|^2 conversion: c * epsilon_0 = 1/Z_0
CONVERSION_FACTOR_INTEGRATED_SIGNAL = 1.0 / Z_0


def analytic_pulse_freq(amp_p0, amp_p1, phase_p0, n_samples_time, sampling_rate,
                        phase_p1=0.0, bandpass=None, quadratic_term=0.0,
                        quadratic_term_offset=0.0):
    """Frequency-domain analytic pulse (analytic_pulse.py:30-82).

    amp_p0 is the energy fluence of the pulse in internal units; the spectrum
    is normalized so that sum |E|^2 dt equals amp_p0 / (c eps_0) within the
    band, with a 10th-order analog butterworth band shape applied on top.
    """
    a0 = amp_p0 / CONVERSION_FACTOR_INTEGRATED_SIGNAL
    dt = 1.0 / sampling_rate
    ff = np.fft.rfftfreq(n_samples_time, dt)
    df = ff[1] - ff[0]
    A = np.sign(a0) * np.abs(a0) ** 0.5
    amps = A * 10 ** (ff * amp_p1 + quadratic_term * (ff - quadratic_term_offset) ** 2)
    if bandpass is None:
        norm = -1.0 / (2 * amp_p1 * np.log(10))
    elif amp_p1 == 0:
        norm = bandpass[1] - bandpass[0]
    else:
        norm = (100 ** (amp_p1 * bandpass[1]) - 100 ** (amp_p1 * bandpass[0])) \
            / (2 * amp_p1 * np.log(10))
    phases = phase_p0 + ff * phase_p1
    xx = amps * np.exp(1j * phases) / norm ** 0.5 / dt ** 0.5 * df ** 0.5
    if bandpass is not None:
        b, a = signal.butter(10, bandpass, "bandpass", analog=True)
        _, h = signal.freqs(b, a, ff)
        xx = xx * h
    return xx


def analytic_pulse(amp_p0, amp_p1, phase_p0, n_samples_time, sampling_rate,
                   **kwargs):
    """Time-domain analytic pulse (analytic_pulse.py:84-121)."""
    xx = analytic_pulse_freq(amp_p0, amp_p1, phase_p0, n_samples_time,
                             sampling_rate, **kwargs)
    return _freq2time(xx, sampling_rate, n_samples_time)


def _freq2time(spec, fs, n):
    """numpy twin of utils.fft.freq2time (hot path of the Nelder-Mead loop)."""
    return np.fft.irfft(spec, n=n) * fs / np.sqrt(2.0)


def normalized_xcorr(a, b):
    """Full cross-correlation normalized by the trace norms
    (radiotools.helper.get_normalized_xcorr semantics)."""
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    if denom == 0:
        return np.zeros(len(a) + len(b) - 1)
    return np.correlate(a, b, mode="full") / denom


class voltageToAnalyticEfieldConverter(Module):
    """Fit an analytic E-field pulse to the measured voltages of several
    channels at once (voltageToAnalyticEfieldConverter.py:240-731).

    Fit sequence mirrors the reference: (1) spectral slope via the maximum
    normalized cross-correlation (amplitude-free), (2) pulse position from
    the best-correlating channel, (3) phi amplitude, then (phi, theta)
    amplitudes, (4) joint (amp_phi, amp_theta, slope) on Hilbert envelopes,
    (5) quadratic spectral correction.
    """

    def begin(self, antenna_replacements=None):
        self._reps = antenna_replacements or {}

    @register_run()
    def run(self, evt, station, det, use_channels=None, bandpass=None,
            use_MC_direction=False, n_index=1.0, noise_RMS=0.01 * units.mV):
        if use_channels is None:
            use_channels = [0, 1, 2, 3]
        if bandpass is None:
            bandpass = [100 * units.MHz, 500 * units.MHz]
        station_id = station.get_id()
        src = station.get_sim_station() if use_MC_direction else station
        zenith = src[stnp.zenith]
        azimuth = src[stnp.azimuth]

        fs = station.get_channel(use_channels[0]).get_sampling_rate()
        n_t = min(station.get_channel(c).get_number_of_samples()
                  for c in use_channels)
        n_t -= n_t % 2
        ff = np.fft.rfftfreq(n_t, 1.0 / fs)

        # time-align channels to a common pulse position and collect the
        # per-channel on-sky antenna factors (get_array_of_channels equivalent)
        V_time = np.zeros((len(use_channels), n_t))
        factor = np.zeros((len(use_channels), 2, len(ff)), dtype=complex)
        ff_t = self.tensor(ff)
        for i, cid in enumerate(use_channels):
            ch = station.get_channel(cid)
            pos = det.get_relative_position(station_id, cid)
            tau = (get_time_delay_from_direction(zenith, azimuth, pos, n=n_index)
                   + det.get_cable_delay(station_id, cid)
                   - ch.get_trace_start_time())
            spec = spectrum_tensor(ch, self.device)[:len(ff)]
            V_time[i] = host(fft.freq2time(trace_ops.shift_spectrum(spec, ff_t, -tau),
                                           fs, n=n_t))
            vt, vp = get_channel_vel(det, station_id, cid, ff, zenith, azimuth,
                                     self._reps, device=self.device)
            factor[i, 0], factor[i, 1] = host(vt), host(vp)

        def fold(pulse_theta, pulse_phi):
            spec = factor[:, 0] * pulse_theta + factor[:, 1] * pulse_phi
            return np.fft.irfft(spec, n=n_t, axis=-1) * fs / np.sqrt(2.0)

        def obj_xcorr(params):
            slope = params[0]
            p_phi = analytic_pulse_freq(1.0, slope, 0.0, n_t, fs, bandpass=bandpass)
            traces = fold(np.zeros_like(p_phi), p_phi)
            return -sum(np.abs(normalized_xcorr(V_time[i], traces[i])).max()
                        for i in range(len(use_channels)))

        res = optimize.minimize(obj_xcorr, x0=[-1.0], method="Nelder-Mead",
                                options={"maxiter": 1000})
        slope = float(res.x[0])
        if slope > 0 or slope < -50:   # same sanity clamp as reference (:518)
            slope = -1.9

        # pulse position from the channel with the highest correlation
        p_phi = analytic_pulse_freq(1.0, slope, 0.0, n_t, fs, bandpass=bandpass)
        traces = fold(np.zeros_like(p_phi), p_phi)
        best, pos = -1.0, 0
        for i in range(len(use_channels)):
            xc = np.abs(normalized_xcorr(V_time[i], traces[i]))
            if xc.max() > best:
                best, pos = xc.max(), int(np.argmax(xc)) + 1

        argmax = int(np.argmax(np.abs(V_time)) % n_t)
        imin = max(int(argmax - 50 * fs), 0)
        imax = int(argmax + 50 * fs)

        def chi2(amp_theta, amp_phi, slp, quad=0.0, compare="hilbert"):
            kw = dict(bandpass=bandpass)
            if quad:
                kw.update(quadratic_term=quad, quadratic_term_offset=bandpass[0])
            pt = analytic_pulse_freq(amp_theta, slp, 0.0, n_t, fs, **kw)
            pp = analytic_pulse_freq(amp_phi, slp, 0.0, n_t, fs, **kw)
            ana = fold(pt, pp)
            tot = 0.0
            for i in range(len(use_channels)):
                a = np.roll(ana[i], pos)[imin:imax]
                m = V_time[i][imin:imax]
                if compare == "hilbert":
                    d = np.abs(signal.hilbert(m)) - np.abs(signal.hilbert(a))
                else:
                    d = m - a
                tot += np.sum(np.abs(d) ** 2) / noise_RMS ** 2
            return tot

        r1 = optimize.minimize(lambda p: chi2(0.0, p[0], slope), x0=[1e-3],
                               method="Nelder-Mead", options={"maxiter": 1000})
        r2 = optimize.minimize(lambda p: chi2(p[1], p[0], slope),
                               x0=[r1.x[0], 0.0], method="Nelder-Mead",
                               options={"maxiter": 1000})
        r3 = optimize.minimize(lambda p: chi2(p[1], p[0], p[2]),
                               x0=[r2.x[0], r2.x[1], slope],
                               method="Nelder-Mead", options={"maxiter": 1000})
        amp_phi, amp_theta, slope = float(r3.x[0]), float(r3.x[1]), float(r3.x[2])
        r4 = optimize.minimize(lambda p: chi2(p[1], p[0], slope, quad=p[2]),
                               x0=[amp_phi, amp_theta, 0.0],
                               method="Nelder-Mead", options={"maxiter": 1000})
        quad = float(r4.x[2])

        e_theta = np.roll(analytic_pulse(amp_theta, slope, 0.0, n_t, fs,
                                         bandpass=bandpass), pos)
        e_phi = np.roll(analytic_pulse(amp_phi, slope, 0.0, n_t, fs,
                                       bandpass=bandpass), pos)
        ef = ElectricField(use_channels)
        ef.set_trace(np.array([np.zeros_like(e_theta), e_theta, e_phi]), fs)
        dt = 1.0 / fs
        fluence = np.sum(ef.get_trace() ** 2, axis=1) * dt \
            * CONVERSION_FACTOR_INTEGRATED_SIGNAL
        ef[efp.signal_energy_fluence] = fluence
        ef[efp.cr_spectrum_slope] = slope
        ef[efp.cr_spectrum_quadratic_term] = quad
        ef[efp.zenith] = zenith
        ef[efp.azimuth] = azimuth
        x = np.sign(amp_theta) * np.abs(amp_theta) ** 0.5
        y = np.sign(amp_phi) * np.abs(amp_phi) ** 0.5
        ef[efp.polarization_angle] = np.arctan2(abs(y), abs(x))
        station.add_electric_field(ef)
        return ef

