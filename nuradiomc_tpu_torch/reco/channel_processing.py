"""Per-channel processing modules (framework-object API, torch).

Counterpart of ``nuradiomc_tpu/reco/channel_processing.py`` (reference
modules/channelBandPassFilter.py, channelResampler.py,
channelAddCableDelay.py, channelGenericNoiseAdder.py,
channelSignalReconstructor.py, channelLengthAdjuster.py,
analogToDigitalConverter.py, eventTypeIdentifier.py,
channelTimeOffsetCalculator.py, measured_noise/channelMeasuredNoiseAdder.py).
The FFTs, filter products, resampling, envelopes, the ADC and the ray solve
of the time-offset calculator run on the module's device; random numbers
are drawn on the host from numpy's generator, as in the JAX package, so a
seed gives the same noise on every device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.ops import adc as adc_ops
from nuradiomc_tpu_torch.ops import filters as filter_ops
from nuradiomc_tpu_torch.ops import trace as trace_ops
from nuradiomc_tpu_torch.reco.base import (Module, host, register_run, spectrum_tensor,
                                           trace_tensor)
from nuradiomc_tpu_torch.utils import fft, units

chp = par.channelParameters


def _filter_spectrum(module, bt, passband, filter_type, order, rp, roll_width):
    """bt's spectrum times the filter response, on the module's device."""
    spec = spectrum_tensor(bt, module.device)
    ff = bt.get_frequencies()
    filt = filter_ops.get_filter_response(ff, passband, filter_type, order=order,
                                          rp=rp, roll_width=roll_width)
    return host(spec * module.tensor(filt))


class channelBandPassFilter(Module):
    """Frequency-domain bandpass (channelBandPassFilter.py:140-340)."""

    def get_filter(self, frequencies, station_id, channel_id, det, passband,
                   filter_type, order=2, rp=None, roll_width=2.5 * units.MHz,
                   half_hann_percent=None):
        return filter_ops.get_filter_response(frequencies, passband, filter_type,
                                              order=order, rp=rp,
                                              roll_width=roll_width)

    @register_run()
    def run(self, evt, station, det, passband, filter_type="rectangular",
            order=2, rp=None, roll_width=2.5 * units.MHz, half_hann_percent=0.1):
        for channel in station.iter_channels():
            fs = channel.get_sampling_rate()
            if filter_type == "hann_tapered":
                # only the half-Hann taper of the trace ends: the reference
                # applies no band here (channelBandPassFilter.py:242-246)
                tr = trace_tensor(channel, self.device)
                win = half_hann_window(tr.shape[-1], half_hann_percent)
                channel.set_trace(host(tr * self.tensor(win)), fs)
                continue
            if isinstance(filter_type, str) and filter_type.startswith("FIR"):
                # firwin taps + lfilter + group-delay roll on the host, exactly
                # channelBandPassFilter.py:247-290
                from scipy import signal as scisig
                taps = filter_ops.fir_taps(passband, filter_type, order, fs)
                out = scisig.lfilter(taps, [1.0], np.asarray(channel.get_trace()))
                channel.set_trace(np.roll(out, -((len(taps) - 1) // 2)), fs)
                continue
            channel.set_frequency_spectrum(
                _filter_spectrum(self, channel, passband, filter_type, order, rp,
                                 roll_width), fs)


# copied from nuradiomc_tpu/reco/channel_processing.py:74-86
def half_hann_window(length, half_percent=None, hann_window_length=None):
    """Window = ones with half-Hann ramps on both ends
    (signal_processing.half_hann_window:44-67)."""
    from scipy.signal.windows import hann
    if half_percent is not None:
        hann_window_length = int(length * half_percent)
    hw = hann(2 * hann_window_length)
    win = np.ones(length, dtype=float)
    win[:hann_window_length] = hw[:hann_window_length]
    win[-hann_window_length:] = hw[hann_window_length:]
    return win


class electricFieldBandPassFilter(channelBandPassFilter):
    @register_run()
    def run(self, evt, station, det, passband, filter_type="rectangular",
            order=2, rp=None, roll_width=2.5 * units.MHz, half_hann_percent=None):
        for efield in station.get_electric_fields():
            efield.set_frequency_spectrum(
                _filter_spectrum(self, efield, passband, filter_type, order, rp,
                                 roll_width), efield.get_sampling_rate())


def _resample(module, bt, sampling_rate):
    """BaseTrace.resample (scipy.signal.resample) on the module's device."""
    if sampling_rate == bt.get_sampling_rate():
        return
    n_in = bt.get_number_of_samples()
    n_out = int(round(n_in * sampling_rate / bt.get_sampling_rate()))
    if n_out % 2 != 0:
        n_out += 1
    tr = trace_ops.scipy_resample(trace_tensor(bt, module.device), n_out)
    bt.set_trace(host(tr), sampling_rate)


class channelResampler(Module):
    """FFT resampling of channel traces (modules/channelResampler.py)."""

    def begin(self, debug=False):
        pass

    @register_run()
    def run(self, evt, station, det, sampling_rate):
        for channel in station.iter_channels():
            _resample(self, channel, sampling_rate)


class electricFieldResampler(Module):
    @register_run()
    def run(self, evt, station, det, sampling_rate):
        for efield in station.get_electric_fields():
            _resample(self, efield, sampling_rate)


class channelAddCableDelay(Module):
    """Apply/undo cable delays as trace-start-time shifts
    (modules/channelAddCableDelay.py)."""

    @register_run()
    def run(self, evt, station, det, mode="add"):
        sign = 1.0 if mode == "add" else -1.0
        for channel in station.iter_channels():
            delay = det.get_cable_delay(station.get_id(), channel.get_id())
            channel.add_trace_start_time(sign * delay)


class channelGenericNoiseAdder(Module):
    """Band-limited noise in the rFFT domain
    (modules/channelGenericNoiseAdder.py:66-160): amplitudes and phases drawn
    on the host (numpy Philox, as the JAX package), the transform and the sum
    on the device."""

    def begin(self, debug=False, seed=None):
        self._rng = np.random.Generator(np.random.Philox(seed))

    def bandlimited_noise(self, min_freq, max_freq, n_samples, sampling_rate,
                          amplitude, type="perfect_white", time_domain=True,
                          bandwidth=None):
        frequencies = np.fft.rfftfreq(n_samples, 1.0 / sampling_rate)
        if min_freq is None or min_freq == 0:
            min_freq = 0.5 * (frequencies[2] - frequencies[1])
        if max_freq is None:
            max_freq = frequencies[-1]
        selection = (frequencies >= min_freq) & (frequencies <= max_freq)
        nbins = int(np.sum(selection))
        if bandwidth is not None:
            sampling_bandwidth = min(0.5 * sampling_rate, max_freq) - min_freq
            amplitude = amplitude / (bandwidth / sampling_bandwidth) ** 0.5
        ampl = np.zeros(len(frequencies))
        sigscale = n_samples / np.sqrt(nbins)
        if type == "perfect_white":
            ampl[selection] = amplitude * sigscale
        elif type == "rayleigh":
            fsigma = amplitude * sigscale / np.sqrt(2.0)
            ampl[selection] = self._rng.rayleigh(fsigma, nbins)
        else:
            raise NotImplementedError(type)
        # random phases on bins 1..(n-1)//2 (add_random_phases:15-32)
        amps = ampl.astype(complex)
        Np = (n_samples - 1) // 2
        phases = np.exp(1j * self._rng.random(Np) * 2 * np.pi)
        amps[1:Np + 1] *= phases
        noise = self.tensor(amps / sampling_rate)
        if time_domain:
            return (torch.fft.irfft(noise, n=n_samples) * sampling_rate
                    / math.sqrt(2.0))
        return noise

    @register_run()
    def run(self, evt, station, det, amplitude, min_freq=None, max_freq=None,
            type="rayleigh", excluded_channels=None):
        excluded = set(excluded_channels or [])
        for channel in station.iter_channels():
            if channel.get_id() in excluded:
                continue
            amp = amplitude[channel.get_id()] if isinstance(amplitude, dict) else amplitude
            noise = self.bandlimited_noise(min_freq, max_freq,
                                           channel.get_number_of_samples(),
                                           channel.get_sampling_rate(), amp, type)
            channel.set_trace(host(trace_tensor(channel, self.device) + noise),
                              channel.get_sampling_rate())


class channelSignalReconstructor(Module):
    """Per-channel observables: max amplitude, envelope max, signal time, SNR
    (modules/channelSignalReconstructor.py:69-261); the Hilbert envelope on
    the device."""

    def begin(self, signal_window_start=None, signal_window_length=120 * units.ns,
              noise_window_start=None, noise_window_length=None):
        self._sig_start = signal_window_start
        self._sig_len = signal_window_length
        self._noise_start = noise_window_start
        self._noise_len = noise_window_length

    def get_SNR(self, station_id, channel, det):
        trace = np.asarray(channel.get_trace())
        times = channel.get_times() - channel.get_trace_start_time()
        if self._sig_start is not None:
            sig_start = self._sig_start
        else:
            sig_start = times[np.argmax(np.abs(trace))] - 0.5 * self._sig_len
        sig_mask = (times > sig_start) & (times < sig_start + self._sig_len)
        if self._noise_start is not None and self._noise_len is not None:
            noise_mask = ((times > self._noise_start)
                          & (times < self._noise_start + self._noise_len))
            noise_len = self._noise_len
        else:
            noise_mask = ~sig_mask
            noise_len = np.sum(noise_mask) / channel.get_sampling_rate()

        noise_int = np.sum(np.square(trace[noise_mask]))
        if noise_len > 0:
            noise_int *= self._sig_len / float(noise_len)
        noise_rms = (np.sqrt(np.mean(np.square(trace[noise_mask])))
                     if np.any(noise_mask) else 0.0)

        snr = {}
        if noise_rms == 0 or noise_int == 0:
            snr["peak_2_peak_amplitude"] = 0
            snr["peak_amplitude"] = 0
            snr["integrated_power"] = 0
        else:
            snr["integrated_power"] = max(np.sum(np.square(trace[sig_mask])) - noise_int,
                                          0) / noise_int if noise_int else 0
            amp_p2p = np.max(trace[sig_mask]) - np.min(trace[sig_mask])
            snr["peak_2_peak_amplitude"] = amp_p2p / noise_rms / 2
            snr["peak_amplitude"] = np.max(np.abs(trace[sig_mask])) / noise_rms
        snr["Seckel_2_noise"] = 5
        return snr, noise_rms

    @register_run()
    def run(self, evt, station, det=None):
        for channel in station.iter_channels():
            trace = trace_tensor(channel, self.device)
            times = channel.get_times()
            h = trace_ops.hilbert_envelope(trace)
            channel[chp.signal_time] = times[int(torch.argmax(h))]
            channel[chp.maximum_amplitude] = float(torch.max(torch.abs(trace)))
            channel[chp.maximum_amplitude_envelope] = float(h.max())
            channel[chp.P2P_amplitude] = float(trace.max() - trace.min())
            snr, noise_rms = self.get_SNR(station.get_id(), channel, det)
            channel[chp.SNR] = snr
            channel[chp.noise_rms] = noise_rms


class channelLengthAdjuster(Module):
    """Cut/pad channel traces to a fixed length (modules/channelLengthAdjuster.py)."""

    def begin(self, number_of_samples=256, offset=50):
        self.number_of_samples = number_of_samples
        self.offset = offset

    @register_run()
    def run(self, evt, station, det=None, channel_ids=None):
        for channel in station.iter_channels(channel_ids):
            trace = channel.get_trace()
            n = self.number_of_samples
            imax = int(np.argmax(np.abs(trace)))
            start = max(imax - self.offset, 0)
            if start + n > len(trace):
                start = max(len(trace) - n, 0)
            cut = trace[start:start + n]
            if len(cut) < n:
                cut = np.pad(cut, (0, n - len(cut)))
            t0 = channel.get_trace_start_time() + start / channel.get_sampling_rate()
            channel.set_trace(cut, channel.get_sampling_rate(), trace_start_time=t0)


class analogToDigitalConverter(Module):
    """Perfect comparator ADC on channel traces
    (modules/analogToDigitalConverter.py:14-479), on the device."""

    @register_run()
    def run(self, evt, station, det, adc_n_bits=None, adc_voltage_range=None,
            adc_sampling_frequency=None, output="voltage", mode="floor"):
        for channel in station.iter_channels():
            fs = channel.get_sampling_rate()
            if adc_sampling_frequency is not None and adc_sampling_frequency != fs:
                _resample(self, channel, adc_sampling_frequency)
                fs = adc_sampling_frequency
            trace = trace_tensor(channel, self.device)
            v_min, v_max = adc_voltage_range
            lsb = (v_max - v_min) / (2 ** adc_n_bits - 1)
            counts = adc_ops.quantize_counts(trace, v_min, lsb, 2 ** adc_n_bits, mode)
            out = counts * lsb if output == "voltage" else counts
            channel.set_trace(host(out), fs)


class eventTypeIdentifier(Module):
    """Tag events as neutrino/cosmic-ray (modules/eventTypeIdentifier.py)."""

    @register_run()
    def run(self, evt, station, det=None, mode="forced", forced_event_type="neutrino"):
        if mode == "forced":
            sim = station.get_sim_station() if hasattr(station, "get_sim_station") else None
            if sim is not None and sim is not False:
                if forced_event_type == "neutrino" and hasattr(sim, "set_is_neutrino"):
                    sim.set_is_neutrino()
                elif forced_event_type == "cosmic_ray" and hasattr(sim, "set_is_cosmic_ray"):
                    sim.set_is_cosmic_ray()
        return forced_event_type


class channelMeasuredNoiseAdder(Module):
    """Superimpose measured noise waveforms from .nur files onto simulated
    channels (measured_noise/channelMeasuredNoiseAdder.py:28-276): noise
    events loaded once in begin(), one picked per run() (numpy generator on
    the host), optionally baseline-subtracted, trimmed or wrapped to the
    channel's length and added."""

    def begin(self, filenames=None, folder=None, file_pattern="*",
              random_seed=None, channel_mapping=None,
              baseline_substraction=True, restrict_station_id=True,
              station_id=None):
        import glob

        from nuradiomc_tpu_torch.sim import io_nur

        if filenames is None:
            filenames = sorted(glob.glob(f"{folder}/**/{file_pattern}.nur",
                                         recursive=True))
        if not filenames:
            raise ValueError("no noise files found")
        self._rng = np.random.Generator(np.random.Philox(random_seed))
        self._mapping = channel_mapping or {}
        self._baseline = baseline_substraction
        self._noise = []   # list of {channel_id: (trace, fs)} per event
        for fn in filenames:
            for evt in io_nur.EventReader(fn).run():
                for st in evt.get_stations():
                    if (restrict_station_id and station_id is not None
                            and st.get_id() != station_id):
                        continue
                    entry = {ch.get_id(): (np.asarray(ch.get_trace(), dtype=float),
                                           ch.get_sampling_rate())
                             for ch in st.iter_channels()}
                    if entry:
                        self._noise.append(entry)
        if not self._noise:
            raise ValueError("no usable noise stations in the input files")

    @register_run()
    def run(self, event, station, det=None):
        entry = self._noise[self._rng.integers(len(self._noise))]
        for ch in station.iter_channels():
            src_id = self._mapping.get(ch.get_id(), ch.get_id())
            if src_id not in entry:
                continue
            noise, _ = entry[src_id]
            if self._baseline:
                noise = noise - np.mean(noise)
            tr = np.asarray(ch.get_trace())
            n = len(tr)
            if len(noise) < n:
                noise = np.tile(noise, int(np.ceil(n / len(noise))))
            start = self._rng.integers(0, len(noise) - n + 1)
            ch.set_trace(tr + noise[start:start + n], ch.get_sampling_rate())


class channelTimeOffsetCalculator(Module):
    """Ray-path type (direct/refracted/reflected) and per-channel propagation
    time offsets from a vertex (modules/channelTimeOffsetCalculator.py:32-163).

    The rays to every channel are solved on the device in one batch; for each
    ray-type hypothesis the channels are shifted back by the expected
    (mean-subtracted) propagation times and correlated with an antenna-folded
    E-field template; the hypothesis with the largest summed correlation wins
    and its offsets and receive angles are stored per channel.
    """

    def begin(self, electric_field_template, medium, use_sim=False,
              antenna_replacements=None, amp_response=None):
        self._template = electric_field_template
        self._medium = medium
        self._use_sim = use_sim
        self._reps = antenna_replacements or {}
        self._amp = amp_response    # optional callable(freqs) -> complex

    @register_run()
    def run(self, event, station, det, channel_ids=(0, 1, 2, 3), passband=None):
        from nuradiomc_tpu_torch.ops import raytrace
        from nuradiomc_tpu_torch.reco.analytic_efield import normalized_xcorr
        from nuradiomc_tpu_torch.reco.efield_converters import get_channel_vel

        stnp_ = par.stationParameters
        shp_ = par.showerParameters
        ray_names = ["direct", "refracted", "reflected"]

        vertex = None
        if self._use_sim:
            for shower in event.get_sim_showers():
                if shower.has_parameter(shp_.vertex):
                    vertex = np.asarray(shower[shp_.vertex])
                    break
        elif station.has_parameter(stnp_.nu_vertex):
            vertex = np.asarray(station[stnp_.nu_vertex])
        elif station.has_parameter(stnp_.vertex_2D_fit):
            v2 = station[stnp_.vertex_2D_fit]
            vertex = np.array([v2[0], 0.0, v2[1]])
        if vertex is None:
            raise RuntimeError("Could not find vertex position")

        A = len(channel_ids)
        positions = np.array([det.get_relative_position(station.get_id(), cid)
                              for cid in channel_ids], dtype=float)
        geom = raytrace.to_2d(self.tensor(np.broadcast_to(np.asarray(vertex, float),
                                                          (A, 3)).copy()),
                              self.tensor(positions))
        sols = raytrace.find_solutions(geom.x1y, geom.x1z, geom.x2y, geom.x2z,
                                       self._medium)
        _, receive = raytrace.launch_receive_vectors(geom, sols)
        mask, sol_type, tt = host(sols.mask), host(sols.sol_type), host(sols.travel_time)
        receive = host(receive)

        prop_times = np.zeros((A, 3))
        rec_zeniths = np.zeros((A, 3))
        found = np.zeros((A, 3), dtype=bool)
        for i in range(A):
            for s in range(2):
                if not bool(mask[i, s]):
                    continue
                st_idx = int(sol_type[i, s]) - 1
                found[i, st_idx] = True
                prop_times[i, st_idx] = float(tt[i, s])
                rec_zeniths[i, st_idx] = np.arccos(np.clip(-receive[i, s, 2], -1, 1))

        for s in range(3):
            sel = prop_times[:, s] > 0
            if sel.any():
                prop_times[sel, s] -= np.mean(prop_times[sel, s])

        ff = np.asarray(self._template.get_frequencies())
        fs = self._template.get_sampling_rate()
        band = np.ones(len(ff), dtype=complex)
        if passband is not None:
            band = filter_ops.get_filter_response(ff, passband, "butter", order=10)
        e_spec = spectrum_tensor(self._template, self.device) * self.tensor(band)
        amp = self.tensor(self._amp(ff)) if self._amp is not None else 1.0

        # sum the correlation FUNCTIONS across channels: only the correct
        # hypothesis aligns the peaks at the same lag (reference :126-156)
        corr_sum = None
        for i, cid in enumerate(channel_ids):
            ch = station.get_channel(cid)
            ch_ff = np.asarray(ch.get_frequencies())
            ch_band = np.ones(len(ch_ff), dtype=complex)
            if passband is not None:
                ch_band = filter_ops.get_filter_response(ch_ff, passband, "butter",
                                                         order=10)
            ch_spec = spectrum_tensor(ch, self.device) * self.tensor(ch_band)
            ch_ff_t = self.tensor(ch_ff)
            for s in range(3):
                if not found[i, s]:
                    continue
                vt, vp = get_channel_vel(det, station.get_id(), cid, ff,
                                         rec_zeniths[i, s], 0.0, self._reps,
                                         device=self.device)
                tpl = fft.freq2time(e_spec * amp * (vt + vp), fs)
                # undo the expected propagation delay for this hypothesis
                shifted = trace_ops.shift_spectrum(ch_spec, ch_ff_t, -prop_times[i, s])
                tr = fft.freq2time(shifted, ch.get_sampling_rate())
                xc = np.abs(normalized_xcorr(host(tr), host(tpl)))
                if corr_sum is None:
                    corr_sum = np.zeros((3, len(xc)))
                corr_sum[s, :len(xc)] += xc

        best = int(np.argmax(np.max(corr_sum, axis=1)))
        for i, cid in enumerate(channel_ids):
            ch = station.get_channel(cid)
            ch[chp.signal_time_offset] = prop_times[i, best]
            ch[chp.signal_receiving_zenith] = rec_zeniths[i, best]
            ch[chp.signal_ray_type] = ray_names[best]
        return ray_names[best]
