"""Data-cleaning and readout modules (torch).

Counterpart of ``nuradiomc_tpu/reco/cleaning.py``; each module works on all
channels of a station at once, as one [channels, samples] tensor on its
device (channels of one length and sampling rate together):

* channelStopFilter: Tukey-window taper + zero padding (modules/
  channelStopFilter.py:26-55);
* channelCWNotchFilter: notch out continuous-wave lines found as narrow
  peaks above the running median of the power spectrum;
* channelSinewaveSubtraction: fit & subtract one CW line, a batched least
  squares;
* channelReadoutWindowCutter: cut traces to the detector readout window
  around the trigger time (modules/channelReadoutWindowCutter.py:28-120);
* channelTimeWindow: zero the traces outside a time window.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import signal as scsig

from nuradiomc_tpu_torch.reco.base import (Module, host, register_run, same_grid,
                                           stack_spectra, stack_traces)
from nuradiomc_tpu_torch.utils import units


class channelStopFilter(Module):

    @register_run()
    def run(self, evt, station, det=None, filter_size=0.1,
            prepend=128 * units.ns, append=128 * units.ns):
        for channels in same_grid(station.iter_channels()):
            fs = channels[0].get_sampling_rate()
            traces = stack_traces(channels, self.device)
            n = traces.shape[-1]
            traces = traces * self.tensor(scsig.windows.tukey(n, filter_size))
            n_pre = int(round(prepend * fs))
            n_app = int(round(append * fs))
            traces = torch.nn.functional.pad(traces, (n_pre, n_app))
            if traces.shape[-1] % 2 == 1:
                traces = traces[:, :-1]
            out = host(traces)
            for channel, trace in zip(channels, out):
                channel.set_trace(
                    trace, fs, trace_start_time=channel.get_trace_start_time() - n_pre / fs)


class channelCWNotchFilter(Module):
    """Detect narrow spectral lines above the local median and notch them."""

    MEDIAN_KERNEL = 31

    def begin(self, threshold_db: float = 10.0, notch_halfwidth_bins: int = 2):
        self._threshold = 10 ** (threshold_db / 10.0)
        self._hw = notch_halfwidth_bins

    @register_run()
    def run(self, evt, station, det=None):
        for channels in same_grid(station.iter_channels()):
            fs = channels[0].get_sampling_rate()
            spec = stack_spectra(channels, self.device)
            power = torch.abs(spec) ** 2
            # scipy.signal.medfilt(power, 31): zero padding at both ends, the
            # middle of each sorted window
            k = self.MEDIAN_KERNEL
            windows = torch.nn.functional.pad(power, (k // 2, k // 2)).unfold(-1, k, 1)
            med = torch.sort(windows, -1).values[..., k // 2]
            peaks = power > self._threshold * torch.clamp(med, min=1e-300)
            # zero [p - hw, p + hw] around every peak p (clipped at the ends)
            hit = torch.nn.functional.max_pool1d(peaks[:, None].to(spec.real.dtype),
                                                 2 * self._hw + 1, 1, self._hw)[:, 0] > 0
            out = host(torch.where(hit, torch.zeros_like(spec), spec))
            for channel, s in zip(channels, out):
                channel.set_frequency_spectrum(s, fs)


class channelSinewaveSubtraction(Module):
    """Fit amplitude/phase of a known-frequency sinusoid and subtract it."""

    def begin(self, cw_frequency):
        self._freq = cw_frequency

    @register_run()
    def run(self, evt, station, det=None):
        for channels in same_grid(station.iter_channels()):
            fs = channels[0].get_sampling_rate()
            traces = stack_traces(channels, self.device)
            t = self.tensor(np.array([c.get_times() for c in channels]))
            arg = 2 * np.pi * self._freq * t
            A = torch.stack([torch.cos(arg), torch.sin(arg)], -1)        # [C, n, 2]
            coeffs = torch.linalg.lstsq(A, traces[..., None]).solution
            out = host(traces - (A @ coeffs)[..., 0])
            for channel, trace in zip(channels, out):
                channel.set_trace(trace, fs, trace_start_time=channel.get_trace_start_time())


class channelTimeWindow(Module):
    """Zero the trace outside given time windows."""

    @register_run()
    def run(self, evt, station, det=None, window=None, around_pulse=False,
            window_function="rectangular"):
        for channels in same_grid(station.iter_channels()):
            fs = channels[0].get_sampling_rate()
            traces = stack_traces(channels, self.device)
            times = self.tensor(np.array([c.get_times() for c in channels]))
            keep = (times >= window[0]) & (times <= window[1])
            out = host(torch.where(keep, traces, torch.zeros_like(traces)))
            for channel, trace in zip(channels, out):
                channel.set_trace(trace, fs, trace_start_time=channel.get_trace_start_time())


class channelReadoutWindowCutter(Module):
    """Cut each channel to its detector readout window around the trigger
    time (channelReadoutWindowCutter.py:28-120): one gather per batch of
    channels, zero where the window leaves the trace."""

    @register_run()
    def run(self, evt, station, det):
        # primary trigger = earliest triggered trigger
        triggers = [t for t in station.get_triggers().values() if t.has_triggered()]
        if not triggers:
            return
        primary = min(triggers, key=lambda t: t.get_trigger_time())
        trigger_time = primary.get_trigger_time()

        for channels in same_grid(station.iter_channels()):
            fs = channels[0].get_sampling_rate()
            starts, cuts, first = [], [], []
            for channel in channels:
                cid = channel.get_id()
                n_samples = det.get_number_of_samples(station.get_id(), cid)
                det_fs = det.get_sampling_frequency(station.get_id(), cid)
                cuts.append(int(round(n_samples * fs / det_fs)))
                window_start = trigger_time - primary.get_pre_trigger_time_channel(cid)
                starts.append(window_start)
                first.append(int(round((window_start - channel.get_trace_start_time()) * fs)))
            traces = stack_traces(channels, self.device)
            n = traces.shape[-1]
            n_cut = max(cuts)
            idx = self.tensor(first, torch.int64)[:, None] \
                + torch.arange(n_cut, device=self.device)
            inside = (idx >= 0) & (idx < n) \
                & (torch.arange(n_cut, device=self.device) < self.tensor(cuts)[:, None])
            cut = torch.where(inside, torch.gather(traces, 1, idx.clamp(0, n - 1)),
                              torch.zeros((), dtype=traces.dtype, device=self.device))
            out = host(cut)
            for channel, trace, n_c, t0 in zip(channels, out, cuts, starts):
                channel.set_trace(trace[:n_c].copy(), fs, trace_start_time=t0)
