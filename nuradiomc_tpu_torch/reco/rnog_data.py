"""RNO-G data-quality / calibration modules (torch).

Counterpart of ``nuradiomc_tpu/reco/rnog_data.py``, batched over traces
``[..., n]`` on the module's device:

* channelBlockOffsets — LAB4D 128-sample block pedestal offsets
  (modules/RNO_G/channelBlockOffsetFitter.py:24-440): the rFFT, the
  out-of-band mask and the masked irfft of every trace, block means by a
  reshape, the ``auto`` decision per trace, and the exact least-squares fit
  as one product with the solution operator of the design matrix (the same
  matrix for every trace of one length and rate, built once on the host in
  float64 by ``np.linalg.lstsq`` on the identity, the SVD solve the JAX
  package calls per trace).
* channelGlitchDetector — the seam statistic of the trace against its
  "unscrambled" readout (modules/RNO_G/channelGlitchDetector.py:21-178);
  ``unscramble`` is a fixed index map (made on the host by applying the JAX
  package's own slices to ``np.arange(n)``) applied as one gather.
* stationHitFilter — Hilbert-envelope hit-time coincidences of the deep
  in-ice channel groups (modules/RNO_G/stationHitFilter.py:17-520), the
  envelope, first-index argmax, median noise RMS and both checkers over
  ``[events, 15]``.
* stationCoherentlySummedWaveforms — SNR, impulsivity, entropy and kurtosis
  of the coherently summed waveform of a chunk of events in one call
  (RNO_G/stationCoherentlySummedWaveforms.py:15-143).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.reco.base import (Module, host, register_run, rows_per_chunk,
                                           same_grid, stack_traces)
from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils import trace_stats as ts
from nuradiomc_tpu_torch.utils import units

chp = par.channelParameters


def median_last(x: torch.Tensor) -> torch.Tensor:
    """``np.median`` over the last axis: the middle value, or the mean of
    the middle pair for an even count (``torch.median`` takes the lower)."""
    s = torch.sort(x, -1).values
    k = x.shape[-1] // 2
    if x.shape[-1] % 2:
        return s[..., k]
    return (s[..., k - 1] + s[..., k]) / 2


# ------------------------------------------------------------------ blocks

# copied from nuradiomc_tpu/reco/rnog_data.py:29-37 (_block_design_matrix)
def _block_design_matrix(frequencies_oob, n_offsets, block_size, dt, fs):
    """Analytic rFFT of a unit 'rect' offset on block j, evaluated on the
    out-of-band frequencies (channelBlockOffsetFitter.py:362-383)."""
    j = np.arange(n_offsets)
    phase = np.exp(-2j * np.pi * frequencies_oob[None, :] * dt
                   * ((j[:, None] + 0.5) * block_size - 0.5))
    amp = (np.sin(np.pi * frequencies_oob * block_size * dt)
           / np.sin(np.pi * frequencies_oob * dt))
    return (1.0 / fs * np.sqrt(2.0)) * phase * amp[None, :]


@functools.lru_cache(maxsize=16)
def _fit_operator(n, block_size, sampling_rate, max_frequency):
    """(out-of-band mask [n//2+1], X [n_blocks-1, 2 n_mask]) for traces of
    ``n`` samples: the least-squares solution of the real-stacked design
    matrix is ``X @ b`` (``lstsq(A, I)``, float64 on the host)."""
    dt = 1.0 / sampling_rate
    ff = np.fft.rfftfreq(n, dt)
    mask = (ff > 0) & (ff < max_frequency)
    M = _block_design_matrix(ff[mask], n // block_size - 1, block_size, dt, sampling_rate)
    A = np.vstack([M.T.real, M.T.imag])
    X, *_ = np.linalg.lstsq(A, np.eye(A.shape[0]), rcond=None)
    return mask, X


def block_offset_fit(trace: torch.Tensor, block_size=128, sampling_rate=3.2 * units.GHz,
                     max_frequency=50 * units.MHz, mode="auto"):
    """Per-block pedestal offsets of traces ``[..., n]`` from their
    out-of-band spectra (fit_block_offsets, channelBlockOffsetFitter.py:
    259-392): (offsets [..., n_blocks], fitted [...] bool, margin [...]),
    ``margin`` being max|a_guess| - 0.5 std(trace), the quantity whose sign
    decides the ``auto`` branch."""
    n = block_size * (trace.shape[-1] // block_size)
    x = trace[..., :n]
    n_blocks = n // block_size
    spectrum = ts.true_div(torch.fft.rfft(x, dim=-1), sampling_rate) * math.sqrt(2.0)
    mask_np, X = _fit_operator(n, block_size, float(sampling_rate), float(max_frequency))
    mask = torch.as_tensor(mask_np, device=trace.device)
    filtered = ts.true_div(torch.fft.irfft(torch.where(mask, spectrum, 0.0), n, dim=-1)
                    * sampling_rate, math.sqrt(2.0))
    a_guess = filtered.reshape(*x.shape[:-1], n_blocks, block_size).mean(-1)
    mean = x.mean(-1, keepdim=True)
    margin = a_guess.abs().amax(-1) - 0.5 * x.std(-1, correction=0)
    if mode == "approximate":
        fitted = torch.zeros_like(margin, dtype=torch.bool)
    elif mode == "fit":
        fitted = torch.ones_like(margin, dtype=torch.bool)
    elif mode == "auto":
        fitted = margin > 0
    else:
        raise ValueError(f"invalid mode {mode!r}")
    offsets = a_guess + mean
    if bool(fitted.any()):
        # the fit is degenerate under a global shift: the last block is 0
        b = torch.cat([spectrum[..., mask].real, spectrum[..., mask].imag], -1)
        sol = b @ torch.as_tensor(X.T, dtype=b.dtype, device=b.device)
        fit = torch.cat([sol, torch.zeros_like(sol[..., :1])], -1)
        fit = fit + (mean - fit.mean(-1, keepdim=True))
        offsets = torch.where(fitted[..., None], fit, offsets)
    return offsets, fitted, margin


def fit_block_offsets(trace: torch.Tensor, block_size=128, sampling_rate=3.2 * units.GHz,
                      max_frequency=50 * units.MHz, mode="auto", return_trace=False):
    """The JAX package's ``fit_block_offsets`` over traces ``[..., n]``:
    offsets [..., n_blocks], and with ``return_trace`` the trace with them
    removed from its whole blocks."""
    offsets, _, _ = block_offset_fit(trace, block_size, sampling_rate, max_frequency, mode)
    if return_trace:
        return offsets, subtract_blocks(trace, offsets, block_size)
    return offsets


def subtract_blocks(trace: torch.Tensor, offsets: torch.Tensor, block_size) -> torch.Tensor:
    n = offsets.shape[-1] * block_size
    out = trace.clone()
    out[..., :n] -= offsets.repeat_interleave(block_size, -1)
    return out


def median_block_offsets(trace: torch.Tensor, block_size=128) -> torch.Tensor:
    """Per-block medians of the whole blocks (remove_offsets:175-177)."""
    n = block_size * (trace.shape[-1] // block_size)
    return median_last(trace[..., :n].reshape(*trace.shape[:-1], -1, block_size))


class channelBlockOffsets(Module):
    """Add / remove block offsets on station channels
    (channelBlockOffsetFitter.py:24-257)."""

    def __init__(self, block_size=128, max_frequency=51 * units.MHz,
                 device=device_util.DEFAULT):
        super().__init__(device)
        self.block_size = block_size
        self._max_frequency = max_frequency

    def add_offsets(self, event, station, offsets=1 * units.mV, channel_ids=None, rng=None):
        """Inject random (gaussian, sigma=offsets, drawn on the host) or
        explicit offsets."""
        rng = rng or np.random.default_rng()
        for ch in station.iter_channels(channel_ids):
            tr = np.asarray(ch.get_trace())
            n_blocks = len(tr) // self.block_size
            if np.isscalar(offsets):
                add = rng.normal(0, offsets, n_blocks)
            else:
                add = np.asarray(offsets)
            ch.set_parameter(
                chp.block_offsets,
                np.asarray(ch.get_parameter(chp.block_offsets))
                + add if ch.has_parameter(chp.block_offsets) else add)
            out = self.tensor(tr) + self.tensor(add).repeat_interleave(self.block_size)
            ch.set_trace(host(out), ch.get_sampling_rate())

    def offsets_and_traces(self, traces: torch.Tensor, sampling_rate, mode="auto"):
        """(offsets [..., n_blocks], corrected traces [..., n], fitted [...])
        of traces ``[..., n]`` on the device."""
        if mode == "median":
            offsets = median_block_offsets(traces, self.block_size)
            fitted = torch.zeros(traces.shape[:-1], dtype=torch.bool, device=traces.device)
        else:
            offsets, fitted, _ = block_offset_fit(traces, self.block_size, sampling_rate,
                                                  self._max_frequency, mode)
        return offsets, subtract_blocks(traces, offsets, self.block_size), fitted

    def remove_offsets(self, event, station, mode="auto", channel_ids=None):
        for group in same_grid(list(station.iter_channels(channel_ids))):
            fs = group[0].get_sampling_rate()
            offsets, out, _ = self.offsets_and_traces(stack_traces(group, self.device), fs, mode)
            for ch, off, tr in zip(group, host(offsets), host(out)):
                ch.set_parameter(chp.block_offsets, off)
                ch.set_trace(tr, fs)

    @register_run()
    def run(self, event, station, det=None, mode="auto", channel_ids=None):
        self.remove_offsets(event, station, mode=mode, channel_ids=channel_ids)


# ------------------------------------------------------------------ glitches

LAB4D_BLOCK = 64
LAB4D_READOUT = 2048


def seam_diff_sq(trace: torch.Tensor, block_size=LAB4D_BLOCK) -> torch.Tensor:
    """Sum of squared differences across 2*block seams of traces [..., n]
    (channelGlitchDetector.diff_sq:84-97)."""
    two = 2 * block_size
    k = torch.arange(trace.shape[-1] // two - 1, device=trace.device)
    left = trace[..., k * two + block_size - 1]
    right = trace[..., k * two + block_size]
    return ((left - right) ** 2).sum(-1)


# copied from nuradiomc_tpu/reco/rnog_data.py:173-187 (unscramble), applied to
# sample indices only
def _unscramble_host(trace, block_size, readout_size):
    trace = np.asarray(trace)
    new = np.zeros_like(trace)
    two = 2 * block_size
    for i in range(len(trace) // block_size):
        s, e = i * block_size, (i + 1) * block_size
        if i % 2 == 0:
            new[(s + two) % readout_size:(e + two) % readout_size or None] = trace[s:e]
        elif i > 1:
            new[(s - two) % readout_size:(e - two) % readout_size] = trace[s:e]
    new[0:block_size] = 0
    return new


@functools.lru_cache(maxsize=16)
def _unscramble_map(n, block_size, readout_size):
    """Source sample of every output sample of ``unscramble`` at length
    ``n`` (-1 where the output is 0)."""
    return _unscramble_host(np.arange(1, n + 1), block_size, readout_size) - 1


def unscramble(trace: torch.Tensor, block_size=LAB4D_BLOCK,
               readout_size=LAB4D_READOUT) -> torch.Tensor:
    """Candidate de-scrambling of the LAB4D readout of traces [..., n]:
    even blocks move forward, odd blocks back by two blocks
    (channelGlitchDetector.unscramble:99-126), as one gather."""
    src = torch.as_tensor(_unscramble_map(trace.shape[-1], block_size, readout_size),
                          device=trace.device)
    return torch.where(src >= 0, trace[..., src.clamp(min=0)], 0.0)


def glitch_statistic(trace: torch.Tensor, block_size=LAB4D_BLOCK,
                     readout_size=LAB4D_READOUT) -> torch.Tensor:
    """(seam(trace) - seam(unscramble(trace))) / var(trace) over [..., n]."""
    return ((seam_diff_sq(trace, block_size)
             - seam_diff_sq(unscramble(trace, block_size, readout_size), block_size))
            / trace.var(-1, correction=0))


class channelGlitchDetector(Module):
    """Flags channels whose seam statistic improves under unscrambling
    (channelGlitchDetector.py:21-178)."""

    def __init__(self, cut_value=0.0, block_size=LAB4D_BLOCK, readout_size=LAB4D_READOUT,
                 device=device_util.DEFAULT):
        super().__init__(device)
        self.cut = cut_value
        self.block_size = block_size
        self.readout_size = readout_size

    def statistic(self, traces: torch.Tensor) -> torch.Tensor:
        return glitch_statistic(traces, self.block_size, self.readout_size)

    @register_run()
    def run(self, event, station, det=None):
        for group in same_grid(list(station.iter_channels())):
            flags = host(self.statistic(stack_traces(group, self.device)) > self.cut)
            for ch, flag in zip(group, flags):
                ch.set_parameter(chp.glitch, bool(flag))


# ------------------------------------------------------------------ hits

class stationHitFilter(Module):
    """Envelope hit-time coincidence filter for the deep RNO-G channels
    (stationHitFilter.py:17-520). Group 0 is the phased array (0-3);
    passing requires >=2 connected coincident PA pairs, or 1 PA pair plus a
    pair in another group; otherwise a single high hit (envelope max >
    multiplier * noise RMS) passes the event."""

    IN_ICE_CHANNELS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 21, 22, 23]
    GROUPS = ([0, 1, 2, 3], [9, 10], [23, 22], [8, 4])
    PA_PAIRS = ([0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3])

    def __init__(self, time_window=10.0 * units.ns, threshold_multiplier=6.5,
                 select_trigger=None, device=device_util.DEFAULT):
        super().__init__(device)
        self._dT = time_window
        self._mult = threshold_multiplier
        self._select_trigger = select_trigger
        self.passed_time_checker = None
        self.passed_hit_checker = None

    def begin(self, log_level=None):
        pass

    @staticmethod
    def _map(cid):
        """Channel id -> index in the in-ice ordering (:84-104)."""
        return cid - 9 if cid >= 21 else cid

    def apply_batch(self, traces: torch.Tensor, t_hit_of, noise_rms=None):
        """Both checkers over traces [E, 15, n] in in-ice channel order:
        (passed, time checker, hit checker) [E] and the hit times [E, 15].
        ``t_hit_of(idx)`` maps the envelope maxima's sample indices [E, 15]
        to times."""
        envelopes = ts.get_hilbert_envelope(traces)
        t_hit = t_hit_of(torch.argmax(envelopes, -1))
        if noise_rms is None:
            n = traces.shape[-1]
            split = traces[..., :20 * (n // 20)].reshape(*traces.shape[:-1], 20, -1)
            noise_rms = median_last(split.std(-1, correction=0))
        # time checker (:106-162): seq[i] for the first channel of a pair
        pairs = torch.as_tensor(self.PA_PAIRS, device=traces.device)
        d_mult = (pairs[:, 1] - pairs[:, 0]).to(t_hit.dtype)
        ok = (t_hit[..., pairs[:, 1]] - t_hit[..., pairs[:, 0]]).abs() <= d_mult * self._dT
        seq = torch.stack([ok[..., pairs[:, 0] == i].any(-1) for i in range(3)], -1)
        passed = seq.sum(-1) >= 2
        group_ok = torch.zeros_like(passed)
        for group in self.GROUPS[1:]:
            i, j = self._map(group[0]), self._map(group[1])
            # a station without the group's channels (the phased array
            # alone) has no coincidence in it; the reference reads them only
            # for an event with a single coincident PA pair
            if max(i, j) < t_hit.shape[-1]:
                group_ok |= (t_hit[..., j] - t_hit[..., i]).abs() <= self._dT
        passed |= ~passed & seq.any(-1) & group_ok
        # hit checker (:164-180)
        noise_rms = torch.as_tensor(noise_rms, dtype=envelopes.dtype, device=traces.device)
        hit = (envelopes.amax(-1) > self._mult * noise_rms).any(-1)
        return passed | hit, passed, hit, t_hit

    def apply(self, traces, times, noise_rms=None):
        """traces/times: (15, N) arrays in in-ice channel order."""
        times = np.asarray(times)
        passed, time_ok, hit, _ = self.apply_batch(
            self.tensor(traces)[None],
            lambda idx: self.tensor(times[np.arange(len(times)), host(idx[0])])[None],
            None if noise_rms is None else self.tensor(noise_rms))
        self.passed_time_checker = bool(time_ok[0])
        self.passed_hit_checker = bool(hit[0])
        return bool(passed[0])

    def _selected(self, station):
        if self._select_trigger is None:
            return True
        trig = station.get_first_trigger()
        return trig is not None and trig.get_name() == self._select_trigger

    def _channels(self, station):
        chans = [(c.get_id(), c) for c in station.iter_channels()
                 if c.get_id() in self.IN_ICE_CHANNELS]
        chans.sort(key=lambda t: t[0])
        return [c for _, c in chans]

    @register_run()
    def run(self, evt, station, det=None, noise_RMS_all=None):
        if not self._selected(station):
            return True
        chans = self._channels(station)
        traces = np.array([np.asarray(c.get_trace()) for c in chans])
        times = np.array([np.asarray(c.get_times()) for c in chans])
        rms = None
        if noise_RMS_all is not None:
            rms = np.asarray(noise_RMS_all)[self.IN_ICE_CHANNELS]
        return self.apply(traces, times, rms)

    def run_events(self, events, noise_RMS_all=None):
        """The filter on every event's first station, in chunks of events as
        ``rows_per_chunk`` allows: (passed, time checker, hit checker) bool
        arrays [E] and the hit times [E, 15] (NaN where the station's trigger
        is not ``select_trigger``: those pass without a check)."""
        n_ev = len(events)
        passed = np.ones(n_ev, dtype=bool)
        time_ok = np.zeros(n_ev, dtype=bool)
        hit = np.zeros(n_ev, dtype=bool)
        t_hit = np.full((n_ev, len(self.IN_ICE_CHANNELS)), np.nan)
        stations = [evt.get_station() for evt in events]
        todo = [i for i, st in enumerate(stations) if self._selected(st)]
        rms = None
        if noise_RMS_all is not None:
            rms = self.tensor(np.asarray(noise_RMS_all)[self.IN_ICE_CHANNELS])
        if not todo:
            return passed, time_ok, hit, t_hit
        n = self._channels(stations[todo[0]])[0].get_number_of_samples()
        rows = rows_per_chunk(len(self.IN_ICE_CHANNELS) * n * 8 * 8, self.device, len(todo))
        for at in range(0, len(todo), rows):
            idx_ev = todo[at:at + rows]
            chans = [self._channels(stations[i]) for i in idx_ev]
            flat = [c for cs in chans for c in cs]
            traces = stack_traces(flat, self.device).reshape(len(idx_ev), len(chans[0]), -1)
            t0 = self.tensor([[c.get_trace_start_time() for c in cs] for cs in chans])
            fs = self.tensor([[c.get_sampling_rate() for c in cs] for cs in chans])
            out = self.apply_batch(traces, lambda i: i.to(t0.dtype) / fs + t0, rms)
            for arr, val in zip((passed, time_ok, hit, t_hit), out):
                arr[idx_ev] = host(val)
            for i in idx_ev:
                events[i].register_module_station(stations[i].get_id(), self,
                                                  type(self).__name__, {})
        return passed, time_ok, hit, t_hit


# ---------------------------------------------------------- coherent sums

class stationCoherentlySummedWaveforms(Module):
    """SNR / impulsivity / entropy / kurtosis of the coherently-summed
    waveform (RNO_G/stationCoherentlySummedWaveforms.py:15-143)."""

    def begin(self, coincidence_window_size=6 * units.ns, pad_length=500,
              channel_ids=(0, 1, 2, 3)):
        self._window = coincidence_window_size
        self._pad = pad_length
        self._channel_ids = list(channel_ids)

    def _stats(self, ref, others, window_bins, use_envelope):
        """The summed waveform [..., n] of ``ref`` [..., n] and ``others``
        [..., T, n], and its four observables [...]."""
        csw = ts.get_coherent_sum(others, ref, use_envelope)
        rms = ts.get_split_trace_noise_RMS(csw, segments=4, lowest=2)
        return csw, {
            "coherent_snr": ts.get_signal_to_noise_ratio(csw, rms,
                                                         window_size=max(window_bins, 2)),
            "coherent_impulsivity": ts.get_impulsivity(csw),
            "coherent_entropy": ts.get_entropy(csw),
            "coherent_kurtosis": ts.get_kurtosis(csw)}

    def _parts(self, station, ref_ch_id):
        ref = station.get_channel(ref_ch_id)
        others = [ch for ch in station.iter_channels(self._channel_ids)
                  if ch.get_id() != ref_ch_id]
        return ref, others, int(round(self._window * ref.get_sampling_rate()))

    @staticmethod
    def _store(station, values):
        rnog = par.stationParametersRNOG
        for key, value in values.items():
            station[getattr(rnog, key)] = float(value)

    @register_run()
    def run(self, evt, station, det=None, ref_ch_id=0, use_envelope=True):
        ref, others, window_bins = self._parts(station, ref_ch_id)
        csw, values = self._stats(stack_traces([ref], self.device)[0],
                                  stack_traces(others, self.device), window_bins,
                                  use_envelope)
        self._store(station, values)
        return host(csw)

    def run_events(self, events, ref_ch_id=0, use_envelope=True):
        """The module on every event's first station, stations of one trace
        length and window as one batch in chunks as ``rows_per_chunk``
        allows: the four observables as float arrays [E]."""
        stations = [evt.get_station() for evt in events]
        out = {k: np.zeros(len(events)) for k in ("coherent_snr", "coherent_impulsivity",
                                                  "coherent_entropy", "coherent_kurtosis")}
        groups = {}
        for i, st in enumerate(stations):
            ref, others, window_bins = self._parts(st, ref_ch_id)
            key = (ref.get_number_of_samples(), len(others), window_bins)
            groups.setdefault(key, []).append(i)
        for (n, n_other, window_bins), idx in groups.items():
            rows = rows_per_chunk((n_other + 1) * 4 * n * 16 * 4, self.device, len(idx))
            for at in range(0, len(idx), rows):
                part = idx[at:at + rows]
                refs, others = [], []
                for i in part:
                    ref, oth, _ = self._parts(stations[i], ref_ch_id)
                    refs.append(ref)
                    others += oth
                ref_t = stack_traces(refs, self.device)
                oth_t = stack_traces(others, self.device).reshape(len(part), n_other, -1)
                _, values = self._stats(ref_t, oth_t, window_bins, use_envelope)
                values = {k: host(v) for k, v in values.items()}
                for j, i in enumerate(part):
                    self._store(stations[i], {k: v[j] for k, v in values.items()})
                    out_kw = {"ref_ch_id": ref_ch_id, "use_envelope": use_envelope}
                    events[i].register_module_station(stations[i].get_id(), self,
                                                      type(self).__name__, out_kw)
                for k, v in values.items():
                    out[k][part] = v
        return out
