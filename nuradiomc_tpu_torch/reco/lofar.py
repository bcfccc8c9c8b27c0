"""LOFAR cosmic-ray pipeline modules, batched on the card (torch).

Counterpart of ``nuradiomc_tpu/reco/lofar.py`` (NuRadioReco/modules/LOFAR/):

- :func:`find_rfi` / :class:`stationRFIFilter` — the phase-variance RFI
  flagging method (stationRFIFilter.py:72-597, arXiv:1311.1399 §3.2.2): one
  ``torch.fft.rfft`` over [antennas, blocks, samples], the phasor means,
  power sums and medians on the device; the reference-antenna choice stays
  on the host.
- :class:`stationGalacticCalibrator` — absolute + relative (Galactic noise)
  gain calibration (stationGalacticCalibrator.py:33-266) of all of a
  station's spectra at once; the calibration tables are the port's copy in
  ``data/galactic_calibration/``.
- :class:`stationPulseFinder` — beamformed pulse search + per-channel SNR
  flagging (stationPulseFinder.py:82-324), all channels in one batch.
- :class:`planeWaveDirectionFitter` — iterative plane-wave fit with k-sigma
  outlier removal (planeWaveDirectionFitter_LOFAR.py:70-380).
- :class:`beamformingDirectionFitter` — direction fit maximizing the
  beamformed power (beamformingDirectionFitter_LOFAR.py:49-212) as a
  coarse-to-fine grid: every direction of a zoom level is one batched
  program (phases [directions, antennas, bins], the sum over antennas, the
  inverse FFT, the peak power), in chunks of directions that fit the
  device's memory.

The zoom grids are built on the host with ``np.linspace``, so that the
grid points (and ties of the argmax) are those of the JAX package, and the
medians average the two middle values of an even count as ``np.median``
does.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from nuradiomc_tpu_torch.framework.parameters import channelParameters, stationParameters
from nuradiomc_tpu_torch.ops.trace import hilbert_envelope
from nuradiomc_tpu_torch.reco.base import (Module, host, rows_per_chunk, same_grid,
                                           stack_spectra, stack_traces)
from nuradiomc_tpu_torch.reco.channel_processing import half_hann_window
from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils import fft, units
from nuradiomc_tpu_torch.utils.constants import speed_of_light

_DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                     "galactic_calibration")


def median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``np.median`` along ``dim``: the middle of the sorted values, the mean
    of the two middle ones for an even count."""
    s = torch.sort(x, dim).values
    n = x.shape[dim]
    hi = s.narrow(dim, n // 2, 1).squeeze(dim)
    if n % 2:
        return hi
    return (s.narrow(dim, n // 2 - 1, 1).squeeze(dim) + hi) / 2


# ---------------------------------------------------------------------------
# RFI detection (FindRFI_LOFAR, stationRFIFilter.py:72-485)
# ---------------------------------------------------------------------------

def num_double_zeros(data: torch.Tensor, threshold=None) -> torch.Tensor:
    """Number of samples that are zero (|x|<threshold) preceded by a zero
    (stationRFIFilter.num_double_zeros:15-27), over leading axes."""
    is_zero = (data == 0) if threshold is None else (torch.abs(data) < threshold)
    return torch.sum(is_zero[..., :-1] & is_zero[..., 1:], dim=-1)


# copied from nuradiomc_tpu/reco/lofar.py:58-74
def median_sorted_by_power(psort):
    """Reorder a sorted index list starting from the median, alternating
    right/left (stationRFIFilter.median_sorted_by_power:30-69)."""
    psort = list(psort)
    n = len(psort)
    index = n // 2 - 1 if n % 2 == 0 else n // 2
    out, start, modifier = [], index, 0
    for _ in range(n):
        out.append(psort[index])
        if modifier == 0:
            modifier = 1
        elif modifier > 0:
            modifier = -modifier
        else:
            modifier = -(modifier - 1)
        index = start + modifier
    return out


def find_rfi(traces, sampling_rate, rfi_block_length=8192, num_dbl_z=1000,
             flagged_antennas=None, device=device_util.DEFAULT):
    """Phase-variance RFI detection on a station's antenna traces
    (stationRFIFilter.py:72-485) on ``device``.

    ``traces`` is an (n_ant, n_samples) array or tensor whose n_samples is a
    multiple of ``rfi_block_length``. Returns the dict of the JAX package's
    ``find_rfi`` (host numpy arrays): avg_power_spectrum, avg_antenna_power,
    cleaned_power, phase_stability, dirty_channels (scaled to the full trace
    length), dirty_channels_block, dirty_channels_block_size, ref_antenna,
    antenna_is_good.
    """
    device = device_util.resolve(device)
    traces = torch.as_tensor(traces, device=device)
    n_ant, n_samples = traces.shape
    L = int(rfi_block_length)
    if n_samples % L != 0:
        raise ValueError("trace length must be a multiple of rfi_block_length")
    n_blocks = n_samples // L

    active = np.ones(n_ant, dtype=bool)
    if flagged_antennas is not None:
        active[list(flagged_antennas)] = False

    blocks = traces.reshape(n_ant, n_blocks, L)
    # good blocks: few double zeros (data-loss heuristic)
    blocks_good = host(num_double_zeros(blocks) < num_dbl_z) & active[:, None]

    window = torch.as_tensor(half_hann_window(L, 0.1), device=device)
    # ONE batched FFT for every (antenna, block); keep bins [0, Nyquist)
    spectra = torch.fft.rfft(blocks * window)[..., :L // 2]
    mag2 = torch.abs(spectra) ** 2

    # average power per antenna over its good blocks
    n_good = blocks_good.sum(axis=1)
    good_t = torch.as_tensor(blocks_good, dtype=mag2.dtype, device=device)
    average_power = host(torch.sum(mag2.sum(2) * good_t, 1)) / np.maximum(n_good, 1)
    average_power = np.where(n_good > 0, average_power, 0.0)

    # reference antenna: maximizes usable antennas, most-median power
    # (stationRFIFilter.py:208-236)
    allowed = np.zeros(n_ant, dtype=int)
    for i in range(n_ant):
        usable_blocks = np.where(blocks_good[i])[0]
        per_ant = blocks_good[:, usable_blocks].sum(axis=1)
        allowed[i] = np.sum(per_ant >= n_blocks)
    if allowed.max() < 2:
        raise ValueError("cannot find RFI: fewer than 2 fully-good antennas")
    can_be_ref = allowed == allowed.max()
    ref_antenna = next(i for i in median_sorted_by_power(np.argsort(average_power))
                       if can_be_ref[i])

    good_blocks = np.where(blocks_good[ref_antenna])[0]
    num_good = blocks_good[:, good_blocks].sum(axis=1)
    antenna_is_good = num_good >= (n_blocks - 1)

    # phase relative to the reference antenna, averaged as unit phasors
    use = torch.as_tensor(blocks_good[:, good_blocks] & antenna_is_good[:, None],
                          dtype=mag2.dtype, device=device)[..., None]
    gb = torch.as_tensor(good_blocks, device=device)
    sp = spectra[:, gb, :]
    phasor = sp / (torch.abs(sp) + 1e-15)
    phasor = phasor / phasor[ref_antenna][None, :, :]
    phase_mean = torch.sum(phasor * use, 1)
    spectrum_mean = torch.sum(mag2[:, gb, :] * use, 1) / len(good_blocks)

    phase_stability = 1.0 - torch.abs(phase_mean) / len(good_blocks)

    # channel flagging: median spread across good antennas (excl. reference)
    judge = antenna_is_good.copy()
    judge[ref_antenna] = False
    median_spread_by_channel = median(
        phase_stability[torch.as_tensor(judge, device=device)], 0)
    median_spread = median(median_spread_by_channel, 0)
    sorted_spreads = torch.sort(median_spread_by_channel).values
    N = median_spread_by_channel.shape[0]
    noise = sorted_spreads[int(N * 0.95)] - sorted_spreads[int(N / 2)]
    dirty = np.nonzero(host(median_spread_by_channel < (median_spread - 3 * noise)))[0]

    # extend shoulders (stationRFIFilter.py:341-352; floored at 1 so block
    # sizes below the reference's 8192 default still flag the line itself)
    extended = np.zeros(N, dtype=bool)
    half_width = max(int(L / 8192), 1)
    for i in dirty:
        extended[max(i - half_width, 0):min(i + half_width, N - 1)] = True
    dirty_block = np.where(extended)[0]

    antenna_is_good[ref_antenna] = True
    avg_power_spectrum = spectrum_mean.sum(0) / max(spectrum_mean.shape[0], 1)
    avg_antenna_power = spectrum_mean.sum(1) / spectrum_mean.shape[1]
    cleaned = spectrum_mean.clone()
    cleaned[:, torch.as_tensor(dirty_block, device=device)] = 0.0
    cleaned_power = 2 * cleaned.sum(1)

    # scale block-resolution channels to the full trace length
    mult = n_samples // L
    dirty_channels = np.sort(np.concatenate(
        [np.arange(mult * c, mult * c + mult) for c in dirty_block])
        if len(dirty_block) else np.array([], dtype=int))

    return {
        "avg_power_spectrum": host(avg_power_spectrum),
        "avg_antenna_power": host(avg_antenna_power),
        "cleaned_power": host(cleaned_power),
        "phase_stability": host(phase_stability),
        "dirty_channels": dirty_channels,
        "dirty_channels_block": dirty_block,
        "dirty_channels_block_size": n_samples,
        "ref_antenna": ref_antenna,
        "antenna_is_good": antenna_is_good,
    }


class stationRFIFilter(Module):
    """Flag and zero RFI-contaminated frequency channels per station
    (stationRFIFilter.py:488-597); the spectra of all channels are zeroed
    in one batch."""

    def begin(self, rfi_cleaning_trace_length=8192, num_dbl_z=1000):
        self._L = rfi_cleaning_trace_length
        self._num_dbl_z = num_dbl_z

    def run(self, event, station=None, det=None):
        stations = [station] if station is not None else event.get_stations()
        for st in stations:
            channel_ids = st.get_channel_ids()
            channels = [st.get_channel(cid) for cid in channel_ids]
            traces = stack_traces(channels, self.device)
            fs = channels[0].get_sampling_rate()

            flagged = st.get_parameter(stationParameters.flagged_channels) \
                if st.has_parameter(stationParameters.flagged_channels) else {}
            flagged = dict(flagged)
            flagged_idx = [i for i, cid in enumerate(channel_ids) if cid in flagged]

            result = find_rfi(traces, fs, rfi_block_length=min(self._L, traces.shape[1]),
                              num_dbl_z=self._num_dbl_z,
                              flagged_antennas=flagged_idx, device=self.device)
            self.last_result = result
            dirty = result["dirty_channels"]
            st.set_parameter(stationParameters.dirty_fft_channels, dirty)

            # flag antennas with outlier cleaned power
            # (stationRFIFilter.py:544-578: <0.5x or >2x the median)
            median_power = np.median(result["cleaned_power"])
            outlier = np.logical_or(result["cleaned_power"] < 0.5 * median_power,
                                    result["cleaned_power"] > 2.0 * median_power)
            for i, cid in enumerate(channel_ids):
                if outlier[i]:
                    flagged.setdefault(cid, []).append("rfi_outliers_cleaned_power")
            st.set_parameter(stationParameters.flagged_channels, flagged)

            # zero the dirty bins in every channel (batched)
            spectra = fft.time2freq(traces, fs)
            zero = torch.as_tensor(dirty[dirty < spectra.shape[1]], device=self.device)
            spectra[:, zero] = 0.0
            for ch, spec in zip(channels, host(spectra)):
                ch.set_frequency_spectrum(spec, fs)


# ---------------------------------------------------------------------------
# Galactic calibration (stationGalacticCalibrator.py:16-266)
# ---------------------------------------------------------------------------

# copied from nuradiomc_tpu/reco/lofar.py:261-284
def fourier_series(x, p):
    """a0/2 + sum a_n sin(nx) + b_n cos(nx)
    (stationGalacticCalibrator.fourier_series:16-30)."""
    r = p[0] / 2
    order = (len(p) - 1) // 2
    for i in range(order):
        n = i + 1
        r = r + p[2 * i + 1] * np.sin(n * x) + p[2 * i + 2] * np.cos(n * x)
    return r


def local_apparent_sidereal_time(unix_time, longitude_deg):
    """Local sidereal time in hours from Unix time + east longitude.

    GMST via the IAU 1982 polynomial (accurate to <0.1 s here — the
    reference delegates to astropy); apparent != mean by <1.2 s, negligible
    against the Fourier fit resolution.
    """
    jd = unix_time / 86400.0 + 2440587.5
    T = (jd - 2451545.0) / 36525.0
    gmst = 280.46061837 + 360.98564736629 * (jd - 2451545.0) \
        + 0.000387933 * T ** 2 - T ** 3 / 38710000.0
    lst = np.mod(gmst + longitude_deg, 360.0)
    return lst / 15.0


class stationGalacticCalibrator(Module):
    """Absolute (measured curve) + relative (Galactic-noise Fourier fit)
    gain calibration (stationGalacticCalibrator.py:33-266), a station's
    channels in one batch."""

    def __init__(self, experiment="LOFAR_LBA", device=device_util.DEFAULT):
        super().__init__(device)
        self._experiment = experiment
        self._abs_curve = None
        self._rel_coefficients = None

    # copied from nuradiomc_tpu/reco/lofar.py:296-305
    def begin(self):
        self._abs_curve = np.genfromtxt(os.path.join(
            _DATA, f"{self._experiment}_abs_calibration_curve.txt"))
        rel = np.genfromtxt(os.path.join(
            _DATA, f"{self._experiment}_Fourier_coefficients.txt"),
            dtype=str, delimiter=", ")
        self._rel_coefficients = {}
        for col in rel.T:
            group_id = str(col[0].split(" ")[1])
            self._rel_coefficients[group_id] = col[1:].astype("f8")

    def _get_absolute_calibration(self, frequencies):
        curve_ff = np.arange(len(self._abs_curve)) * units.MHz
        return np.interp(frequencies, curve_ff, self._abs_curve)

    @staticmethod
    def _polarisation_key(det, station, channel):
        phi_deg = det.get_antenna_orientation(
            station.get_id(), channel.get_id())[1] / units.deg
        if np.isclose(phi_deg, 225.0):
            return "1"
        if np.isclose(phi_deg, 135.0):
            return "0"
        raise ValueError(f"orientation {phi_deg} is neither X nor Y dipole")

    def run(self, event, det, unix_time=None):
        if unix_time is None:
            unix_time = event.get_id()  # LOFAR event ids are unix-ish stamps
        for station in event.get_stations():
            lat, lon = det.get_site_coordinates(station.get_id())
            lst = local_apparent_sidereal_time(unix_time, lon)
            channels = list(station.iter_channels())
            galactic = np.array([
                fourier_series(lst / 24.0 * 2 * np.pi,
                               self._rel_coefficients[self._polarisation_key(det, station, ch)])
                for ch in channels])
            for batch in same_grid(channels):
                ch0 = batch[0]
                fs, n = ch0.get_sampling_rate(), ch0.get_number_of_samples()
                spec = stack_spectra(batch, self.device)
                bandwidth = fs / n
                power = torch.sum(torch.abs(spec) ** 2, -1) * bandwidth
                power = power * units.Hz  # reference normalization quirk (module line 168)
                gal = self.tensor(galactic[[channels.index(ch) for ch in batch]])
                rel = torch.where(power == 0, 0.0,
                                  torch.sqrt(gal / torch.where(power == 0, 1.0, power)))
                absolute = self.tensor(self._get_absolute_calibration(ch0.get_frequencies()))
                spec = spec * absolute * rel[:, None]
                for ch, s in zip(batch, host(spec)):
                    ch.set_frequency_spectrum(s, fs)


# ---------------------------------------------------------------------------
# Beamforming (beamforming_utilities.py:12-113)
# ---------------------------------------------------------------------------

def geometric_delay_far_field(positions: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Plane-wave delays -(r . n)/c of [A, 3] positions for directions
    [..., 3] (normalized here), [..., A] (beamforming_utilities.py:94-113)."""
    n = direction / torch.sqrt((direction ** 2).sum(-1, keepdim=True))
    return -(n @ positions.T) / speed_of_light


def geometric_delays_near_field(positions: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Spherical-wave delays |r - s|/c (beamforming_utilities.py:71-91)."""
    d = positions - source
    return torch.sqrt((d * d).sum(-1)) / speed_of_light


# What beamformer materialises per (direction, antenna, bin): the phase
# (float64, 8 bytes), i * phase, its exponential and its product with the
# spectrum (complex128, 16 bytes each). At most the phase and two of the
# others are alive at once: 40 bytes. In all they are written once and read
# once more (i * phase, the exponential, the product, the sum over antennas):
# 8 + (8 + 16) + (16 + 16) + (16 + 16) + 16 = 112 bytes of device memory
# traffic, counted from the tensors' sizes, not measured.
BEAM_LIVE_BYTES = 40
BEAM_TRAFFIC_BYTES = 112


def beamformer(fft_data: torch.Tensor, frequencies: torch.Tensor,
               delays: torch.Tensor) -> torch.Tensor:
    """Phase-shift each antenna spectrum [A, F] by its delays [..., A] and
    sum over the antennas, [..., F] (beamforming_utilities.beamformer:43-69)."""
    phases = 2 * math.pi * frequencies * delays[..., None]
    return torch.sum(fft_data * torch.exp(1j * phases), dim=-2)


def mini_beamformer(fft_data, frequencies, positions, direction):
    """Far-field beamformer (beamforming_utilities.mini_beamformer:12-40)."""
    return beamformer(fft_data, frequencies, geometric_delay_far_field(positions, direction))


# copied from nuradiomc_tpu/reco/lofar.py:378-381
def spherical_to_cartesian(zenith, azimuth):
    return np.array([np.sin(zenith) * np.cos(azimuth),
                     np.sin(zenith) * np.sin(azimuth),
                     np.cos(zenith)])


def find_snr_of_timeseries(timeseries: torch.Tensor, sampling_rate=None, window_start=0,
                           window_end=-1, noise_start=0, noise_end=-1,
                           resample_factor=1, full_output=False):
    """Hilbert-envelope SNR of a trace window vs a noise window
    (stationPulseFinder.find_snr_of_timeseries:13-78), for traces [..., n]:
    tensors of SNR (and peak, noise RMS, signal time with ``full_output``)."""
    window = timeseries[..., window_start:window_end]
    if resample_factor > 1:
        n_out = window.shape[-1] * resample_factor
        window = torch.fft.irfft(torch.fft.rfft(window), n_out) * (n_out / window.shape[-1])
    envelope = hilbert_envelope(window)
    peak = envelope.amax(-1)
    noise_env = hilbert_envelope(timeseries[..., noise_start:noise_end])
    std = noise_env.std(-1, correction=0)
    if not full_output:
        return peak / std
    rms = torch.sqrt(torch.mean(noise_env ** 2, -1))
    signal_time = window_start / sampling_rate \
        + torch.argmax(envelope, -1) / sampling_rate / resample_factor
    return peak / std, peak, rms, signal_time


# ---------------------------------------------------------------------------
# Pulse finder (stationPulseFinder.py:82-324)
# ---------------------------------------------------------------------------

class stationPulseFinder(Module):
    """Beamform toward a guess direction, locate the pulse window, flag
    channels with sufficient SNR, and record the dominant polarisation."""

    def begin(self, window=256, noise_window=10000, cr_snr=6.5, good_channels=6):
        self._window = window
        self._noise_window = noise_window
        self._snr_cr = cr_snr
        self._min_good = good_channels

    def run(self, event, det, direction):
        """``direction`` = (zenith, azimuth) initial guess (e.g. from the
        particle-detector trigger, the reference's LORA input)."""
        direction_cartesian = self.tensor(spherical_to_cartesian(*direction))
        for station in event.get_stations():
            sid = station.get_id()
            # group channels by orientation (polarisation)
            groups = {}
            for ch in station.iter_channels():
                key = tuple(np.round(det.get_antenna_orientation(sid, ch.get_id()), 6))
                groups.setdefault(key, []).append(ch.get_id())
            orientations = list(groups.keys())
            channel_ids_per_pol = [groups[k] for k in orientations]

            ch0 = station.get_channel(channel_ids_per_pol[0][0])
            frequencies = self.tensor(ch0.get_frequencies())
            fs = ch0.get_sampling_rate()
            n_samples = ch0.get_number_of_samples()

            noise_start = min(10000, n_samples // 4)
            noise_end = min(noise_start + self._noise_window, n_samples // 2)

            values = []
            for ids in channel_ids_per_pol:
                spectra = stack_spectra([station.get_channel(c) for c in ids], self.device)
                positions = self.tensor(np.array([det.get_relative_position(sid, c)
                                                  for c in ids]))
                beamed = mini_beamformer(spectra, frequencies, positions,
                                         direction_cartesian)
                ts = fft.freq2time(beamed, fs, n=n_samples)
                peak_idx = int(torch.argmax(hilbert_envelope(ts)))
                w0 = peak_idx - self._window // 2
                w1 = peak_idx + self._window // 2
                snr = find_snr_of_timeseries(ts, window_start=w0, window_end=w1,
                                             noise_start=noise_start,
                                             noise_end=noise_end)
                values.append([float(snr), w0, w1])
            values = np.asarray(values)
            station.set_parameter(stationParameters.triggered,
                                  bool(values[-1][0] > self._snr_cr))
            dominant = int(np.argmax(values[:, 0]))
            w0, w1 = int(values[dominant][1]), int(values[dominant][2])
            station.set_parameter(stationParameters.cr_dominant_polarisation,
                                  np.asarray(orientations[dominant]))

            for ch in station.iter_channels():
                ch.set_parameter(channelParameters.signal_regions, [w0, w1])
                ch.set_parameter(channelParameters.noise_regions,
                                 [noise_start, noise_end])

            # per-channel SNR flags (stationPulseFinder._find_good_channels),
            # every channel in one batch
            if station.get_parameter(stationParameters.triggered):
                channels = list(station.iter_channels())
                traces = stack_traces(channels, self.device)
                snr, peak, rms, t_sig = (host(x) for x in find_snr_of_timeseries(
                    traces, sampling_rate=fs, window_start=w0, window_end=w1,
                    noise_start=noise_start, noise_end=noise_end,
                    resample_factor=16, full_output=True))
                max_amp = host(traces.amax(-1))
                good = []
                for i, ch in enumerate(channels):
                    ch.set_parameter(channelParameters.SNR, float(snr[i]))
                    ch.set_parameter(channelParameters.noise_rms, float(rms[i]))
                    ch.set_parameter(channelParameters.signal_time, float(t_sig[i]))
                    ch.set_parameter(channelParameters.maximum_amplitude_envelope,
                                     float(peak[i]))
                    ch.set_parameter(channelParameters.maximum_amplitude, float(max_amp[i]))
                    if snr[i] > self._snr_cr:
                        good.append(ch.get_id())
                if len(good) < self._min_good:
                    station.set_parameter(stationParameters.triggered, False)


# ---------------------------------------------------------------------------
# Plane-wave direction fitter (planeWaveDirectionFitter_LOFAR.py:70-380)
# ---------------------------------------------------------------------------

# copied from nuradiomc_tpu/reco/lofar.py:502-512
def direction_horizontal_array(positions, times):
    """lstsq plane-wave fit for a horizontal array: c t = A x + B y + C,
    zenith = arcsin sqrt(A^2+B^2), azimuth = atan2(-B, -A)
    (planeWaveDirectionFitter_LOFAR._direction_horizontal_array:157-216)."""
    x, y = positions[:, 0], positions[:, 1]
    M = np.vstack([x, y, np.ones(len(x))]).T
    (A, B, _), *_ = np.linalg.lstsq(M, speed_of_light * times, rcond=None)
    s = np.hypot(A, B)
    zenith = np.arcsin(min(s, 1.0))
    azimuth = np.arctan2(-B, -A)
    return np.mod(zenith, 2 * np.pi), np.mod(azimuth, 2 * np.pi)


class planeWaveDirectionFitter(Module):
    """Iterative plane-wave fit on pulse arrival times with k-sigma outlier
    removal (planeWaveDirectionFitter_LOFAR.py); the least squares of a few
    dozen antennas on the host, the expected delays on the device."""

    def begin(self, max_iter=10, cr_snr=6.5, min_amp=None, rmsfactor=2.0,
              min_number_good_antennas=4):
        self._max_iter = max_iter
        self._cr_snr = cr_snr
        self._min_amp = min_amp
        self._rmsfactor = rmsfactor
        self._min_good = min_number_good_antennas

    def run(self, event, det, initial_direction=None):
        for station in event.get_stations():
            if not station.get_parameter(stationParameters.triggered):
                continue
            sid = station.get_id()
            dominant = station.get_parameter(
                stationParameters.cr_dominant_polarisation)

            group_ids = station.get_channel_group_ids()
            positions, dominant_ids, good = [], [], []
            for gid in group_ids:
                positions.append(det.get_relative_position(sid, gid))
                dom_id = None
                for ch in station.iter_channel_group(gid):
                    if np.allclose(det.get_antenna_orientation(sid, ch.get_id()),
                                   dominant):
                        dom_id = ch.get_id()
                if dom_id is None:
                    dom_id = gid
                dominant_ids.append(dom_id)
                ch = station.get_channel(dom_id)
                if self._min_amp is None:
                    good.append(ch.get_parameter(channelParameters.SNR)
                                > self._cr_snr)
                else:
                    good.append(np.max(np.abs(ch.get_trace())) >= self._min_amp)

            positions = np.asarray(positions)[np.asarray(good)]
            dominant_ids = np.asarray(dominant_ids)[np.asarray(good)]
            num_good = len(dominant_ids)
            mask = np.ones(num_good, dtype=bool)

            zenith = azimuth = None
            for _ in range(self._max_iter):
                if num_good < self._min_good:
                    break
                positions = positions[mask]
                dominant_ids = dominant_ids[mask]
                times = np.array([station.get_channel(c).get_parameter(
                    channelParameters.signal_time) for c in dominant_ids])
                times = times - times[0]

                zenith, azimuth = direction_horizontal_array(positions, times)

                expected = host(geometric_delay_far_field(
                    self.tensor(positions), self.tensor(spherical_to_cartesian(zenith, azimuth))))
                expected = expected - expected[0]
                residuals = times - expected
                spread = np.std(residuals)
                mask = np.abs(residuals - np.mean(residuals)) \
                    < self._rmsfactor * spread
                if mask.sum() == num_good:
                    break
                num_good = int(mask.sum())

            if zenith is not None:
                station.set_parameter(stationParameters.zenith, zenith)
                station.set_parameter(stationParameters.azimuth, azimuth)
                station.set_parameter(stationParameters.cr_zenith, zenith)
                station.set_parameter(stationParameters.cr_azimuth, azimuth)


# ---------------------------------------------------------------------------
# Beamforming direction fitter (beamformingDirectionFitter_LOFAR.py:49-212)
# ---------------------------------------------------------------------------

def beam_powers(spectra: torch.Tensor, frequencies: torch.Tensor, positions: torch.Tensor,
                n_samples: int, zen_grid, azi_grid):
    """max(ts^2) of the beamformed trace toward every (zenith, azimuth) of
    the grid, [len(zen_grid), len(azi_grid)] on the spectra's device, and the
    number of directions per chunk. ``spectra`` [A, F] complex, the grids
    host arrays."""
    dev = spectra.device
    zz, aa = np.meshgrid(np.asarray(zen_grid), np.asarray(azi_grid), indexing="ij")
    zz = torch.as_tensor(zz.ravel(), device=dev)
    aa = torch.as_tensor(aa.ravel(), device=dev)
    dirs = torch.stack([torch.sin(zz) * torch.cos(aa), torch.sin(zz) * torch.sin(aa),
                        torch.cos(zz)], -1)
    A, F = spectra.shape
    # per direction: BEAM_LIVE_BYTES per (antenna, bin), then the sum over
    # antennas and the inverse FFT's copy of it (complex128), the trace and
    # its square (float64)
    rows = rows_per_chunk(A * F * BEAM_LIVE_BYTES + F * 32 + n_samples * 16, dev,
                          dirs.shape[0])
    out = []
    for i in range(0, dirs.shape[0], rows):
        beamed = beamformer(spectra, frequencies,
                            geometric_delay_far_field(positions, dirs[i:i + rows]))
        ts = torch.fft.irfft(beamed, n_samples)
        out.append(torch.amax(ts ** 2, -1))
    return torch.cat(out).reshape(len(zen_grid), len(azi_grid)), rows


class beamformingDirectionFitter(Module):
    """Direction fit maximizing the peak power of the beamformed trace.

    The reference iterates a Powell simplex over (zenith, azimuth); here
    (as in the JAX package) the scan is a coarse-to-fine grid, every
    direction of a zoom level beamformed in one batched program on the
    device. ``levels`` keeps each level's (zenith grid, azimuth grid,
    powers) of the last fit and ``chunk`` its directions per chunk.
    """

    def begin(self, cr_snr=3.0, grid_points=15, zoom_levels=4,
              initial_half_width=20 * units.deg):
        self._cr_snr = cr_snr
        self._grid = grid_points
        self._levels = zoom_levels
        self._width0 = initial_half_width

    def _fit(self, spectra, frequencies, positions, fs, n_samples, start):
        spectra = self.tensor(spectra)
        frequencies = self.tensor(frequencies)
        positions = self.tensor(positions)
        zen0, azi0 = float(start[0]), float(start[1])
        width = float(self._width0)
        self.levels = []
        for _ in range(self._levels):
            zen_grid = np.linspace(max(zen0 - width, 0.0),
                                   min(zen0 + width, np.pi / 2), self._grid)
            azi_grid = np.linspace(azi0 - width, azi0 + width, self._grid)
            power, self.chunk = beam_powers(spectra, frequencies, positions, n_samples,
                                            zen_grid, azi_grid)
            power = host(power)
            self.levels.append((zen_grid, azi_grid, power))
            i, j = np.unravel_index(np.argmax(power), power.shape)
            zen0, azi0 = float(zen_grid[i]), float(azi_grid[j])
            width = 2.5 * width / self._grid
        return zen0, np.mod(azi0, 2 * np.pi)

    def run(self, event, det, use_channels_per_group=None):
        for station in event.get_stations():
            if not station.get_parameter(stationParameters.triggered):
                continue
            sid = station.get_id()
            start = (station.get_parameter(stationParameters.zenith),
                     station.get_parameter(stationParameters.azimuth))

            # use dominant-polarisation channels with acceptable SNR
            dominant = station.get_parameter(
                stationParameters.cr_dominant_polarisation)
            ids, positions = [], []
            for gid in station.get_channel_group_ids():
                chans = list(station.iter_channel_group(gid))
                if not any(ch.has_parameter(channelParameters.SNR)
                           and ch.get_parameter(channelParameters.SNR)
                           > self._cr_snr for ch in chans):
                    continue
                pick = next((ch for ch in chans if np.allclose(
                    det.get_antenna_orientation(sid, ch.get_id()), dominant)),
                    chans[0])
                ids.append(pick.get_id())
                positions.append(det.get_relative_position(sid, gid))
            if len(ids) < 3:
                continue

            ch0 = station.get_channel(ids[0])
            spectra = stack_spectra([station.get_channel(c) for c in ids], self.device)
            zen, azi = self._fit(spectra, ch0.get_frequencies(),
                                 np.asarray(positions), ch0.get_sampling_rate(),
                                 ch0.get_number_of_samples(), start)
            station.set_parameter(stationParameters.zenith, zen)
            station.set_parameter(stationParameters.azimuth, azi)
            station.set_parameter(stationParameters.cr_zenith, zen)
            station.set_parameter(stationParameters.cr_azimuth, azi)


# ---------------------------------------------------------------------------
# Pipeline visualizer (pipelineVisualizer_LOFAR.py:51-430)
# ---------------------------------------------------------------------------

# copied from nuradiomc_tpu/reco/lofar.py:686-704
def check_for_good_ant(event, detector):
    """Per triggered station: channel ids of the dominant polarisation that
    were not flagged (pipelineVisualizer_LOFAR.check_for_good_ant:19-48)."""
    good = {}
    for station in event.get_stations():
        if not station.get_parameter(stationParameters.triggered):
            continue
        sid = station.get_id()
        good[sid] = []
        flagged = set(station.get_parameter(stationParameters.flagged_channels)
                      if station.has_parameter(stationParameters.flagged_channels)
                      else [])
        dominant = np.asarray(station.get_parameter(
            stationParameters.cr_dominant_polarisation))
        for ch in station.iter_channels():
            ori = np.asarray(detector.get_antenna_orientation(sid, ch.get_id()))
            if np.allclose(ori, dominant) and ch.get_id() not in flagged:
                good[sid].append(ch.get_id())
    return good


class pipelineVisualizer(Module):
    """Diagnostic figures from a processed LOFAR event
    (pipelineVisualizer_LOFAR.py:51-430): polarization arrows in the shower
    plane from rolling Stokes parameters (on the module's device), a polar
    plot of the per-station reconstructed arrival directions, and the
    antenna time/fluence map. matplotlib is imported by the plotting
    methods only."""

    @staticmethod
    def _shower_plane_basis(zenith, azimuth, site="lofar"):
        from nuradiomc_tpu_torch.reco.advanced import MAGNETIC_FIELD_VECTORS
        from nuradiomc_tpu_torch.reco.rit import shower_frame
        return shower_frame(zenith, azimuth, MAGNETIC_FIELD_VECTORS[site])

    def plot_polarization(self, event, detector, window_samples=64,
                          site="lofar"):
        """Polarization angle/degree arrows in the (vxB, vxvxB) plane from
        the peak rolling-window Stokes parameters
        (pipelineVisualizer_LOFAR.plot_polarization:70-219)."""
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        from nuradiomc_tpu_torch.utils.trace_stats import get_stokes

        fig, ax = plt.subplots(figsize=(8, 7))
        drew = False
        for station in event.get_stations():
            if not station.get_parameter(stationParameters.triggered):
                continue
            zenith = station.get_parameter(stationParameters.cr_zenith)
            azimuth = station.get_parameter(stationParameters.cr_azimuth)
            e1, e2, v = self._shower_plane_basis(zenith, azimuth, site)
            # onsky -> ground basis for the efield components
            st, ct = np.sin(zenith), np.cos(zenith)
            sp, cp = np.sin(azimuth), np.cos(azimuth)
            e_theta = np.array([ct * cp, ct * sp, -st])
            e_phi = np.array([-sp, cp, 0.0])
            for field in station.get_electric_fields():
                trace = np.asarray(field.get_trace())
                ground = np.outer(e_theta, trace[1]) + np.outer(e_phi, trace[2])
                u, w = e1 @ ground, e2 @ ground
                stokes = host(get_stokes(self.tensor(u), self.tensor(w),
                                         window_samples=window_samples))
                k = int(np.argmax(stokes[0]))
                I, Q, U, V = stokes[:, k]
                pol_angle = 0.5 * np.arctan2(U, Q)
                pol_degree = np.sqrt(Q ** 2 + U ** 2 + V ** 2) / I if I > 0 else 0.0
                pos = np.asarray(field.get_position())
                pu, pw = float(e1 @ pos), float(e2 @ pos)
                ax.quiver(pu, pw, pol_degree * np.cos(pol_angle),
                          pol_degree * np.sin(pol_angle), angles="xy",
                          scale=8.0, color="tab:blue", width=0.004)
                drew = True
        ax.set_xlabel(r"Direction along $v \times B$ [m]")
        ax.set_ylabel(r"Direction along $v \times (v \times B)$ [m]")
        ax.set_title("Polarization in the shower plane")
        ax.set_aspect("equal")
        if not drew:
            ax.text(0.5, 0.5, "no triggered stations with efields",
                    transform=ax.transAxes, ha="center")
        return fig

    # copied from nuradiomc_tpu/reco/lofar.py:770-860
    def show_direction_plot(self, event):
        """Polar scatter of the per-station reconstructed arrival directions
        (pipelineVisualizer_LOFAR.show_direction_plot:221-285)."""
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig, ax = plt.subplots(subplot_kw={"projection": "polar"})
        zeniths, azimuths = [], []
        for station in event.get_stations():
            if not station.get_parameter(stationParameters.triggered):
                continue
            if not station.has_parameter(stationParameters.cr_zenith):
                continue
            zen = station.get_parameter(stationParameters.cr_zenith)
            az = station.get_parameter(stationParameters.cr_azimuth)
            zeniths.append(zen)
            azimuths.append(az)
            ax.scatter(az, np.rad2deg(zen), marker="x",
                       label=f"station {station.get_id()}")
        if zeniths:
            ax.scatter(np.mean(azimuths), np.rad2deg(np.mean(zeniths)),
                       marker="o", color="k", label="combined")
        ax.set_title("Reconstructed arrival directions")
        ax.legend(loc="upper right", bbox_to_anchor=(1.3, 1.1), fontsize=7)
        return fig

    def show_time_fluence_plot(self, event, detector,
                               min_number_good_antennas=4):
        """Antenna positions colored by pulse arrival time, sized by signal
        amplitude (pipelineVisualizer_LOFAR.show_time_fluence_plot:287-396)."""
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        good = check_for_good_ant(event, detector)
        fig, ax = plt.subplots(dpi=150, figsize=(8, 5))
        xs, ys, ts, ss = [], [], [], []
        for sid, channel_ids in good.items():
            if len(channel_ids) < min_number_good_antennas:
                continue
            station = event.get_station(sid)
            for cid in channel_ids:
                ch = station.get_channel(cid)
                if not ch.has_parameter(channelParameters.signal_time):
                    continue
                pos = np.asarray(detector.get_relative_position(sid, cid))
                if hasattr(detector, "get_absolute_position"):
                    pos = pos + detector.get_absolute_position(sid)
                xs.append(pos[0])
                ys.append(pos[1])
                ts.append(ch.get_parameter(channelParameters.signal_time))
                amp = ch.get_parameter(
                    channelParameters.maximum_amplitude_envelope) \
                    if ch.has_parameter(
                        channelParameters.maximum_amplitude_envelope) else 1.0
                ss.append(amp)
        if xs:
            ts = np.asarray(ts) - np.min(ts)
            ss = np.asarray(ss, dtype=float)
            smax = ss.max() if ss.max() > 0 else 1.0
            sc = ax.scatter(xs, ys, c=ts, s=10 + 90 * (ss / smax) ** 2,
                            cmap="viridis")
            fig.colorbar(sc, label="Relative arrival time [ns]", shrink=0.7)
        ax.set_xlabel("Meters east [m]")
        ax.set_ylabel("Meters north [m]")
        ax.set_title("Antenna positions and arrival time")
        return fig

    def run(self, event, detector, save_dir=".", polarization=False,
            direction=False, time_fluence=True):
        """Produce and save the selected figures as
        ``<save_dir>/pipeline_plots_<event_id>.png`` pages
        (pipelineVisualizer_LOFAR.run:398-428)."""
        figs = []
        if polarization:
            figs.append(("polarization", self.plot_polarization(event, detector)))
        if direction:
            figs.append(("direction", self.show_direction_plot(event)))
        if time_fluence:
            figs.append(("time_fluence",
                         self.show_time_fluence_plot(event, detector)))
        paths = []
        for name, fig in figs:
            path = os.path.join(save_dir,
                                f"pipeline_{name}_{event.get_id()}.png")
            fig.savefig(path)
            paths.append(path)
        return paths
