"""Noise-trigger-rate estimation and threshold tuning (torch).

Counterpart of ``nuradiomc_tpu/sim/noise_rate.py`` (the reference's
thermal-noise trigger-rate generators, NuRadioReco/utilities/noise.py:
278-560, thermalNoiseGeneratorPhasedArray): the threshold for a target
noise-trigger rate (the 100 Hz point of RNO-G's 4-channel deep phased
array) is read off the distribution of the maximum windowed beam power over
pure-noise traces, millions of them in batched device computations.

The JAX function draws and transforms in one; here the draw
(:func:`ops.noise.bandlimited_noise_spectrum` from a ``torch.Generator``)
and the transform (:func:`max_beam_power_from_spectra`) are apart, so the
transform can be held to the JAX package's on the numbers ``jax.random``
drew. The chain is plain torch operations, as the JAX package's is (not
the phased-array kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from nuradiomc_tpu_torch.ops import adc as adc_ops
from nuradiomc_tpu_torch.ops import noise as noise_ops
from nuradiomc_tpu_torch.ops import phased_array
from nuradiomc_tpu_torch.ops import trace as trace_ops
from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils import fft

FS_HI = 5.0    # the intermediate rate of the ADC path, GHz (noise_rate.py:55)


def max_beam_power_from_spectra(spectra, n_samples: int, sampling_rate: float,
                                filter_response, rolls, window: int, step: int,
                                adc_fs: float = None, adc_nbits: int = 8,
                                adc_range: float = 0.0, upsampling: int = 2):
    """Maximum sliding-window beam power [B] of noise spectra [B, C, F]
    (noise_rate.py:28-76 after the draw): x filter -> (optional resample to
    5 GHz, decimation to ``adc_fs`` and an ``adc_nbits`` floor ADC over
    +-adc_range/2) -> FFT upsampling -> beams -> power sums -> maximum."""
    filt = torch.as_tensor(filter_response, device=spectra.device).to(spectra.dtype)
    traces = fft.freq2time(spectra * filt, sampling_rate, n=n_samples)       # [B, C, N]
    fs, n = sampling_rate, n_samples
    if adc_fs is not None:
        n_hi = int(round(n * FS_HI / fs))
        decim = int(round(FS_HI / adc_fs))
        spec_hi = trace_ops.resample_spectrum(fft.time2freq(traces, fs), n, n_hi)
        traces = fft.freq2time(spec_hi, FS_HI, n=n_hi)[..., ::decim]
        fs = adc_fs
        n = traces.shape[-1]
        traces = adc_ops.perfect_floor_comparator(traces, adc_nbits,
                                                  (-adc_range / 2, adc_range / 2))
    if upsampling > 1:
        spec = trace_ops.resample_spectrum(fft.time2freq(traces, fs), n, n * upsampling)
        fs = fs * upsampling
        n = n * upsampling
        traces = fft.freq2time(spec, fs, n=n)
    beams = phased_array.phase_signals(traces, rolls)                        # [B, beams, n]
    power, _ = phased_array.power_sum(beams, window, step)
    return torch.amax(power, dim=(-2, -1))


def max_beam_power_batch(generator: torch.Generator, n_batch: int, n_samples: int,
                         sampling_rate: float, amplitude: float, filter_response, rolls,
                         n_channels: int, window: int, step: int, adc_fs: float = None,
                         adc_nbits: int = 8, adc_range: float = 0.0, upsampling: int = 2,
                         dtype=torch.float32):
    """Maximum beam power of ``n_batch`` pure-noise traces drawn from
    ``generator`` (on its device): white Rayleigh noise up to the Nyquist
    frequency, then :func:`max_beam_power_from_spectra`."""
    spectra = noise_ops.bandlimited_noise_spectrum(
        generator, (n_batch, n_channels), n_samples, sampling_rate, amplitude, None,
        sampling_rate / 2, "rayleigh", dtype)
    return max_beam_power_from_spectra(spectra, n_samples, sampling_rate, filter_response,
                                       rolls, window, step, adc_fs, adc_nbits, adc_range,
                                       upsampling)


# copied from nuradiomc_tpu/sim/noise_rate.py:79-87 (estimate_rate_curve)
def estimate_rate_curve(thresholds, max_powers: np.ndarray, trace_duration: float):
    """Noise-trigger rate vs threshold from max-power samples.

    rate(T) ~= P(max power over one trace > T) / trace_duration (valid for
    rates << 1/duration, the tuning regime).
    """
    max_powers = np.sort(np.asarray(max_powers))
    frac = 1.0 - np.searchsorted(max_powers, thresholds) / len(max_powers)
    return frac / trace_duration


# copied from nuradiomc_tpu/sim/noise_rate.py:90-96 (tune_threshold)
def tune_threshold(target_rate: float, max_powers: np.ndarray,
                   trace_duration: float) -> float:
    """Threshold whose noise-trigger rate equals ``target_rate``
    (quantile of the max-power distribution)."""
    p_per_trace = target_rate * trace_duration
    q = np.clip(1.0 - p_per_trace, 0.0, 1.0)
    return float(np.quantile(np.asarray(max_powers), q))


def chunk_generator(seed: int, chunk: int, device) -> torch.Generator:
    """The generator of chunk ``chunk``, seeded from
    ``SeedSequence([seed, chunk])``: a chunk draws the same numbers however
    many chunks run before it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), int(chunk)])
                        .generate_state(1, np.uint64)[0]))
    return gen


def run_phased_array_tuning(n_traces: int, n_samples: int, sampling_rate: float,
                            amplitude: float, filter_response, rolls, n_channels: int,
                            window: int, step: int, seed: int = 0, batch: int = 4096,
                            device=device_util.DEFAULT, **kwargs) -> np.ndarray:
    """Max-power samples [n_traces] (host numpy) over ``n_traces`` noise
    traces in chunks of ``batch`` (noise_rate.py:99-111), one generator per
    chunk (:func:`chunk_generator`); ``kwargs`` go to
    :func:`max_beam_power_batch` (``dtype``, the ADC)."""
    dev = device_util.resolve(device)
    out = []
    for chunk in range(int(np.ceil(n_traces / batch))):
        out.append(max_beam_power_batch(
            chunk_generator(seed, chunk, dev), batch, n_samples, sampling_rate, amplitude,
            filter_response, rolls, n_channels, window, step, **kwargs))
    return torch.cat(out).cpu().numpy()[:n_traces]
