"""Trigger bins with majority logic (torch).

Counterpart of ``nuradiomc_tpu/ops/triggers.py`` (reference
modules/trigger/highLowThreshold.py:13-142, simpleThreshold.py:14-31,
envelopeTrigger.py, multiHighLowThreshold.py:24-58, powerIntegration.py and
the ARA tunnel diode, utilities/diodeSimulator.py): strict ``>=``/``<=``
comparisons, sliding windows with left zero padding so a trigger bin sits at
the last sample of its window, and the first triggered bin by argmax (0 when
nothing fired). All functions act on the last (time) axis.
"""

from __future__ import annotations

import math

import torch


def _shift_right_zero(x: torch.Tensor, s: int) -> torch.Tensor:
    """x shifted right by s along the last axis, zero-filled (triggers.py:22)."""
    return torch.nn.functional.pad(x[..., :-s], (s, 0))


def _sliding_window_any(x: torch.Tensor, window: int) -> torch.Tensor:
    """out[i] = any(x[max(0, i-window+1) .. i]), as a prefix count:
    P[i] - P[i-window] > 0 with zeros to the left."""
    p = torch.cumsum(x.to(torch.int32), dim=-1)
    shifted = torch.zeros_like(p)
    if window < p.shape[-1]:
        shifted[..., window:] = p[..., :-window]
    return (p - shifted) > 0


def get_threshold_triggers(trace, threshold):
    """|V| >= threshold per sample."""
    return torch.abs(trace) >= threshold


def get_high_low_triggers(trace, high_threshold, low_threshold,
                          time_coincidence, dt):
    """Bins where a high and a low crossing both fall inside the
    coincidence window (step = 1 path)."""
    n_bins = max(int(round(time_coincidence / dt)), 1)
    hi = _sliding_window_any(trace >= high_threshold, n_bins)
    lo = _sliding_window_any(trace <= low_threshold, n_bins)
    return hi & lo


def majority_logic(tts, number_of_coincidences: int, time_coincidence, dt):
    """Station majority trigger over the channel axis (-2).

    Returns (triggered [...], triggered_bins [..., n], first_bin [...]);
    the first bin is 0 when the station did not trigger.
    """
    n_samples = tts.shape[-1]
    n_bins = min(max(int(round(time_coincidence / dt)), 1), n_samples)
    widened = _sliding_window_any(tts, n_bins)
    count = torch.sum(widened.to(torch.int32), dim=-2)
    ttt = count >= number_of_coincidences
    triggered = torch.any(ttt, dim=-1)
    first = torch.argmax(ttt.to(torch.int8), dim=-1)
    return triggered, ttt, first


def get_envelope_triggers(trace, threshold):
    """Hilbert-envelope threshold trigger (envelopeTrigger.py:14-31)."""
    from nuradiomc_tpu_torch.ops.trace import hilbert_envelope

    return hilbert_envelope(trace) > threshold


def get_multiple_high_low_triggers(trace, high_threshold, low_threshold,
                                   n_high_lows: int, time_coincidence, dt):
    """n high/low crossings within a window (multiHighLowThreshold.py:24-58):
    rising edges of the strict high and low conditions, counted over the
    trailing ``int(time_coincidence / dt)`` bins, and the rising edge of
    count >= n_high_lows."""
    nc = max(int(time_coincidence / dt), 1)

    def rising_edge(mask):
        return mask & ~_shift_right_zero(mask, 1)

    crossings = (rising_edge(trace > high_threshold).to(torch.int64)
                 + rising_edge(trace < low_threshold).to(torch.int64))
    c = torch.cumsum(crossings, dim=-1)
    tsum = c - _shift_right_zero(c, nc) if nc < c.shape[-1] else c
    cond = tsum >= n_high_lows
    return rising_edge(cond)


# AraSim tunnel-diode response parameters (utilities/diodeSimulator.py:38-45)
_TD_DOWN1 = (-0.8, 15.0, 2.3)      # (amp, mu [ns], sigma [ns])
_TD_DOWN2 = (-0.2, 15.0, 4.0)
_TD_UP_MU, _TD_UP_SIGMA = 18.0, 7.0


def tunnel_diode_response(times: torch.Tensor) -> torch.Tensor:
    """Dimensionless AraSim diode impulse response on a time grid (ns)."""
    up_amp = (-math.sqrt(2 * math.pi)
              * (_TD_DOWN1[0] * _TD_DOWN1[2] + _TD_DOWN2[0] * _TD_DOWN2[2])
              / (2.0 * _TD_UP_SIGMA ** 3))
    down1 = _TD_DOWN1[0] * torch.exp(-(times - _TD_DOWN1[1]) ** 2 / (2 * _TD_DOWN1[2] ** 2))
    down2 = _TD_DOWN2[0] * torch.exp(-(times - _TD_DOWN2[1]) ** 2 / (2 * _TD_DOWN2[2] ** 2))
    up = up_amp * (times - _TD_UP_MU) ** 2 * torch.exp(-(times - _TD_UP_MU) / _TD_UP_SIGMA)
    return down1 + down2 + torch.where(times > _TD_UP_MU, up, 0.0)


def tunnel_diode(trace, sampling_rate, antenna_resistance=8.5 * 1.602176462e-10):
    """Power trace after the AraSim tunnel diode (diodeSimulator.tunnel_diode
    :59-96): V^2/R convolved with the 3-term impulse response on its 100 ns
    grid, by FFT, truncated to the trace length. The default resistance is
    8.5 ohm in internal units (diodeSimulator.py:83)."""
    n = trace.shape[-1]
    n_resp = int(100.0 * sampling_rate) + 1
    times = torch.linspace(0.0, 100.0, n_resp, dtype=trace.dtype, device=trace.device)
    diode = tunnel_diode_response(times)
    power = trace * trace / antenna_resistance
    m = n + n_resp
    P = torch.fft.rfft(power, n=m, dim=-1)
    D = torch.fft.rfft(diode, n=m)
    conv = torch.fft.irfft(P * D, n=m, dim=-1)[..., :n]
    return conv / sampling_rate


def ara_diode_trigger(trace, sampling_rate, power_mean, power_std, threshold_sigma):
    """ARA tunnel-diode trigger bins: diode output below
    mean - |threshold| * std (ARA/triggerSimulator.py:26-60)."""
    out = tunnel_diode(trace, sampling_rate)
    return out < (power_mean - power_std * abs(threshold_sigma))


def power_integration_triggers(trace, window, threshold, dt):
    """Sliding-window power sum above threshold (powerIntegration.py
    semantics): int V^2 dt over ``window`` > threshold."""
    n_bins = max(int(round(window / dt)), 1)
    c = torch.cumsum(trace * trace, dim=-1)
    return (c - _shift_right_zero(c, n_bins)) * dt > threshold
