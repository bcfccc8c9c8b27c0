"""Trace operations in the rFFT domain (torch).

Counterpart of ``nuradiomc_tpu/ops/trace.py``: sub-bin Fourier time shifts
(the plain and the factored phase ramp), FFT resampling, and the Hilbert
envelope of a trace or straight from a one-sided spectrum. All functions act
on the last axis.
"""

from __future__ import annotations

import math

import torch


def time_shift_phase(frequencies: torch.Tensor, dt_shift) -> torch.Tensor:
    """Phase factor exp(-2 pi i f dt) delaying a spectrum by ``dt_shift``
    (trace.py:18)."""
    arg = (-2 * math.pi) * frequencies * dt_shift
    return torch.complex(torch.cos(arg), torch.sin(arg))


def shift_spectrum(spectrum, frequencies, dt_shift):
    """Delay a spectrum by ``dt_shift`` (BaseTrace.apply_time_shift)."""
    return spectrum * time_shift_phase(frequencies, dt_shift)


def time_shift_phase_uniform(n_freqs: int, df: float, dt_shift: torch.Tensor,
                             block: int = 32) -> torch.Tensor:
    """exp(-2 pi i k df dt) for k = 0..n_freqs-1 on a uniform grid
    (trace.py:24): the outer product of two small tables, k = block*a + b
    gives w^k = (w^block)^a * w^b, with theta = (-2 pi df) * dt computed in
    the dtype of ``dt_shift``. Returns [..., n_freqs] complex."""
    real_dtype = dt_shift.dtype
    n_hi = -(-n_freqs // block)
    theta = torch.tensor(-2 * math.pi * df, dtype=real_dtype,
                         device=dt_shift.device) * dt_shift
    b = torch.arange(block, dtype=real_dtype, device=dt_shift.device)
    a = torch.arange(n_hi, dtype=real_dtype, device=dt_shift.device) * block
    tb = theta[..., None] * b
    ta = theta[..., None] * a
    wb = torch.complex(torch.cos(tb), torch.sin(tb))            # [..., B]
    wa = torch.complex(torch.cos(ta), torch.sin(ta))            # [..., A]
    ph = wa[..., :, None] * wb[..., None, :]
    return ph.reshape(*theta.shape, n_hi * block)[..., :n_freqs]


def hilbert_envelope_from_rfft(spectrum: torch.Tensor, n: int,
                               sampling_rate: float) -> torch.Tensor:
    """|analytic signal| from a one-sided V/GHz spectrum by one complex
    ifft with the positive frequencies doubled (trace.py:88); DC and
    Nyquist are taken real, as irfft does."""
    head = torch.complex(spectrum[..., :1].real, torch.zeros_like(spectrum[..., :1].real))
    nyq = torch.complex(spectrum[..., -1:].real, torch.zeros_like(spectrum[..., -1:].real))
    pad = torch.zeros((*spectrum.shape[:-1], n - spectrum.shape[-1]),
                      dtype=spectrum.dtype, device=spectrum.device)
    full = torch.cat([head, 2.0 * spectrum[..., 1:-1], nyq, pad], dim=-1)
    z = torch.fft.ifft(full, dim=-1) * (sampling_rate / math.sqrt(2.0))
    return torch.abs(z)


def hilbert_envelope(trace: torch.Tensor) -> torch.Tensor:
    """|analytic signal| of a real trace (scipy.signal.hilbert convention,
    trace.py:103)."""
    n = trace.shape[-1]
    spec = torch.fft.fft(trace, dim=-1)
    h = torch.zeros(n, dtype=trace.dtype, device=trace.device)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return torch.abs(torch.fft.ifft(spec * h, dim=-1))


def resample_spectrum(spectrum: torch.Tensor, n_in: int, n_out: int) -> torch.Tensor:
    """FFT-domain resampling (trace.py:119): down-sampling truncates the
    spectrum (the new Nyquist bin taken real), up-sampling zero-pads."""
    n_freq_out = n_out // 2 + 1
    n_freq_in = spectrum.shape[-1]
    if n_freq_out <= n_freq_in:
        out = spectrum[..., :n_freq_out].clone()
        if n_out < n_in and n_out % 2 == 0:
            out[..., -1] = out[..., -1].real.to(out.dtype)
        return out
    return torch.nn.functional.pad(spectrum, (0, n_freq_out - n_freq_in))


def scipy_resample(trace: torch.Tensor, num: int) -> torch.Tensor:
    """``scipy.signal.resample(trace, num, axis=-1)`` of a real trace
    (BaseTrace.resample): rfft, copy the bins up to the smaller Nyquist,
    double (down) or halve (up) an even Nyquist bin, irfft to ``num``
    samples, times num / n."""
    n_x = trace.shape[-1]
    X = torch.fft.rfft(trace, dim=-1)
    Y = torch.zeros((*trace.shape[:-1], num // 2 + 1), dtype=X.dtype, device=X.device)
    N = min(num, n_x)
    nyq = N // 2 + 1
    Y[..., :nyq] = X[..., :nyq]
    if N % 2 == 0:
        if num < n_x:
            Y[..., N // 2] *= 2.0
        elif n_x < num:
            Y[..., N // 2] *= 0.5
    return torch.fft.irfft(Y, num, dim=-1) * (float(num) / float(n_x))
