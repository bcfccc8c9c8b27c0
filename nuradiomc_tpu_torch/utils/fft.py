"""Power-conserving rFFT conventions (torch).

Counterpart of ``nuradiomc_tpu/utils/fft.py``: real time traces transform
with ``rfft / fs * sqrt(2)`` so that ``sum(trace**2) * dt ==
sum(|spectrum|**2) * df`` (approximately; DC and Nyquist also carry the
sqrt(2)). All functions act on the last axis.
"""

from __future__ import annotations

import numpy as np
import torch

from nuradiomc_tpu_torch.utils import device as device_util

_SQRT2 = 1.4142135623730951


def freqs(num_samples: int, sampling_rate: float, device=device_util.DEFAULT,
          dtype=torch.float64) -> torch.Tensor:
    """Frequency bins of the rFFT for a trace of ``num_samples`` samples."""
    return torch.fft.rfftfreq(num_samples, d=1.0 / sampling_rate, dtype=dtype,
                              device=device_util.resolve(device))


def freqs_np(num_samples: int, sampling_rate: float) -> np.ndarray:
    """Host-side (numpy) frequency bins."""
    return np.fft.rfftfreq(num_samples, d=1.0 / sampling_rate)


def time2freq(trace: torch.Tensor, sampling_rate: float) -> torch.Tensor:
    """Forward rFFT with power-conserving normalization (V -> V/GHz)."""
    return torch.fft.rfft(trace, dim=-1) / sampling_rate * _SQRT2


def freq2time(spectrum: torch.Tensor, sampling_rate: float,
              n: int | None = None) -> torch.Tensor:
    """Inverse rFFT with power-conserving normalization (V/GHz -> V)."""
    return torch.fft.irfft(spectrum, n=n, dim=-1) * sampling_rate / _SQRT2
