# frozen copy of nuradiomc_tpu_torch/utils/fft.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
"""Power-conserving rFFT conventions (torch).

Counterpart of ``nuradiomc_tpu/utils/fft.py``: real time traces transform
with ``rfft / fs * sqrt(2)`` so that ``sum(trace**2) * dt ==
sum(|spectrum|**2) * df`` (approximately; DC and Nyquist also carry the
sqrt(2)). All functions act on the last axis.
"""

from __future__ import annotations

import torch


_SQRT2 = 1.4142135623730951


def freq2time(spectrum: torch.Tensor, sampling_rate: float,
              n: int | None = None) -> torch.Tensor:
    """Inverse rFFT with power-conserving normalization (V/GHz -> V)."""
    return torch.fft.irfft(spectrum, n=n, dim=-1) * sampling_rate / _SQRT2
