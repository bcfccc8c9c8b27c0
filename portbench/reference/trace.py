# frozen copy of nuradiomc_tpu_torch/ops/trace.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
"""Trace operations in the rFFT domain (torch).

Counterpart of ``nuradiomc_tpu/ops/trace.py``: sub-bin Fourier time shifts
(the plain and the factored phase ramp), FFT resampling, and the Hilbert
envelope of a trace or straight from a one-sided spectrum. All functions act
on the last axis.
"""

from __future__ import annotations

import math

import torch


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
