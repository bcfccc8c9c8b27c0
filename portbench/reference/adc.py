# frozen copy of nuradiomc_tpu_torch/ops/adc.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
"""ADC models (torch).

Counterpart of ``nuradiomc_tpu/ops/adc.py`` (adc.py:14-46; reference
analogToDigitalConverter.py:14-130): a perfect floor/ceiling flash
comparator with saturation, LSB = V_range / (2^n - 1). Elementwise over any
shape.
"""

from __future__ import annotations

import math

import torch


def quantize_counts(trace, v_min: float, lsb: float, n_counts: int, mode: str = "floor"):
    """ADC counts as floats: ``fn((trace - v_min) / lsb)`` clipped to
    [0, n_counts - 1] (apply_saturation :91-130), plus ``fn(v_min / lsb)``.
    The division, not a multiply by 1/lsb, is the reference's expression:
    the two round differently at count boundaries. ``lsb`` is a tensor
    divisor, because a CUDA tensor divided by a Python number is multiplied
    by its reciprocal."""
    fn = torch.floor if mode == "floor" else torch.ceil
    f_off = math.floor if mode == "floor" else math.ceil
    div = torch.as_tensor(lsb, dtype=trace.dtype, device=trace.device)
    counts = torch.clamp(fn((trace - v_min) / div), 0, n_counts - 1)
    return counts + f_off(v_min / lsb)
