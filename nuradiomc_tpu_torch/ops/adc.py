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


def perfect_comparator(trace, adc_n_bits: int, adc_voltage_range,
                       output: str = "voltage", mode: str = "floor"):
    """Quantize a voltage trace (perfect_comparator:14-90);
    ``adc_voltage_range`` is (v_min, v_max)."""
    v_min, v_max = adc_voltage_range
    lsb = (v_max - v_min) / (2 ** adc_n_bits - 1)
    counts = quantize_counts(trace, v_min, lsb, 2 ** adc_n_bits, mode)
    if output == "voltage":
        return lsb * counts
    if output == "counts":
        return counts.to(torch.int32)
    raise ValueError(f"unknown ADC output {output}")


def perfect_floor_comparator(trace, adc_n_bits, adc_voltage_range, output="voltage"):
    return perfect_comparator(trace, adc_n_bits, adc_voltage_range, output, "floor")


def perfect_ceiling_comparator(trace, adc_n_bits, adc_voltage_range, output="voltage"):
    return perfect_comparator(trace, adc_n_bits, adc_voltage_range, output, "ceil")


def symmetric_range(noise_vrms, noise_n_lsb: int, adc_n_bits: int):
    """ADC range chosen so the noise RMS spans ``noise_n_lsb`` counts."""
    lsb = noise_vrms / noise_n_lsb
    half = lsb * 2 ** (adc_n_bits - 1)
    return (-half, half)
