# frozen copy of nuradiomc_tpu_torch/ops/attenuation.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
"""Frequency- and depth-dependent ice attenuation lengths (torch).

Counterpart of ``nuradiomc_tpu/ops/attenuation.py``, cut to SP1
(reference NuRadioMC/utilities/attenuation.py:145-262), the one model that
the benchmark's configurations use; another model is added with the first
cell that needs it. Depth ``z`` is negative below the surface; frequencies
are in internal units; every function broadcasts over any batch shape.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import units

MODELS = ("SP1",)
_MIN_LENGTH = 1.0 * units.m


def _sp1_temperature(z):
    """South Pole ice temperature in Celsius vs depth (attenuation.py:137-151)."""
    z2 = torch.abs(z) / units.m
    return 1.83415e-09 * z2 ** 3 - 1.59061e-08 * z2 ** 2 + 0.00267687 * z2 - 51.0696


def sp1_w_coeffs(z):
    """SP1's 1/L(z, f) = exp(b1(z) + bb(z) * w), w = ln(f/GHz): returns
    (b1, bb_lo, bb_hi), bb chosen by branch (f < 1 GHz -> lo). Both branches
    share the intercept b1 at w = 0 (``attenuation.sp1_w_coeffs``, :40)."""
    t = _sp1_temperature(z)
    w0 = torch.log(torch.tensor(0.0001, dtype=t.dtype, device=t.device))
    w2 = torch.log(torch.tensor(3.16, dtype=t.dtype, device=t.device))
    b0 = -6.74890 + t * (0.026709 - t * 0.000884)
    b1 = -6.22121 - t * (0.070927 + t * 0.001773)
    b2 = -4.09468 - t * (0.002213 + t * 0.000332)
    return b1, (b1 - b0) / (-w0), (b2 - b1) / w2


def inv_length_factored(z, frequencies, model: str):
    """1/L(z, f) on the outer grid [*z.shape, F], with the z-only
    coefficients computed once per depth (``attenuation.inv_length_factored``,
    :121). Clamps L >= 1 m, 1/L = 0 above the surface. SP1 is exp-affine
    in ln f."""
    if model not in MODELS:
        raise NotImplementedError(f"attenuation model {model} is not in the benchmark's reference")
    t = _sp1_temperature(z)
    w0 = math.log(0.0001)
    w2 = math.log(3.16)
    b0 = -6.74890 + t * (0.026709 - t * 0.000884)
    b1 = -6.22121 - t * (0.070927 + t * 0.001773)
    b2 = -4.09468 - t * (0.002213 + t * 0.000332)
    a_lo = (b1 * w0 - b0 * 0.0) / w0
    bb_lo = (b1 - b0) / (0.0 - w0)
    a_hi = (b2 * 0.0 - b1 * w2) / (0.0 - w2)
    bb_hi = (b2 - b1) / (w2 - 0.0)
    w = torch.log(frequencies / units.GHz)
    lo = frequencies < 1.0 * units.GHz
    a = torch.where(lo, a_lo[..., None], a_hi[..., None])
    bb = torch.where(lo, bb_lo[..., None], bb_hi[..., None])
    inv = torch.exp(a + bb * w)
    inv = torch.clamp(inv, max=1.0 / _MIN_LENGTH)
    return torch.where(z[..., None] > 0, torch.zeros_like(inv), inv)
