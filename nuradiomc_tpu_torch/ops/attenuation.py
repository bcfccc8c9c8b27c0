"""Frequency- and depth-dependent ice attenuation lengths (torch).

Counterpart of ``nuradiomc_tpu/ops/attenuation.py``: the five models
SP1/GL1/GL2/GL3/MB1 (reference NuRadioMC/utilities/attenuation.py:145-262).
Depth ``z`` is negative below the surface; frequencies are in internal
units; every function broadcasts over any batch shape. The GL3 slope/offset
table is the port's own copy of ``data/GL3_params.csv``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from nuradiomc_tpu_torch.utils import units

MODELS = ("SP1", "GL1", "GL2", "GL3", "MB1")

_GL3 = np.genfromtxt(
    os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "GL3_params.csv"),
    delimiter=",",
)  # columns: positive depth [m], slope, offset
_MIN_LENGTH = 1.0 * units.m


def interp(x, xp, fp):
    """``numpy.interp`` for tensors: piecewise-linear in the ascending 1-D
    ``xp``, the end values held outside it. ``fp`` is ``[..., len(xp)]`` and
    broadcasts against ``x`` over its leading axes (``fp`` 1-D: any ``x``)."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True) - 1, 0, n - 2)
    x0, x1 = xp[i], xp[i + 1]
    if fp.dim() == 1:
        f0, f1 = fp[i], fp[i + 1]
    else:
        fp = fp.expand(*x.shape[:-1], n)
        f0, f1 = torch.gather(fp, -1, i), torch.gather(fp, -1, i + 1)
    t = torch.clamp((x - x0) / (x1 - x0), 0.0, 1.0)
    return f0 + t * (f1 - f0)


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


def _sp1(z, frequency):
    t = _sp1_temperature(z)
    w0 = math.log(0.0001)
    w1 = 0.0
    w2 = math.log(3.16)
    w = torch.log(frequency / units.GHz)
    b0 = -6.74890 + t * (0.026709 - t * 0.000884)
    b1 = -6.22121 - t * (0.070927 + t * 0.001773)
    b2 = -4.09468 - t * (0.002213 + t * 0.000332)
    # piecewise in frequency: below 1 GHz interpolate (b0, b1), above (b1, b2)
    lo = frequency < 1.0 * units.GHz
    a = torch.where(lo, (b1 * w0 - b0 * w1) / (w0 - w1), (b2 * w1 - b1 * w2) / (w1 - w2))
    bb = torch.where(lo, (b1 - b0) / (w1 - w0), (b2 - b1) / (w2 - w1))
    return 1.0 / torch.exp(a + bb * w)


def _polyval_ascending(coeffs, x):
    """sum_k coeffs[k] x^k by Horner, highest power first as jnp.polyval."""
    y = torch.zeros_like(x)
    for c in coeffs[::-1]:
        y = y * x + c
    return y


def _gl1_75mhz(z):
    """GL1 attenuation length at 75 MHz vs depth (attenuation.py:99-129)."""
    coeffs = (1.16052586e03, 6.87257150e-02, -9.82378264e-05,
              -3.50628312e-07, -2.21040482e-10, -3.63912864e-14)
    return torch.clamp(_polyval_ascending(coeffs, z / units.m), min=100.0 * units.m)


def _gl1(z, frequency):
    return _gl1_75mhz(z) - 0.55 * units.m * (frequency / units.MHz - 75.0)


def _gl2(z, frequency):
    fit = (1.20547286e00, 1.58815679e-05, -2.58901767e-07,
           -5.16435542e-10, -2.89124473e-13, -4.58987344e-17)
    bulk = 852.0 * units.m - 0.54 * (units.m / units.MHz) * frequency
    return bulk * _polyval_ascending(fit, z)


def _gl3(z, frequency):
    d = -z  # the table is indexed by positive depth
    depth, slope, offset = (torch.as_tensor(np.ascontiguousarray(_GL3[:, k]), dtype=z.dtype, device=z.device)
                            for k in range(3))
    return interp(d, depth, slope) * frequency + interp(d, depth, offset)


def _mb1(z, frequency):
    R = 0.82
    d_ice = 576 * units.m
    att = 460 * units.m - 180 * (units.m / units.GHz) * frequency
    att = att / (1 + att / (2 * d_ice) * math.log(R))
    d = -z * 420.0 * units.m / d_ice
    L = 1250.0 * 0.08886 * torch.exp(
        -0.048827 * (225.6746 - 86.517596 * torch.log10(848.870 - d)))
    return att * L / 231.21 * units.m


_DISPATCH = {"SP1": _sp1, "GL1": _gl1, "GL2": _gl2, "GL3": _gl3, "MB1": _mb1}


def get_attenuation_length(z, frequency, model: str):
    """Attenuation length L(z, f); clipped below at 1 m, inf above the surface
    (``attenuation.get_attenuation_length``, :155)."""
    if model not in _DISPATCH:
        raise NotImplementedError(f"attenuation model {model} is not implemented")
    z, frequency = torch.broadcast_tensors(torch.as_tensor(z), torch.as_tensor(frequency))
    att = torch.clamp(_DISPATCH[model](z, frequency), min=_MIN_LENGTH)
    return torch.where(z > 0, torch.inf, att)


def inv_length_factored(z, frequencies, model: str):
    """1/L(z, f) on the outer grid [*z.shape, F], with the z-only
    coefficients computed once per depth (``attenuation.inv_length_factored``,
    :121). Clamps as get_attenuation_length: L >= 1 m, 1/L = 0 above the
    surface. SP1 is exp-affine in ln f; the other models take the broadcast
    evaluation."""
    if model != "SP1":
        return 1.0 / get_attenuation_length(z[..., None], frequencies, model)
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
