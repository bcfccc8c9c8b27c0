# frozen copy of nuradiomc_tpu_torch/utils/geometry.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
"""Spherical transforms and Fresnel coefficients (torch).

Counterpart of ``nuradiomc_tpu/utils/geometry.py``. Conventions:

* ``zenith = arccos(z / r)``, ``azimuth = arctan2(y, x)``
* on-sky basis for a direction (zenith t, azimuth p):
    eR     = (sin t cos p, sin t sin p, cos t)
    eTheta = (cos t cos p, cos t sin p, -sin t)
    ePhi   = (-sin p, cos p, 0)
* Fresnel: eTheta is the p polarization, ePhi the s polarization.
"""

from __future__ import annotations


import torch


def cartesian_to_spherical(v: torch.Tensor):
    """(..., 3) cartesian vector -> (zenith, azimuth)."""
    r = torch.linalg.vector_norm(v, dim=-1)
    safe_r = torch.where(r == 0, torch.ones_like(r), r)
    zenith = torch.arccos(torch.clamp(v[..., 2] / safe_r, -1.0, 1.0))
    azimuth = torch.atan2(v[..., 1], v[..., 0])
    return zenith, azimuth


def spherical_to_cartesian(zenith: torch.Tensor, azimuth: torch.Tensor):
    """(zenith, azimuth) -> unit vector of shape (..., 3)."""
    st, ct = torch.sin(zenith), torch.cos(zenith)
    sp, cp = torch.sin(azimuth), torch.cos(azimuth)
    return torch.stack([st * cp, st * sp, ct], dim=-1)


def onsky_basis(zenith: torch.Tensor, azimuth: torch.Tensor):
    """Rows (eR, eTheta, ePhi) for the given direction; shape (..., 3, 3)."""
    st, ct = torch.sin(zenith), torch.cos(zenith)
    sp, cp = torch.sin(azimuth), torch.cos(azimuth)
    zeros = torch.zeros_like(st)
    e_r = torch.stack([st * cp, st * sp, ct], dim=-1)
    e_theta = torch.stack([ct * cp, ct * sp, -st], dim=-1)
    e_phi = torch.stack([-sp, cp, zeros], dim=-1)
    return torch.stack([e_r, e_theta, e_phi], dim=-2)


def ground_to_onsky(v, zenith, azimuth):
    """Project cartesian vector(s) onto the on-sky basis -> (vR, vTheta, vPhi)."""
    basis = onsky_basis(zenith, azimuth)
    return torch.einsum("...ij,...j->...i", basis, v)


# ---- Fresnel coefficients (from medium n_1 into / off medium n_2) -----------


def _csqrt(x: torch.Tensor) -> torch.Tensor:
    """Principal-branch complex sqrt of a real tensor (scimath.sqrt
    semantics): complex64 for float32 input, complex128 for float64
    (``geometry._csqrt``, geometry.py:92)."""
    if not x.is_complex():
        x = torch.complex(x, torch.zeros_like(x))
    return torch.sqrt(x)


def fresnel_r_p(zenith_incoming, n_2=1.3, n_1=1.0):
    """Reflection amplitude for p / eTheta (complex beyond TIR):
    conj((n^2 cos t - sqrt(n^2 - sin^2 t)) / (n^2 cos t + sqrt(...))),
    n = n_2 / n_1 (geometryUtilities.get_fresnel_r_p:208-235)."""
    n = n_2 / n_1
    ct = torch.cos(zenith_incoming)
    root = _csqrt(n ** 2 - torch.sin(zenith_incoming) ** 2)
    return torch.conj_physical((n ** 2 * ct - root) / (n ** 2 * ct + root))


def fresnel_r_s(zenith_incoming, n_2=1.3, n_1=1.0):
    """Reflection amplitude for s / ePhi (complex beyond TIR)."""
    n = n_2 / n_1
    ct = torch.cos(zenith_incoming)
    root = _csqrt(n ** 2 - torch.sin(zenith_incoming) ** 2)
    return torch.conj_physical((ct - root) / (ct + root))
