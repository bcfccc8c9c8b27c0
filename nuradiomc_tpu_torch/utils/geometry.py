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

import math

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


def onsky_to_ground(v_onsky, zenith, azimuth):
    """Inverse of :func:`ground_to_onsky` (the basis is orthonormal)."""
    basis = onsky_basis(zenith, azimuth)
    return torch.einsum("...ji,...j->...i", basis, v_onsky)


# ---- Fresnel coefficients (from medium n_1 into / off medium n_2) -----------

def _real(x) -> torch.Tensor:
    """A tensor as it is; a number or array as a float64 tensor."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float64)


def fresnel_angle(zenith_incoming, n_2=1.3, n_1=1.0):
    """Snell's-law refraction angle, NaN beyond total internal reflection
    (geometry.py:68; geometryUtilities.get_fresnel_angle:115-141)."""
    zenith_incoming = _real(zenith_incoming)
    t = n_1 / n_2 * torch.sin(zenith_incoming)
    angle = torch.arcsin(torch.clamp(t, -1.0, 1.0))
    angle = torch.where(zenith_incoming > 0.5 * math.pi, math.pi - angle, angle)
    return torch.where(torch.abs(t) > 1.0, torch.full_like(angle, math.nan), angle)


def fresnel_t_p(zenith_incoming, n_2=1.3, n_1=1.0):
    """Transmission amplitude for p / eTheta (0 beyond TIR)."""
    zenith_incoming = _real(zenith_incoming)
    out = fresnel_angle(zenith_incoming, n_2, n_1)
    t = 2 * n_1 * torch.cos(zenith_incoming) / (n_1 * torch.cos(out)
                                                + n_2 * torch.cos(zenith_incoming))
    return torch.where(torch.isnan(out), torch.zeros_like(t), t)


def fresnel_t_s(zenith_incoming, n_2=1.3, n_1=1.0):
    """Transmission amplitude for s / ePhi (0 beyond TIR)."""
    zenith_incoming = _real(zenith_incoming)
    out = fresnel_angle(zenith_incoming, n_2, n_1)
    t = 2 * n_1 * torch.cos(zenith_incoming) / (n_1 * torch.cos(zenith_incoming)
                                                + n_2 * torch.cos(out))
    return torch.where(torch.isnan(out), torch.zeros_like(t), t)


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
