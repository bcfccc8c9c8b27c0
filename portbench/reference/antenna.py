# frozen copy of nuradiomc_tpu_torch/ops/antenna.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
"""Antenna vector effective length (torch + numpy host helpers).

Counterpart of ``nuradiomc_tpu/ops/antenna.py``. The analytic models
(reference NuRadioReco/detector/antennapattern.py:1580-1770) factorize into
a complex frequency template per (channel, LPDA sector), built once on the
host in numpy, and a frequency-independent mixing scalar per (direction,
channel) computed on the device by :func:`analytic_vel_mix`;
:func:`analytic_vel` is their product. Tabulated patterns (pickled VEL
grids, antennapattern.py:1426-1580) are :class:`AntennaTable` with trilinear
complex interpolation per direction (:func:`table_vel`).

The numpy helpers ``_parametric_phase``, ``_hann``,
``build_analytic_template`` and ``antenna_rotation_matrix`` are verbatim
copies of the JAX package's (antenna.py:47, :66, :71, :111): that module
imports jax, so the port cannot import them.
"""

from __future__ import annotations


import numpy as np
import torch

from portbench.reference import units
from portbench.reference import geometry

KIND_LPDA = 0
KIND_VPOL = 1
KIND_HPOL = 2

ANALYTIC_MODELS = {
    "analytic_LPDA": (KIND_LPDA, 110 * units.MHz, 0.55 * units.m),
    "analytic_VPol": (KIND_VPOL, 220 * units.MHz, 0.18 * units.m),
    "analytic_HPol": (KIND_HPOL, 500 * units.MHz, 0.055 * units.m),
}

# antenna-frame (WIPL-D) reference orientation of the analytic models
_MODEL_ORIENTATION = (0.0, 0.0, 90 * units.deg, 0.0)


# copied from nuradiomc_tpu/ops/antenna.py:47 (_parametric_phase)
def _parametric_phase(freq: np.ndarray, phase_type: str) -> np.ndarray:
    """Analytic group-delay phases (antennapattern.py:1642-1670)."""
    if phase_type == "frontlobe_lpda":
        a = 100 * (freq - 400 * units.MHz) ** 2 - 20
        hi = freq > 400 * units.MHz
        a[hi] -= 0.00007 * (freq[hi] - 400 * units.MHz) ** 2
    elif phase_type == "side_lpda":
        a = 40 * (freq - 950 * units.MHz) ** 2 - 40
    elif phase_type == "back_lpda":
        a = 50 * (freq - 950 * units.MHz) ** 2 - 50
    elif phase_type == "VPol_third_order":
        a = 2.086 - 117.917 * freq + 74.567 / 2 * freq ** 2 - 64.343 / 3 * freq ** 3
    elif phase_type == "HPol_third_order":
        a = 0.321 - 11.400 * freq + 39.590 / 2 * freq ** 2 - 38.181 / 3 * freq ** 3
    else:
        raise ValueError(phase_type)
    return a


# copied from nuradiomc_tpu/ops/antenna.py:66 (_hann)
def _hann(M: int) -> np.ndarray:
    n = np.arange(M)
    return 0.5 - 0.5 * np.cos(2 * np.pi * n / (M - 1)) if M > 1 else np.ones(M)


# copied from nuradiomc_tpu/ops/antenna.py:71 (build_analytic_template)
def build_analytic_template(model: str, freqs: np.ndarray) -> np.ndarray:
    """Complex frequency templates ``T_k(f)`` of an analytic antenna.

    Returns an array [K, F]: K = 3 phase sectors for the LPDA
    (frontlobe/side/back, antennapattern.py:1700-1707), K = 1 otherwise.
    Host-side numpy; run once at pipeline build.
    """
    kind, cutoff, max_vel = ANALYTIC_MODELS[model]
    freqs = np.asarray(freqs, dtype=float)
    fmask = freqs > 0
    index = int(np.argmax(freqs > cutoff))
    gain_filter = _hann(2 * index) if index > 0 else np.ones(0)

    if kind in (KIND_LPDA, KIND_VPOL):
        gain = np.ones_like(freqs)
        if kind == KIND_VPOL:
            gain[fmask] /= np.sqrt(freqs[fmask])
        T = np.zeros_like(freqs)
        T[fmask] = np.sqrt(gain[fmask]) / freqs[fmask]
        if index > 0:
            T[:index] *= gain_filter[:index]
        T[fmask] *= max_vel / np.max(T[fmask])
    else:  # HPol: gain peaks at cutoff frequency (antennapattern.py:1743-1760)
        T = np.zeros_like(freqs)
        T[fmask] = np.sin(freqs[fmask] / cutoff * np.pi / 2) ** 2
        T[freqs > cutoff * 2] = 0.0
        m = np.max(T[fmask])
        if m > 0:
            T[fmask] *= max_vel / m

    if kind == KIND_LPDA:
        out = np.zeros((3, len(freqs)), dtype=complex)
        for k, pt in enumerate(["frontlobe_lpda", "side_lpda", "back_lpda"]):
            out[k] = T * np.exp(1j * _parametric_phase(freqs, pt))
        return out
    if kind == KIND_VPOL:
        return (T * np.exp(1j * _parametric_phase(freqs, "VPol_third_order")))[None, :]
    return (T * np.exp(1j * _parametric_phase(freqs, "HPol_third_order")))[None, :]


# copied from nuradiomc_tpu/ops/antenna.py:111 (antenna_rotation_matrix)
def antenna_rotation_matrix(orientation_theta, orientation_phi,
                            rotation_theta, rotation_phi,
                            model_orientation=_MODEL_ORIENTATION) -> np.ndarray:
    """rot = E^-1 A mapping global -> antenna-frame directions
    (antennapattern.py:1190-1216). Host-side numpy, per channel."""
    def basis(theta, phi, rtheta, rphi):
        e1 = np.array([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)])
        e2 = np.array([np.sin(rtheta) * np.cos(rphi), np.sin(rtheta) * np.sin(rphi), np.cos(rtheta)])
        e3 = np.cross(e1, e2)
        if np.linalg.norm(e3) < 0.9:
            raise ValueError("antenna orientation and rotation vectors are not perpendicular")
        return np.array([e1, e2, e3])

    E = basis(*model_orientation)
    A = basis(orientation_theta, orientation_phi, rotation_theta, rotation_phi)
    return np.linalg.inv(E) @ A


def _direction_factors(kind, theta_a, phi_a):
    """Raw-pattern direction factors (d_theta, d_phi) in the antenna frame."""
    zero = torch.zeros_like(theta_a)
    d_theta_lpda = torch.cos(theta_a) * torch.sin(phi_a) * torch.cos(theta_a / 2)
    d_phi_lpda = torch.cos(theta_a / 2) * torch.cos(phi_a)
    d_theta = torch.where(kind == KIND_LPDA, d_theta_lpda,
                          torch.where(kind == KIND_VPOL, torch.sin(theta_a), zero))
    d_phi = torch.where(kind == KIND_LPDA, d_phi_lpda,
                        torch.where(kind == KIND_HPOL, torch.sin(theta_a) ** 2, zero))
    return d_theta, d_phi


# The LPDA's phase-sector edges (antennapattern.py:1700-1707: 45 and 90 deg of
# antenna-frame zenith) as cosines: for each dtype the smallest number c
# whose arccos, as the JAX package computes it on the CPU, is at most 45 (90)
# deg, found by bisection over the numbers of that dtype. In float64 numpy's
# and torch's arccos put the edges at the same two numbers.
_SECTOR_COS = {torch.float64: (0.7071067811865476, -4.9789962505148006e-17),
               torch.float32: (0.7071068, -1.3510254e-07)}


def _two_sum(a, b):
    """s + e = a + b exactly (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """p + e = a b exactly (Dekker's product with Veltkamp's split)."""
    split = 134217729.0 if a.dtype == torch.float64 else 4097.0    # 2^27 + 1, 2^12 + 1

    def halves(x):
        c = split * x
        hi = c - (c - x)
        return hi, x - hi

    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a, b, c):
    """a b + c rounded once, from elementwise operations that round alike
    on every device (Boldo and Melquiond's emulation: the exact product and
    sum, their low parts added with rounding to odd, then one rounding to
    nearest). The JAX package's CPU products are fused multiply-adds;
    ``torch.addcmul`` is one on some code paths only."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    bits = v.view(torch.int64 if v.dtype == torch.float64 else torch.int32)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(v.dtype)
    v = torch.where((err != 0) & ((bits & 1) == 0), torch.nextafter(v, toward), v)
    return th + v


def _rotate(rot, v):
    """``rot @ v`` over the batch axes ([..., 3, 3], [..., 3]) as the JAX
    package's matrix-vector product on the CPU rounds it: each row
    fma(r2, v2, fma(r1, v1, r0 v0))."""
    return _fma(rot[..., 2], v[..., 2, None],
                _fma(rot[..., 1], v[..., 1, None], rot[..., 0] * v[..., 0, None]))


def _sqrt(x):
    """The square root rounded to nearest on every device: ``torch.sqrt`` on
    the CPU may miss it by one unit in the last place, so of the root and its
    two neighbours take the one whose exact square lies nearest ``x``."""
    def miss(r):
        p, e = _two_prod(r, r)
        return torch.abs((p - x) + e)

    root = torch.sqrt(x)
    best, best_miss = root, miss(root)
    for side in (-torch.inf, torch.inf):
        r = torch.nextafter(root, torch.full_like(root, side))
        m = miss(r)
        closer = m < best_miss
        best, best_miss = torch.where(closer, r, best), torch.where(closer, m, best_miss)
    return best


def _norm(v):
    """|v| over the last axis as ``jnp.linalg.norm`` rounds it on the CPU."""
    x, y, z = v.unbind(-1)
    return _sqrt(_fma(z, z, _fma(y, y, x * x)))


def lpda_sector(kind, v_ant):
    """LPDA phase sector (antennapattern.py:1700-1707; 0 for other kinds)
    of the antenna-frame direction ``v_ant`` [..., 3], decided on the
    device: the cosine of the antenna-frame zenith, its norm rounded as the
    JAX package rounds it, against the edges' cosines of ``_SECTOR_COS``.
    No arccos, whose last bit differs between devices, takes part, so a
    direction on an edge (a 135 deg arrival at a downward LPDA) takes the
    JAX package's sector on every device."""
    r = _norm(v_ant)
    cos_a = torch.clamp(v_ant[..., 2] / torch.where(r == 0, torch.ones_like(r), r), -1.0, 1.0)
    c45, c90 = _SECTOR_COS[cos_a.dtype]
    one = torch.ones_like(cos_a, dtype=torch.int64)
    sector = torch.where(cos_a >= c45, 0 * one, torch.where(cos_a >= c90, one, 2 * one))
    return torch.where(kind == KIND_LPDA, sector, 0 * one)


def analytic_vel_mix(zenith, azimuth, rot, kind, direction=None):
    """Frequency-independent part of the analytic VEL (antenna.py:147):
    (mix_theta, mix_phi, template_sector), elementwise over the batch axes
    of ``zenith``/``azimuth``/``kind``; ``rot`` is [..., 3, 3].

    The sector is decided from ``direction`` [..., 3] when it is given (the
    receive vector the angles came from: ``simulate_batch``), so that no
    sine, cosine or arccos, whose last bits differ between the card and the
    CPU, takes part; else from the angles' direction."""
    v_global = geometry.spherical_to_cartesian(zenith, azimuth)
    v_ant = torch.einsum("...ij,...j->...i", rot, v_global)
    theta_a, phi_a = geometry.cartesian_to_spherical(v_ant)

    d_theta, d_phi = _direction_factors(kind, theta_a, phi_a)

    B_out = geometry.onsky_basis(zenith, azimuth)
    B_ant = geometry.onsky_basis(theta_a, phi_a)
    M = B_out @ rot.transpose(-1, -2) @ B_ant.transpose(-1, -2)

    mix_theta = M[..., 1, 1] * d_theta + M[..., 1, 2] * d_phi
    mix_phi = M[..., 2, 1] * d_theta + M[..., 2, 2] * d_phi
    sector = lpda_sector(kind, _rotate(rot, v_global if direction is None else direction))
    return mix_theta, mix_phi, sector


# ---- tabulated antenna patterns (antenna.py:207-322) ------------------------
