# copied from nuradiomc_tpu/sim/earth_attenuation.py:1-183 (the port keeps its own copy; it imports nothing of the JAX package); the path modes' chord integral runs on the card (ops/earth_slant.py) when the run is on one
"""Neutrino survival weights through the Earth (host-side numpy, vectorized).

Re-implementation of NuRadioMC/utilities/earth_attenuation.py: the 'simple'
constant-density model (:63-87) and the three-layer
'core_mantle_crust_simple' model with ARAsim 2018 parameters (:90-129),
fully vectorized over events (the reference evaluates per event).

The path modes ('core_mantle_crust', 'PREM') integrate each chord through a
layered ``EarthModel``. With ``device`` a CUDA device that integral is one
launch of the kernel ``csrc/earth_slant.cu`` (``ops/earth_slant.py``);
otherwise, and for every other mode, everything runs here in numpy, and
``EarthModel.slant_depth`` is the reference the kernel is held to.
"""

from __future__ import annotations

import numpy as np
import torch

from nuradiomc_tpu_torch.ops import earth_slant
from nuradiomc_tpu_torch.sim import cross_sections
from nuradiomc_tpu_torch.utils import units

AMU = 1.66e-27 * units.kg


def get_simple_weight(theta_nu, pnu, cross_section_type="ctw"):
    """Constant-density crust, interaction at the surface (:63-87)."""
    theta_nu = np.asarray(theta_nu, dtype=float)
    pnu = np.asarray(pnu, dtype=float)
    R_earth = 6357390 * units.m
    rho = 2900 * units.kg / units.m ** 3
    sigma = cross_sections.get_nu_cross_section(
        pnu, np.zeros_like(pnu, dtype=int), cross_section_type=cross_section_type)
    d = -2 * R_earth * np.cos(theta_nu)
    w = np.exp(-d * sigma * rho / AMU)
    return np.where(theta_nu <= 0.5 * np.pi, 1.0, w)


def get_core_mantle_crust_simple_weight(theta_nu, pnu, flavors,
                                        cross_section_type="ctw"):
    """Three-layer Earth, interaction at the surface (:90-129)."""
    theta_nu = np.asarray(theta_nu, dtype=float)
    pnu = np.asarray(pnu, dtype=float)
    R_EARTH = 6.378140e6 * units.m
    densities = np.array([14000.0, 3400.0, 2900.0]) * units.kg / units.m ** 3
    radii = np.array([3.46e6 * units.m, R_EARTH - 4.0e4 * units.m, R_EARTH])

    sigma = cross_sections.get_nu_cross_section(
        pnu, flavors, cross_section_type=cross_section_type)

    sin_t = np.sin(np.pi - theta_nu)
    cos_t = np.cos(theta_nu)

    # chord lengths through each layer (zero where the layer is not crossed)
    arg1 = radii[1] ** 2 - radii[2] ** 2 * sin_t ** 2
    arg0 = radii[0] ** 2 - radii[2] ** 2 * sin_t ** 2
    d_inner = 2 * np.sqrt(np.maximum(arg0, 0.0))
    d_middle_full = 2 * np.sqrt(np.maximum(arg1, 0.0))

    only_outer = theta_nu <= np.pi - np.arcsin(radii[1] / radii[2])
    reaches_core = theta_nu > np.pi - np.arcsin(radii[0] / radii[2])

    d_inner = np.where(reaches_core, d_inner, 0.0)
    d_middle = np.where(only_outer, 0.0, d_middle_full - d_inner)
    d_outer = -2 * R_EARTH * cos_t - d_middle - d_inner

    exponent = (d_outer * densities[2] + d_middle * densities[1]
                + d_inner * densities[0]) * sigma / AMU
    w = np.exp(-exponent)
    return np.where(theta_nu <= 0.5 * np.pi, 1.0, w)


class EarthModel:
    """Radially layered Earth density model with a vectorized chord integral.

    Counterpart of the reference's PREM class (earth_attenuation.py:128-259),
    which evaluates one 500-m-step chord per event in a Python loop.  Here the
    density profile is a table of polynomial shells evaluated on an
    (events, samples) grid in one shot — same piecewise polynomials from
    Dziewonski & Anderson (1981), batched.
    """

    def __init__(self, earth_radius, radii, coeffs):
        self.earth_radius = float(earth_radius)
        self.radii = np.asarray(radii, dtype=float)
        # (n_shells, 4) polynomial coefficients in x = r/earth_radius,
        # density units internal (converted from g/cm^3 by the caller)
        self.coeffs = np.asarray(coeffs, dtype=float)

    def density(self, r):
        """Density at radius r (vectorized; zero outside the outer shell)."""
        r = np.asarray(r, dtype=float)
        shell = np.searchsorted(self.radii, r, side="right")
        inside = shell < len(self.radii)
        shell = np.minimum(shell, len(self.radii) - 1)
        c = self.coeffs[shell]
        x = r / self.earth_radius
        rho = c[..., 0] + x * (c[..., 1] + x * (c[..., 2] + x * c[..., 3]))
        return np.where(inside, rho, 0.0)

    def slant_depth(self, endpoints, directions, n_samples=4096):
        """Column density from the surface-entry point to each endpoint.

        endpoints: (N, 3) vertex positions in surface coordinates (z<0 below
        the surface); directions: (N, 3) propagation directions.  Matches
        PREM.slant_depth (earth_attenuation.py:203-259) but integrates with a
        fixed per-chord sample count (trapezoid) instead of 500-m steps so
        every event is a row of one dense array.
        """
        endpoints = np.atleast_2d(np.asarray(endpoints, dtype=float)).copy()
        directions = np.atleast_2d(np.asarray(directions, dtype=float))
        endpoints[:, 2] += self.earth_radius
        d = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
        dot = np.sum(endpoints * d, axis=-1)
        disc = dot ** 2 - np.sum(endpoints ** 2, axis=-1) + self.earth_radius ** 2
        distance = np.where(disc > 0, -dot + np.sqrt(np.maximum(disc, 0.0)), 0.0)
        distance = np.maximum(distance, 0.0)
        ts = np.linspace(0.0, 1.0, n_samples)
        pts = endpoints[:, None, :] + (ts[None, :, None]
                                       * distance[:, None, None] * d[:, None, :])
        rs = np.linalg.norm(pts, axis=-1)
        rhos = self.density(rs)
        return np.trapz(rhos, ts, axis=-1) * distance


def _gcm3(rows):
    return np.asarray(rows, dtype=float) * units.g / units.cm ** 3


# Dziewonski & Anderson (1981) shell polynomials (earth_attenuation.py:161-178)
PREM = EarthModel(
    earth_radius=6.3710e6 * units.m,
    radii=np.array([1.2215e6, 3.4800e6, 5.7010e6, 5.7710e6, 5.9710e6,
                    6.1510e6, 6.3466e6, 6.3560e6, 6.3680e6, 6.3710e6]) * units.m,
    coeffs=_gcm3([
        [13.0885, 0.0, -8.8381, 0.0],
        [12.5815, -1.2638, -3.6426, -5.5281],
        [7.9565, -6.4761, 5.5283, -3.0807],
        [5.3197, -1.4836, 0.0, 0.0],
        [11.2494, -8.0298, 0.0, 0.0],
        [7.1089, -3.8045, 0.0, 0.0],
        [2.691, 0.6924, 0.0, 0.0],
        [2.9, 0.0, 0.0, 0.0],
        [2.6, 0.0, 0.0, 0.0],
        [1.02, 0.0, 0.0, 0.0],
    ]),
)

# ARAsim 3-layer model (earth_attenuation.py:262-289)
CORE_MANTLE_CRUST = EarthModel(
    earth_radius=6.378140e6 * units.m,
    radii=np.array([np.sqrt(1.2e13), 6.378140e6 - 4e4, 6.378140e6]) * units.m,
    coeffs=_gcm3([[14.0, 0, 0, 0], [3.4, 0, 0, 0], [2.9, 0, 0, 0]]),
)


def get_path_weight(theta_nu, phi_nu, vertex_position, pnu, flavors, earth,
                    cross_section_type="ctw", device=None):
    """Path-through-Earth weight using a layered model (get_weight:39-54);
    the chord integral on the card where ``device`` is a CUDA device."""
    theta_nu = np.asarray(theta_nu, dtype=float)
    phi_nu = np.asarray(phi_nu, dtype=float)
    # (theta_nu, phi_nu) point back toward the source: the chord is integrated
    # from the vertex toward where the neutrino came from, out to the surface
    d = np.stack([np.sin(theta_nu) * np.cos(phi_nu),
                  np.sin(theta_nu) * np.sin(phi_nu),
                  np.cos(theta_nu)], axis=-1)
    if device is not None and torch.device(device).type == "cuda":
        slant = earth_slant.slant_depth(earth, vertex_position, d, n_samples=16384,
                                        device=device)
    else:
        slant = earth.slant_depth(vertex_position, d, n_samples=16384)
    L_int = cross_sections.get_interaction_length(
        pnu, density=1.0, flavor=flavors, inttype="total",
        cross_section_type=cross_section_type)
    return np.exp(-slant / L_int)


def get_weight(theta_nu, pnu, flavors, mode="core_mantle_crust_simple",
               cross_section_type="ctw", vertex_position=None, phi_nu=None, device=None):
    """Dispatcher mirroring earth_attenuation.get_weight (:12-59). ``device``
    is the run's device: a CUDA device takes the path modes' chord integral
    to the card; None (the default) or the CPU keeps it in numpy."""
    if mode == "simple":
        return get_simple_weight(theta_nu, pnu, cross_section_type)
    if mode == "core_mantle_crust_simple":
        return get_core_mantle_crust_simple_weight(theta_nu, pnu, flavors,
                                                   cross_section_type)
    if mode == "core_mantle_crust":
        return get_path_weight(theta_nu, phi_nu, vertex_position, pnu, flavors,
                               CORE_MANTLE_CRUST, cross_section_type, device)
    if mode == "PREM":
        return get_path_weight(theta_nu, phi_nu, vertex_position, pnu, flavors,
                               PREM, cross_section_type, device)
    if mode in ("None", None):
        return np.ones_like(np.asarray(theta_nu, dtype=float))
    raise NotImplementedError(f"weight mode {mode} not implemented")
