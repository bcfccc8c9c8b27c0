# frozen copy of nuradiomc_tpu_torch/sim/earth_attenuation.py:17-184 (commit
# 493e4d9), the modes "core_mantle_crust_simple" and "core_mantle_crust" with
# the CTW cross sections, computed in a chosen numpy float type.
"""Earth-absorption survival weights of the neutrinos (host numpy). With
``dtype=np.float32`` every array and constant is float32: the lower
precision of the benchmark's control."""

from __future__ import annotations

import numpy as np

from portbench.reference import cross_sections, units

AMU = 1.66e-27 * units.kg


def _ctw_total(energy, flavors, ft):
    """CTW total cross section (m^2) per event: nu or nu-bar, nc + cc."""
    anti = np.asarray(flavors) < 0
    eps = np.log10(energy / ft(units.GeV))

    def one(c):
        c = [ft(v) for v in c]
        l_eps = np.log(eps - c[0])
        return np.power(ft(10.0), c[1] + c[2] * l_eps + c[3] * l_eps ** 2
                        + c[4] / l_eps) * ft(units.cm ** 2)

    ctw = cross_sections._CTW
    return np.where(anti, one(ctw["nc_bar"]) + one(ctw["cc_bar"]),
                    one(ctw["nc"]) + one(ctw["cc"])).astype(ft)


def core_mantle_crust_simple(theta_nu, pnu, flavors, ft):
    """Three-layer Earth, interaction at the surface."""
    theta_nu = np.asarray(theta_nu, dtype=ft)
    pnu = np.asarray(pnu, dtype=ft)
    r_earth = 6.378140e6 * units.m
    # densities over the nucleon mass, formed in float64: a density alone
    # (units.kg ~ 5.6e35) overflows float32
    dens = (np.array([14000.0, 3400.0, 2900.0]) * units.kg / units.m ** 3 / AMU).astype(ft)
    radii = np.array([3.46e6 * units.m, r_earth - 4.0e4 * units.m, r_earth])
    sigma = _ctw_total(pnu, flavors, ft)
    sin_t = np.sin(ft(np.pi) - theta_nu)
    cos_t = np.cos(theta_nu)
    rr = radii.astype(ft)
    arg1 = rr[1] ** 2 - rr[2] ** 2 * sin_t ** 2
    arg0 = rr[0] ** 2 - rr[2] ** 2 * sin_t ** 2
    d_inner = 2 * np.sqrt(np.maximum(arg0, ft(0.0)))
    d_middle_full = 2 * np.sqrt(np.maximum(arg1, ft(0.0)))
    only_outer = theta_nu <= ft(np.pi - np.arcsin(radii[1] / radii[2]))
    reaches_core = theta_nu > ft(np.pi - np.arcsin(radii[0] / radii[2]))
    d_inner = np.where(reaches_core, d_inner, ft(0.0))
    d_middle = np.where(only_outer, ft(0.0), d_middle_full - d_inner)
    d_outer = ft(-2 * r_earth) * cos_t - d_middle - d_inner
    exponent = (d_outer * dens[2] + d_middle * dens[1] + d_inner * dens[0]) * sigma
    return np.where(theta_nu <= ft(0.5 * np.pi), ft(1.0), np.exp(-exponent)).astype(ft)


def core_mantle_crust(theta_nu, phi_nu, vertex_position, pnu, flavors, ft,
                      n_samples=16384):
    """The chord from the vertex back to where the neutrino entered the
    Earth, through the ARAsim three-shell densities, trapezoid over
    ``n_samples`` points; weight exp(-column depth / interaction length)."""
    theta_nu = np.asarray(theta_nu, dtype=ft)
    phi_nu = np.asarray(phi_nu, dtype=ft)
    earth_radius = ft(6.378140e6 * units.m)
    radii = (np.array([np.sqrt(1.2e13), 6.378140e6 - 4e4, 6.378140e6]) * units.m).astype(ft)
    rho = (np.array([14.0, 3.4, 2.9]) * units.g / units.cm ** 3 / AMU).astype(ft)
    d = np.stack([np.sin(theta_nu) * np.cos(phi_nu), np.sin(theta_nu) * np.sin(phi_nu),
                  np.cos(theta_nu)], axis=-1)
    endpoints = np.atleast_2d(np.asarray(vertex_position, dtype=ft)).copy()
    endpoints[:, 2] += earth_radius
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    dot = np.sum(endpoints * d, axis=-1)
    disc = dot ** 2 - np.sum(endpoints ** 2, axis=-1) + earth_radius ** 2
    distance = np.where(disc > 0, -dot + np.sqrt(np.maximum(disc, ft(0.0))), ft(0.0))
    distance = np.maximum(distance, ft(0.0))
    ts = np.linspace(0.0, 1.0, n_samples, dtype=ft)
    pts = endpoints[:, None, :] + (ts[None, :, None] * distance[:, None, None]
                                   * d[:, None, :])
    rs = np.linalg.norm(pts, axis=-1)
    shell = np.searchsorted(radii, rs, side="right")
    rhos = np.where(shell < len(radii), rho[np.minimum(shell, len(radii) - 1)], ft(0.0))
    # the column depth in nucleons per area times the cross section
    slant = np.trapezoid(rhos, ts, axis=-1) * distance
    return np.exp(-slant * _ctw_total(np.asarray(pnu, dtype=ft), flavors, ft)).astype(ft)


def get_weight(theta_nu, pnu, flavors, mode, cross_section_type="ctw",
               vertex_position=None, phi_nu=None, dtype=np.float64):
    if cross_section_type != "ctw":
        raise NotImplementedError("the reference covers the CTW cross sections")
    if mode == "core_mantle_crust_simple":
        return core_mantle_crust_simple(theta_nu, pnu, flavors, dtype)
    if mode == "core_mantle_crust":
        return core_mantle_crust(theta_nu, phi_nu, vertex_position, pnu, flavors, dtype)
    raise NotImplementedError(f"weight mode {mode} is not in the reference")
