# copied from nuradiomc_tpu/sim/muon_flux.py:1-144; the port keeps its own copy
# and imports nothing of the JAX package
"""Atmospheric muon fluxes (MuonFlux API of NuRadioMC/utilities/muon_flux.py).

The reference computes fluxes by running MCEq (external cascade-equation
solver + crflux primary models) and buffers results in a pickle. Here the
same API is backed by the standard Gaisser analytic parametrization of the
high-energy atmospheric muon flux (Gaisser, Cosmic Rays and Particle
Physics, eq. 6.99; with the Earth-curvature zenith correction and the
prompt charm component) — accurate to tens of percent above ~100 GeV, which
is the regime of radio-detector muon backgrounds. When the external
``MCEq``/``crflux`` packages are installed the exact reference computation
is used instead, and a buffer pickle produced by either backend is read
transparently (``get_int_angle_mu_flux_buffered`` file format).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
from scipy.interpolate import interp1d

from nuradiomc_tpu_torch.utils import units


def _cos_theta_star(cos_theta):
    """Earth-curvature-corrected zenith (Chirkin parametrization used with
    the Gaisser formula at large zenith angles)."""
    p = (0.102573, -0.068287, 0.958633, 0.0407253, 0.817285)
    x = cos_theta
    num = x ** 2 + p[0] ** 2 + p[1] * x ** p[2] + p[3] * x ** p[4]
    den = 1 + p[0] ** 2 + p[1] + p[3]
    return np.sqrt(num / den)


def gaisser_flux(energy, theta):
    """dN/(dE dA dt dOmega) in internal units; ``energy`` in internal eV.

    Gaisser 1990 eq. 6.99 + prompt component; valid above ~100 GeV where
    muon decay and detector altitude are negligible.
    """
    e_gev = np.asarray(energy, dtype=float) / units.GeV
    cs = _cos_theta_star(np.cos(theta))
    flux_gev_cm2 = (0.14 * e_gev ** -2.7
                    * (1.0 / (1.0 + 1.1 * e_gev * cs / 115.0)
                       + 0.054 / (1.0 + 1.1 * e_gev * cs / 850.0)
                       + 1.0e-5 / (1.0 + 1.1 * e_gev * cs / 3.0e7)))
    # per (GeV cm^2 s sr) -> internal 1/(energy area time sr)
    return flux_gev_cm2 / units.GeV / units.cm ** 2 / units.s


class MuonFlux:
    """API of utilities/muon_flux.MuonFlux (:10-200)."""

    def __init__(self, buffer_file="data/surface_muon_buffer.pkl"):
        self.__buffer = {}
        self.file_buffer = buffer_file
        if os.path.exists(self.file_buffer):
            with open(self.file_buffer, "rb") as fin:
                self.__buffer = pickle.load(fin)

    @staticmethod
    def _have_mceq():
        try:
            import crflux.models  # noqa: F401
            from MCEq.core import MCEqRun  # noqa: F401
            return True
        except ImportError:
            return False

    def get_e_grid(self, theta=50 * units.deg, **kwargs):
        """Energy grid of the flux tables (eV, internal units)."""
        e_grid, _ = self.get_mu_flux(theta, **kwargs)
        return e_grid

    def get_mu_flux(self, theta, altitude=3200, interaction_model="SIBYLL23C",
                    primary_model=None, particle_names=("total_mu+",
                                                        "total_mu-")):
        """(e_grid [eV], flux [1/(area time energy sr)]) at zenith theta
        (muon_flux.py:27-73). MCEq when installed; Gaisser otherwise."""
        if self._have_mceq():
            import crflux.models as crf
            from MCEq.core import MCEqRun

            mc_m, mc_eV, mc_ns = 1e2, 1e-9, 1e-9
            primary_model = primary_model or (crf.GlobalSplineFitBeta, None)
            mceq = MCEqRun(interaction_model=interaction_model,
                           primary_model=primary_model,
                           theta_deg=theta / units.deg)
            h_grid = np.linspace(50 * 1e3 * 1e2, 0, 500)
            X_grid = mceq.density_model.h2X(h_grid)
            alt_idx = int(np.abs(h_grid - altitude * mc_m).argmin())
            mceq.solve(int_grid=X_grid)
            flux = sum(mceq.get_solution(p, grid_idx=alt_idx, integrate=False)
                       for p in particle_names)
            return mceq.e_grid / mc_eV, flux * mc_m ** 2 * mc_eV * mc_ns
        e_grid = np.logspace(11, 20, 121)      # 100 GeV .. 100 EeV, internal
        return e_grid, gaisser_flux(e_grid, theta)

    def get_interp_angle_mu_flux(self, theta_min, theta_max, altitude=3200,
                                 n_steps=3, primary_model=None,
                                 interaction_model="SIBYLL23C",
                                 particle_names=("total_mu+", "total_mu-")):
        """Zenith-band-integrated flux interpolator over log10(E)
        (muon_flux.py:75-118): Riemann sum over equal-cos(theta) bins,
        solid-angle weighted."""
        angle_edges = np.arccos(np.linspace(np.cos(theta_max),
                                            np.cos(theta_min), n_steps + 1))
        angle_centers = 0.5 * (angle_edges[1:] + angle_edges[:-1])
        d_cos = np.abs(np.cos(theta_min) - np.cos(theta_max))
        flux = None
        for angle in angle_centers:
            e_grid, f = self.get_mu_flux(
                angle, altitude, primary_model=primary_model,
                interaction_model=interaction_model,
                particle_names=particle_names)
            f = f * np.sin(angle) * (d_cos * 2 * np.pi) / n_steps
            flux = f if flux is None else flux + f
        return interp1d(np.log10(e_grid), flux, kind="cubic")

    def get_int_angle_mu_flux_buffered(self, energy, theta_min, theta_max,
                                       altitude=3200, n_steps=3,
                                       primary_model=None,
                                       interaction_model="SIBYLL23C",
                                       particle_names=("total_mu+",
                                                       "total_mu-")):
        """Buffered band-integrated flux at ``energy`` (muon_flux.py:120-158);
        the buffer pickle is keyed like the reference's so precomputed MCEq
        tables drop in."""
        backend = "MCEq" if self._have_mceq() else "gaisser"
        key = (backend, float(np.round(theta_min, 6)),
               float(np.round(theta_max, 6)), altitude, n_steps,
               interaction_model, tuple(particle_names))
        if key not in self.__buffer:
            self.__buffer[key] = self.get_interp_angle_mu_flux(
                theta_min, theta_max, altitude, n_steps=n_steps,
                primary_model=primary_model,
                interaction_model=interaction_model,
                particle_names=particle_names)
            folder = os.path.dirname(self.file_buffer)
            if folder and os.path.isdir(folder):
                with open(self.file_buffer, "wb") as fout:
                    pickle.dump(self.__buffer, fout)
        return self.__buffer[key](np.log10(energy))
