# copied from nuradiomc_tpu/sim/fluxes.py:1-108 (the port keeps its own copy; it imports nothing of the JAX package)
"""Neutrino flux models and sensitivity limits.

Re-implementation of NuRadioMC/utilities/fluxes.py (limit calculations from
effective volumes, :138-260) and the flux models used by the sensitivity
examples (examples/Sensitivities/E2_fluxes3.py: IceCube astrophysical fits)
with the CTW cross sections bundled here.
"""

from __future__ import annotations

import numpy as np

from nuradiomc_tpu_torch.sim import cross_sections
from nuradiomc_tpu_torch.utils import units


def ice_cube_nu_fit(energy, slope=-2.19, offset=1.01):
    """IceCube astrophysical muon-sample flux fit (generator.py:227-232)."""
    return (3 * offset * (np.asarray(energy) / (100 * units.TeV)) ** slope
            * 1e-18 * (units.GeV ** -1 * units.cm ** -2 * units.second ** -1
                       * units.sr ** -1))


def ice_cube_nu_fit_2022(energy, slope=-2.37, offset=1.44):
    """9.5-year IceCube fit (generator.py:235-239)."""
    return ice_cube_nu_fit(energy, slope, offset)


def _table_flux(filename, row_layout):
    """Linear interpolation (with linear extrapolation, matching the
    reference's interp1d fill_value='extrapolate') of an E^2*flux table
    stored as [GeV, GeV/cm^2/s/sr] (E2_fluxes3.py:573-607)."""
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "data", "fluxes",
                        filename)
    data = np.loadtxt(path)
    if row_layout == "rows":        # two rows: energies, E^2 flux
        E_tab, f2 = data[0, :], data[1, :]
    else:                           # two columns
        E_tab, f2 = data[:, 0], data[:, 1]
    E_tab = E_tab * units.GeV
    f_tab = (f2 * units.GeV * units.cm ** -2 * units.second ** -1
             * units.sr ** -1) / E_tab ** 2

    def flux(energy):
        energy = np.asarray(energy, dtype=float)
        f = np.interp(energy, E_tab, f_tab)
        lo = f_tab[0] + (energy - E_tab[0]) * (f_tab[1] - f_tab[0]) / (E_tab[1] - E_tab[0])
        hi = f_tab[-2] + (energy - E_tab[-2]) * (f_tab[-1] - f_tab[-2]) / (E_tab[-1] - E_tab[-2])
        return np.where(energy < E_tab[0], lo,
                        np.where(energy > E_tab[-1], hi, f))

    return flux


def get_proton_10(energy):
    """van Vliet et al. 2019 cosmogenic flux, 10% proton fraction
    (E2_fluxes3.py:597-604; table bundled in data/fluxes)."""
    return _table_flux("ReasonableNeutrinos1.txt", "rows")(energy)


def get_TAGZK_flux(energy):
    """GZK flux from the TA combined fit, m=3 (E2_fluxes3.py:573-582)."""
    return _table_flux("TA_combined_fit_m3.txt", "cols")(energy)


def get_TAGZK_flux_ICRC2021(energy):
    """GZK flux from the TA best fit, ICRC2021 (E2_fluxes3.py:585-594)."""
    return _table_flux("TA_GZKprediction_ICRC2021.txt", "cols")(energy)


def get_limit_flux(energy, veff_sr, livetime, signalEff=1.0,
                   energyBinsPerDecade=1.0, upperLimOnEvents=2.44,
                   cross_section_type="ctw", inttype="total"):
    """Differential flux upper limit from Veff (fluxes.get_limit_flux:46-136)."""
    energy = np.asarray(energy, dtype=float)
    evts = np.asarray(veff_sr) * signalEff * livetime
    evts = evts / cross_sections.get_interaction_length(
        energy, flavor=12, inttype=inttype, cross_section_type=cross_section_type)
    ul = upperLimOnEvents / evts
    ul *= energyBinsPerDecade / np.log(10)
    return ul / energy


def get_limit_e1_flux(energy, veff_sr, livetime, **kwargs):
    """E^1-weighted limit (fluxes.get_limit_e1_flux:138-185)."""
    return np.asarray(energy) * get_limit_flux(energy, veff_sr, livetime, **kwargs)


def get_limit_e2_flux(energy, veff_sr, livetime, **kwargs):
    """E^2-weighted limit (fluxes.get_limit_e2_flux:187-226)."""
    return np.asarray(energy) ** 2 * get_limit_flux(energy, veff_sr, livetime,
                                                    **kwargs)


def get_number_of_events_for_flux(energies, flux, veff_sr, livetime,
                                  cross_section_type="ctw", inttype="total"):
    """Expected event counts per (equidistant-log) energy bin for a flux
    assumption (fluxes.get_number_of_events_for_flux:229-280)."""
    energies = np.asarray(energies, dtype=float)
    veff_sr = np.asarray(veff_sr)
    logE = np.log10(energies)
    d_logE = logE[1] - logE[0] if len(logE) > 1 else 1.0
    # events = int flux(E) * Veff / L_int dE over the bin ~ flux E ln10 dlogE ...
    L_int = cross_sections.get_interaction_length(
        energies, flavor=12, inttype=inttype, cross_section_type=cross_section_type)
    return (np.asarray(flux) * energies * np.log(10) * d_logE
            * veff_sr / L_int * livetime)
