# frozen copy of nuradiomc_tpu_torch/sim/cross_sections.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
# copied from nuradiomc_tpu/sim/cross_sections.py:1-289; only the CTW
# parametrization and get_nu_cross_section's CTW branch are kept
"""Neutrino-nucleon cross sections (host-side numpy, vectorized).

Re-implementation of NuRadioMC/utilities/cross_sections.py: the CTW
parametrization (param:64-122, Connolly/Thorne/Waters Phys.Rev.D 83, 113009),
the one model that the benchmark's configurations use. Another model is
added with the first cell that needs it.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import units

_CTW = {
    "cc": (-1.826, -17.31, -6.406, 1.431, -17.91),
    "nc": (-1.826, -17.31, -6.448, 1.431, -18.61),
    "cc_bar": (-1.033, -15.95, -7.247, 1.569, -17.72),
    "nc_bar": (-1.033, -15.95, -7.296, 1.569, -18.30),
}


def ctw(energy, inttype: str) -> np.ndarray:
    """CTW cross section (m^2). Valid above 1e4 GeV (param:64-122)."""
    c = _CTW[inttype]
    epsilon = np.log10(np.asarray(energy, dtype=float) / units.GeV)
    l_eps = np.log(epsilon - c[0])
    crscn = c[1] + c[2] * l_eps + c[3] * l_eps ** 2 + c[4] / l_eps
    return np.power(10.0, crscn) * units.cm ** 2


def get_nu_cross_section(energy, flavors, inttype="total",
                         cross_section_type="ctw") -> np.ndarray:
    """Total / cc / nc cross section per event (get_nu_cross_section:232-390).

    flavors: PDG codes (sign encodes particle/antiparticle).
    """
    energy = np.asarray(energy, dtype=float)
    flavors = np.asarray(flavors)

    if cross_section_type != "ctw":
        raise NotImplementedError(
            f"cross section type {cross_section_type} is not in the benchmark's reference")

    anti = flavors < 0
    if isinstance(inttype, str) and inttype == "total":
        crscn = np.where(anti,
                         ctw(energy, "nc_bar") + ctw(energy, "cc_bar"),
                         ctw(energy, "nc") + ctw(energy, "cc"))
    elif isinstance(inttype, str):
        # reference quirk, reproduced for seed-exact ccnc replay: a STRING
        # 'cc'/'nc' uses the NEUTRINO parametrization for antineutrinos too
        # (cross_sections.py:352-358 calls param(energy, inttype) for both
        # particle and antiparticle selections); only 'total*' and ARRAY
        # inttypes respect the _bar curves (:310-330, :373-381)
        crscn = ctw(energy, inttype.lower())
    else:
        inttype_arr = np.broadcast_to(np.asarray(inttype), energy.shape)
        is_cc = np.char.lower(inttype_arr.astype(str)) == "cc"
        crscn = np.where(anti,
                         np.where(is_cc, ctw(energy, "cc_bar"), ctw(energy, "nc_bar")),
                         np.where(is_cc, ctw(energy, "cc"), ctw(energy, "nc")))
    return crscn
