# copied from nuradiomc_tpu/sim/cross_sections.py:1-289 (ctw, csms, the BGR18/HEDIS
# table machinery of :80-233, the cross section and the interaction length)
"""Neutrino-nucleon cross sections (host-side numpy, vectorized).

Re-implementation of NuRadioMC/utilities/cross_sections.py: the CTW
parametrization (param:64-122, Connolly/Thorne/Waters Phys.Rev.D 83, 113009)
and the Ghandi et al. power law (get_nu_cross_section:273-274). Table-driven
models (CSMS, BGR18) require data files shipped with the reference and are
added when those tables are available.
"""

from __future__ import annotations

import os

import numpy as np

from nuradiomc_tpu_torch.utils import units

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


# CSMS cross sections: published tables 1+2 of A. Cooper-Sarkar, P. Mertsch,
# S. Sarkar, JHEP 08 (2011) 042 (E [GeV], sigma_CC, sigma_NC [pb]); the same
# published values back the reference's csms() (cross_sections.py:123-252)
_CSMS_E = np.array([50, 100, 200, 500, 1000, 2000, 5000, 1e4, 2e4, 5e4, 1e5,
                    2e5, 5e5, 1e6, 2e6, 5e6, 1e7, 2e7, 5e7, 1e8, 2e8, 5e8,
                    1e9, 2e9, 5e9, 1e10, 2e10, 5e10, 1e11, 2e11, 5e11])
_CSMS_NU = np.array([
    [0.32, 0.10], [0.65, 0.20], [1.3, 0.41], [3.2, 1.0], [6.2, 2.0],
    [12., 3.8], [27., 8.6], [47., 15.], [77., 26.], [140., 49.],
    [210., 75.], [310., 110.], [490., 180.], [690., 260.], [950., 360.],
    [1400., 540.], [1900., 730.], [2600., 980.], [3700., 1400.],
    [4800., 1900.], [6200., 2400.], [8700., 3400.], [11000., 4400.],
    [14000., 5600.], [19000., 7600.], [24000., 9600.], [30000., 12000.],
    [39000., 16000.], [48000., 20000.], [59000., 24000.], [75000., 31000.]])
_CSMS_NUBAR = np.array([
    [0.15, 0.05], [0.33, 0.12], [0.69, 0.24], [1.8, 0.61], [3.6, 1.20],
    [7., 2.4], [17., 5.8], [31., 11.], [55., 19.], [110., 39.],
    [180., 64.], [270., 99.], [460., 170.], [660., 240.], [920., 350.],
    [1400., 530.], [1900., 730.], [2500., 980.], [3700., 1400.],
    [4800., 1900.], [6200., 2400.], [8700., 3400.], [11000., 4400.],
    [14000., 5600.], [19000., 7600.], [24000., 9600.], [30000., 12000.],
    [39000., 16000.], [48000., 20000.], [59000., 24000.], [75000., 31000.]])


def csms(energy, inttype, flavors) -> np.ndarray:
    """CSMS DIS cross sections, linear interpolation of the published tables
    (reference cross_sections.csms:123-252; bounds are an error there too)."""
    energy = np.atleast_1d(np.asarray(energy, dtype=float))
    E_tab = _CSMS_E * units.GeV
    if np.any(energy < E_tab[0]) or np.any(energy > E_tab[-1]):
        raise ValueError("energy outside the CSMS table range (50 GeV - 5e11 GeV)")
    if isinstance(inttype, str):
        inttype = np.full(energy.shape, inttype)
    flavors = np.broadcast_to(np.asarray(flavors), energy.shape)
    is_cc = np.char.lower(np.asarray(inttype).astype(str)) == "cc"
    anti = flavors < 0
    col = np.where(is_cc, 0, 1)
    nu = np.stack([np.interp(energy, E_tab, _CSMS_NU[:, c] * units.picobarn)
                   for c in (0, 1)])
    nubar = np.stack([np.interp(energy, E_tab, _CSMS_NUBAR[:, c] * units.picobarn)
                      for c in (0, 1)])
    return np.where(anti, nubar[col, np.arange(energy.size)],
                    nu[col, np.arange(energy.size)])


def integrate_pwpl(y, x, low=None, high=None, full_output=False):
    """Integrate y over x assuming piecewise power laws y = A x^b per bin
    (cross_sections.integrate_pwpl:424-533), with optional log-log
    extrapolation to ``low``/``high``. ``full_output`` also returns the
    cumulative integral (the CDF when y is a PDF)."""
    y = np.asarray(y, dtype=float)
    x = np.asarray(x, dtype=float)
    nanmask = y == 0
    binmask = nanmask[..., 1:] | nanmask[..., :-1]

    logy = np.full_like(y, np.nan)
    logy[~nanmask] = np.log(y[~nanmask])
    logx = np.log(x)
    slope = np.diff(logy) / np.diff(logx)
    lognorm = logy[..., :-1] - slope * logx[..., :-1]

    with np.errstate(invalid="ignore", divide="ignore"):
        integrand = np.exp(
            lognorm
            + np.log((x[1:] ** (slope + 1) - x[:-1] ** (slope + 1))
                     / (slope + 1)))
    integrand[binmask] = 0

    if low is not None:
        if low < 0:
            raise ValueError("cannot power-law integrate negative x")
        if low == 0 and np.any(slope[..., 0] <= -1):
            raise ValueError("cannot integrate to x=0 with slope <= -1")
        with np.errstate(invalid="ignore", divide="ignore"):
            int_low = np.exp(
                lognorm[..., 0]
                + np.log((x[0] ** (slope[..., 0] + 1)
                          - low ** (slope[..., 0] + 1)) / (slope[..., 0] + 1)))
        int_low = np.where(binmask[..., 0], 0, int_low)
        integrand = np.concatenate([np.asarray(int_low)[..., None], integrand],
                                   axis=-1)
        x = np.concatenate([np.atleast_1d(low), x], axis=-1)
    if high is not None:
        with np.errstate(invalid="ignore", divide="ignore"):
            int_high = np.exp(
                lognorm[..., -1]
                + np.log((high ** (slope[..., -1] + 1)
                          - x[-1] ** (slope[..., -1] + 1))
                         / (slope[..., -1] + 1)))
        int_high = np.where(binmask[..., -1], 0, int_high)
        integrand = np.concatenate([integrand, np.asarray(int_high)[..., None]],
                                   axis=-1)
        x = np.concatenate([x, np.atleast_1d(high)], axis=-1)

    res = np.sum(integrand, axis=-1)
    if full_output:
        # cumulative integral aligned with x (leading 0 inserted, :530-532)
        return res, (np.insert(np.cumsum(integrand, axis=-1), 0, 0, axis=-1), x)
    return res


_BGR18_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                           "BGR18_dsigma_dy_H2O.npz")
_bgr18_cache = {}


def set_bgr18_table_path(path):
    """Point the hedis_bgr18 machinery at a table file (the published
    BGR18_dsigma_dy_H2O.npz data-server download, or a synthetic table of
    the same schema for tests)."""
    global _BGR18_PATH
    _BGR18_PATH = path
    _bgr18_cache.clear()


def read_differential_cross_section_bgr18():
    """(nu_energies, yy, flavors, ncccs, dsigma_dy[flavor, ccnc, E, y]) from
    the BGR18 npz (cross_sections._read_differential_cross_section_BGR18:
    16-40); per-nucleon (the file stores per ice nucleus, /18)."""
    if "table" not in _bgr18_cache:
        if not os.path.exists(_BGR18_PATH):
            raise FileNotFoundError(
                f"BGR18 table not found at {_BGR18_PATH}; download "
                "cross_sections/BGR18_dsigma_dy_H2O.npz from the NuRadioMC "
                "data server or call set_bgr18_table_path()")
        data = np.load(_BGR18_PATH)
        _bgr18_cache["table"] = (
            data["nu_energies_ref"], data["y_ref"], data["flavors_ref"],
            np.array([str(s).lower() for s in data["ncccs_ref"]]),
            data["dsigma_dy_ref"] * units.cm ** 2 / 18)
    return _bgr18_cache["table"]


def _bgr18_integrated():
    """sigma(E) per (flavor, {nc, cc, total}) via piecewise-power-law
    integration over y extended to [0, 1]
    (_integrate_over_differential_cross_section_BGR18:42-63)."""
    if "integrated" not in _bgr18_cache:
        nu_E, yy, flavs, ncccs, dsdy = read_differential_cross_section_bgr18()
        sig = integrate_pwpl(dsdy, yy, low=0, high=1)
        full = np.zeros((len(flavs), 3, len(nu_E)))
        full[:, :2] = sig
        full[:, 2] = sig[:, 0] + sig[:, 1]
        _bgr18_cache["integrated"] = (
            nu_E, flavs, np.append(ncccs, "total"), full)
    return _bgr18_cache["integrated"]


def hedis_bgr18(energy, flavors, inttype="total"):
    """BGR18/HEDIS tabulated cross section: log10 interpolation over energy
    per (flavor, interaction) (get_nu_cross_section:266-303)."""
    nu_E, flavs, ncccs, table = _bgr18_integrated()
    energy = np.atleast_1d(np.asarray(energy, dtype=float))
    flavors = np.broadcast_to(np.asarray(flavors), energy.shape)
    itypes = np.broadcast_to(np.asarray(inttype), energy.shape).astype(str)
    if np.any(energy < nu_E[0]) or np.any(energy > nu_E[-1]):
        raise ValueError("energy outside the BGR18 table range")
    crscn = np.zeros_like(energy)
    for flav in np.unique(flavors):
        for it in np.unique(itypes):
            mask = (flavors == flav) & (itypes == it)
            iF = int(np.argwhere(flavs == flav)[0][0])
            iI = int(np.argwhere(ncccs == it.lower())[0][0])
            logsig = np.interp(energy[mask], nu_E, np.log10(table[iF, iI]))
            crscn[mask] = 10.0 ** logsig
    return crscn


def get_neutrino_inelasticity_bgr18(n_events, rnd=None,
                                    nu_energies=1e18, flavors=12, ncccs="cc"):
    """Inverse-CDF inelasticity sampling from the BGR18 differential tables
    (inelasticities.get_neutrino_inelasticity:53-95 + the cumulative
    piecewise-power-law CDF of _get_inverse_cdf_interpolation:99-106)."""
    rnd = rnd or np.random.default_rng()
    nu_E, yy, flavs, ncccs_ref, dsdy = read_differential_cross_section_bgr18()

    out = np.zeros(n_events)
    nu_energies = np.broadcast_to(np.asarray(nu_energies, dtype=float),
                                  (n_events,))
    flavors = np.broadcast_to(np.asarray(flavors), (n_events,))
    ncccs = np.broadcast_to(np.asarray(ncccs), (n_events,)).astype(str)

    e_idx = np.clip(np.digitize(nu_energies, nu_E), 0, len(nu_E) - 1)
    e_binned = nu_E[e_idx]
    for energy in np.unique(e_binned):
        for flav in np.unique(flavors):
            for nccc in np.unique(ncccs):
                mask = (e_binned == energy) & (flavors == flav) & (ncccs == nccc)
                if not np.any(mask):
                    continue
                iF = int(np.argwhere(flavs == flav)[0][0])
                iI = int(np.argwhere(ncccs_ref == nccc.lower())[0][0])
                iE = int(np.argmin(np.abs(energy - nu_E)))
                total, (cum, y_ext) = integrate_pwpl(
                    dsdy[iF, iI, iE], yy, low=0, high=1, full_output=True)
                cdf = cum / total
                out[mask] = np.interp(rnd.uniform(0, 1, int(np.sum(mask))),
                                      cdf, y_ext)
    return out


def get_nu_cross_section(energy, flavors, inttype="total",
                         cross_section_type="ctw") -> np.ndarray:
    """Total / cc / nc cross section per event (get_nu_cross_section:232-390).

    flavors: PDG codes (sign encodes particle/antiparticle).
    """
    energy = np.asarray(energy, dtype=float)
    flavors = np.asarray(flavors)

    if cross_section_type == "ghandi":
        return 7.84e-36 * units.cm ** 2 * np.power(energy / units.GeV, 0.363)

    if cross_section_type == "csms":
        if isinstance(inttype, str) and inttype == "total":
            return (csms(energy, "cc", flavors)
                    + csms(energy, "nc", flavors)).reshape(energy.shape)
        return csms(energy, inttype, flavors).reshape(energy.shape)

    if cross_section_type in ("hedis", "hedis_bgr18", "bgr18"):
        if isinstance(inttype, str) and inttype == "total":
            return hedis_bgr18(energy, flavors, "total").reshape(energy.shape)
        return hedis_bgr18(energy, flavors, inttype).reshape(energy.shape)

    if cross_section_type != "ctw":
        raise NotImplementedError(
            f"cross section type {cross_section_type} requires external tables")

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


def get_interaction_length(Enu, density=0.917 * units.g / units.cm ** 3,
                           flavor=12, inttype="total", cross_section_type="ctw"):
    """Interaction length L = m_n / (rho sigma) (cross_sections.py:393-430)."""
    AMU = 1.66e-27 * units.kg
    sigma = get_nu_cross_section(Enu, flavor, inttype, cross_section_type)
    return AMU / density / sigma
