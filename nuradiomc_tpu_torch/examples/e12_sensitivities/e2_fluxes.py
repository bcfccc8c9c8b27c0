"""A differential E^2 flux limit from an effective-volume curve.

Counterpart of ``examples/12_sensitivities/E2_fluxes.py`` (NuRadioMC's
examples/Sensitivities/E2_fluxes3.py): a Veff(E) table (a yaml file of
``energies`` and ``veff`` in km^3 sr, or a representative in-ice array's
curve) turned into a flux limit for a livetime (default 10 years) and the
expected number of TA-GZK (ICRC2021) events, with ``sim/fluxes.py``. The
figure ``sensitivity.png`` is drawn where matplotlib imports::

    python -m nuradiomc_tpu_torch.examples.e12_sensitivities.e2_fluxes [table.yaml] [years]
"""

from __future__ import annotations

import os

import numpy as np

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.sim import fluxes
from nuradiomc_tpu_torch.utils import units

# a representative deep-dipole array's Veff curve (km^3 sr)
ENERGIES = np.logspace(16, 20, 9) * units.eV
VEFF_SR = np.array([2e-4, 3e-3, 2e-2, 1e-1, 0.35, 0.9, 1.8, 3.2, 5.0]) * 4 * np.pi * units.km ** 3


def _figure(path, energies, limit, livetime, unit_flux):
    try:
        import matplotlib
    except ImportError:
        print("plot skipped: matplotlib is not installed")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(energies / units.GeV, limit / unit_flux, "k-", lw=2,
            label=f"this array, {livetime / units.year:.0f} yr")
    E_dense = np.logspace(15, 20, 100) * units.eV
    for f, lbl in [(fluxes.get_TAGZK_flux_ICRC2021, "TA GZK ICRC2021"),
                   (fluxes.get_proton_10, "10% proton GZK")]:
        ax.plot(E_dense / units.GeV, E_dense ** 2 * f(E_dense) / unit_flux, "--", label=lbl)
    icfit = E_dense ** 2 * fluxes.ice_cube_nu_fit_2022(E_dense)
    ax.plot(E_dense / units.GeV, icfit / unit_flux, ":", label="IceCube 2022 fit")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("E [GeV]")
    ax.set_ylabel(r"$E^2\Phi$ [GeV cm$^{-2}$ s$^{-1}$ sr$^{-1}$]")
    ax.set_ylim(1e-11, 1e-5)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print("wrote sensitivity.png")
    return True


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("table", nargs="?", default=None)
    p.add_argument("years", nargs="?", type=float, default=10.0)
    args = p.parse_args(argv)
    _common.setup(args, device, dtype, None, outdir)
    livetime = args.years * units.year
    if args.table is not None:
        import yaml

        with open(os.path.join(outdir, args.table)) as f:
            tab = yaml.safe_load(f)
        energies = np.asarray(tab["energies"], dtype=float)
        veff_sr = np.asarray(tab["veff"], dtype=float)
    else:
        energies, veff_sr = ENERGIES, VEFF_SR

    limit = fluxes.get_limit_e2_flux(energies, veff_sr, livetime)
    unit_flux = units.GeV / units.cm ** 2 / units.second
    print(f"livetime {livetime / units.year:.1f} yr")
    print(f"{'E [eV]':>10} {'Veff*sr [km^3 sr]':>18} {'E^2 phi [GeV/cm^2/s/sr]':>24}")
    for E, v, f2 in zip(energies, veff_sr, limit):
        print(f"{E / units.eV:10.2e} {v / (units.km ** 3):18.3e} {f2 / unit_flux:24.3e}")
    n_gzk = fluxes.get_number_of_events_for_flux(
        energies, fluxes.get_TAGZK_flux_ICRC2021(energies), veff_sr, livetime)
    print(f"expected TA-GZK (ICRC2021) events: {np.sum(n_gzk):.2f}")
    drawn = _figure(os.path.join(outdir, "sensitivity.png"), energies, limit, livetime,
                    unit_flux)
    return {"limit": np.asarray(limit), "n_gzk": float(np.sum(n_gzk)), "figure": drawn}


if __name__ == "__main__":
    main()
