"""Step 3: the effective-volume table of step 2's output.

Counterpart of ``examples/01_Veff_simulation/T03_visualize_Veff.py``:
``veff.get_Veff_Aeff("output.hdf5")`` where h5py imports, else the same
table from ``output.npz``, step 2's results dict::

    python -m nuradiomc_tpu_torch.examples.e01_veff_simulation.t03_visualize_veff
"""

from __future__ import annotations

import os

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.sim import veff
from nuradiomc_tpu_torch.utils import units


def main(argv=None, *, device=None, dtype=None, outdir="."):
    args = _common.parser(__doc__.splitlines()[0]).parse_args(argv)
    _common.setup(args, device, dtype, None, outdir)
    tables, route = _common.veff_tables(os.path.join(outdir, "output.hdf5"))
    print(f"Veff table from {route}")
    rows = []
    for r in tables:
        v_sr = r["veff"] * r["solid_angle"]
        v_we = veff.get_Veff_water_equivalent(v_sr)
        print(f"E = {r['energy']:.3g} eV : "
              f"Veff = {v_sr / units.km ** 3:.4f} km^3 sr "
              f"({v_we / units.km ** 3:.4f} km^3 sr water equ.), "
              f"{r['n_triggered']} triggers, "
              f"+{(r['veff_high'] - r['veff']) / max(r['veff'], 1e-30) * 100:.0f}% "
              f"-{(r['veff'] - r['veff_low']) / max(r['veff'], 1e-30) * 100:.0f}%")
        rows.append({"energy": r["energy"], "veff_sr": v_sr, "veff_water": v_we,
                     "n_triggered": r["n_triggered"]})
    return {"route": route, "tables": tables, "rows": rows}


if __name__ == "__main__":
    main()
