"""Webinar part 4: effective volumes.

Counterpart of ``examples/13_webinar/W04_effective_volumes.py``: the Veff
of every output file in a folder by energy and trigger
(``veff.get_Veff_Aeff`` and ``get_Veff_Aeff_array`` on the HDF5 files where
h5py imports, else the same tables from their ``.npz`` results), exported
to ``Veff_webinar.json``::

    python -m nuradiomc_tpu_torch.examples.e13_webinar.w04_effective_volumes [folder]
"""

from __future__ import annotations

import os

import numpy as np

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.sim import veff as Veff
from nuradiomc_tpu_torch.utils import units


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("folder", nargs="?", default="results")
    args = p.parse_args(argv)
    _common.setup(args, device, dtype, None, outdir)
    data, route = _common.veff_tables(os.path.join(outdir, args.folder))
    (veff_array, energies, energies_low, energies_high,
     zenith_bins, trigger_names) = Veff.get_Veff_Aeff_array(data)
    print(f"Veff tables from {route}")
    rows = {}
    for ie, energy in enumerate(energies):
        for it, name in enumerate(trigger_names):
            v = veff_array[ie, 0, it, 0]
            err = veff_array[ie, 0, it, 1]
            rows[(float(energy), str(name))] = (float(v), float(err))
            print(f"E = {energy / units.eV:.3g} eV  {name}: "
                  f"Veff = {v * 4 * np.pi / units.km ** 3:.4g} "
                  f"+- {err * 4 * np.pi / units.km ** 3:.2g} km^3 sr")
    Veff.export(os.path.join(outdir, "Veff_webinar.json"), data, export_format="json")
    print("wrote Veff_webinar.json")
    return {"rows": rows, "route": route}


if __name__ == "__main__":
    main()
