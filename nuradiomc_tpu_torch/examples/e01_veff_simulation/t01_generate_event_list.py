"""Step 1: generate a 1e18 eV forced-interaction event list.

Counterpart of ``examples/01_Veff_simulation/T01_generate_event_list.py``:
10,000 events at seed 10 in a 4 km x 2.7 km cylinder (an optional argument
sets the count). Written as ``1e18_full.hdf5`` where h5py imports, else as
its ``.npz`` export ``1e18_full.npz``::

    python -m nuradiomc_tpu_torch.examples.e01_veff_simulation.t01_generate_event_list [n]
"""

from __future__ import annotations

import os

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.sim import evtgen
from nuradiomc_tpu_torch.utils import units

VOLUME = {"fiducial_rmin": 0 * units.km, "fiducial_rmax": 4 * units.km,
          "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0 * units.km}
SEED = 10


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("n_events", nargs="?", type=float, default=1e4)
    args = p.parse_args(argv)
    _common.setup(args, device, dtype, None, outdir)
    data, attrs = evtgen.generate_eventlist_cylinder(
        None, args.n_events, 1e18 * units.eV, 1e18 * units.eV, VOLUME, seed=SEED)
    path, route = _common.write_event_list(os.path.join(outdir, "1e18_full.hdf5"), data, attrs)
    print(f"wrote {os.path.basename(path)} (route: {route})")
    return {"path": path, "route": route, "n_events": int(attrs["n_events"]),
            "n_showers": len(data["shower_ids"])}


if __name__ == "__main__":
    main()
