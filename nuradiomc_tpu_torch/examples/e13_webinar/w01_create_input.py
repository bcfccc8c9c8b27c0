"""Webinar part 1: the input event lists.

Counterpart of ``examples/13_webinar/W01_create_input.py``: 1000 events
(or the argument's count) at 1e18 eV, seed 128, and the same count on a
log-uniform spectrum from 3.2e17 to 1e19 eV of tau (anti)neutrinos in
charged-current interactions with stochastic secondaries, seed 129, in a 2
km x 3 km cylinder, written to ``input/`` as ``.hdf5`` where h5py imports,
else as ``.npz`` exports::

    python -m nuradiomc_tpu_torch.examples.e13_webinar.w01_create_input [n_events]
"""

from __future__ import annotations

import os

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.sim import evtgen
from nuradiomc_tpu_torch.utils import units

VOLUME = {"fiducial_rmin": 0 * units.km, "fiducial_rmax": 2 * units.km,
          "fiducial_zmin": -3 * units.km, "fiducial_zmax": 0 * units.km}


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("n_events", nargs="?", type=float, default=1000)
    args = p.parse_args(argv)
    _common.setup(args, device, dtype, None, outdir)
    n_events = int(args.n_events)
    out_dir = os.path.join(outdir, "input")
    os.makedirs(out_dir, exist_ok=True)
    lists = {
        "input_1e18.hdf5": evtgen.generate_eventlist_cylinder(
            None, n_events, 1e18 * units.eV, 1e18 * units.eV, VOLUME, seed=128,
            cross_sections_model="ctw"),
        "input_3.2e+17_1.0e+19.hdf5": evtgen.generate_eventlist_cylinder(
            None, n_events, 3.2e17 * units.eV, 1e19 * units.eV, VOLUME, seed=129,
            spectrum="log_uniform", flavor=(16, -16), interaction_type="cc",
            secondaries="stochastic", cross_sections_model="ctw")}
    written = {}
    for name, (data, attrs) in lists.items():
        path, route = _common.write_event_list(os.path.join(out_dir, name), data, attrs)
        written[name] = (path, len(data["shower_ids"]))
    print("wrote", " and ".join(os.path.relpath(p, outdir) for p, _ in written.values()),
          f"(route: {route})")
    return {"lists": written, "route": route}


if __name__ == "__main__":
    main()
