"""A custom event-generator template: an input event list built by hand.

Counterpart of ``examples/15_custom_generator/generate_my_events.py``
(NuRadioMC's EvtGen/generator_skeleton.py): the file-level attributes and
the per-shower columns ``Simulation`` reads, with dummy kinematics from
numpy's ``default_rng(0)``. Written as ``testfile.hdf5`` where h5py imports,
else as its ``.npz`` export ``testfile.npz`` (either feeds ``Simulation``)::

    python -m nuradiomc_tpu_torch.examples.e15_custom_generator.generate_my_events [n]
"""

from __future__ import annotations

import os

import numpy as np

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.utils import units


def generate_my_events(filename, n_events, rng=None):
    """Writes the list to ``filename`` (its ``.npz`` export without h5py);
    returns (datasets, attributes, path written)."""
    rng = rng or np.random.default_rng(0)
    n_events = int(n_events)

    # file-level attributes
    attributes = {
        "n_events": n_events,          # thrown events (denominator of Veff)
        "start_event_id": 0,
        # fiducial volume: only interactions inside it are kept
        "fiducial_rmin": 0.0, "fiducial_rmax": 1 * units.km,
        "fiducial_zmin": -2 * units.km, "fiducial_zmax": 0.0,
        # full generation volume (== fiducial here)
        "rmin": 0.0, "rmax": 1 * units.km, "zmin": -2 * units.km, "zmax": 0.0,
        # energy and angular ranges of the thrown flux
        "Emin": 1 * units.EeV, "Emax": 1 * units.EeV,
        "thetamin": 0.0, "thetamax": np.pi, "phimin": 0.0, "phimax": 2 * np.pi,
    }
    attributes["volume"] = np.pi * attributes["rmax"] ** 2 * abs(attributes["zmin"])

    # per-shower columns the radio simulation reads
    data_sets = {
        "xx": rng.uniform(-500.0, 500.0, n_events),
        "yy": rng.uniform(-500.0, 500.0, n_events),
        "zz": rng.uniform(-2000.0, -100.0, n_events),
        "zeniths": np.arccos(rng.uniform(-1, 1, n_events)),
        "azimuths": rng.uniform(0, 2 * np.pi, n_events),
        "shower_energies": np.full(n_events, 1 * units.EeV),
        "shower_type": ["had"] * n_events,          # 'had' or 'em'
        # one event group per shower; showers with the same group id sum
        # their signals in one trigger window
        "event_group_ids": np.arange(n_events),
        "shower_ids": np.arange(n_events),
    }
    # bookkeeping (weights and the output schema)
    data_sets["n_interaction"] = np.ones(n_events, dtype=int)
    data_sets["flavors"] = np.full(n_events, 12, dtype=int)  # PDG code
    data_sets["energies"] = np.full(n_events, 1 * units.EeV)
    data_sets["interaction_type"] = np.full(n_events, "nc", dtype="U2")
    data_sets["inelasticity"] = np.ones(n_events)
    # optional: data_sets["vertex_times"], data_sets["weights"]

    path, _ = _common.write_event_list(filename, data_sets, attributes)
    return data_sets, attributes, path


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=20)
    args = p.parse_args(argv)
    _common.setup(args, device, dtype, None, outdir)
    data, attrs, path = generate_my_events(os.path.join(outdir, "testfile.hdf5"), args.n)
    print(f"wrote {os.path.basename(path)} ({args.n} events)")
    return {"path": path, "data": data, "attrs": attrs}


if __name__ == "__main__":
    main()
