"""Step 1: a cal-pulser event list (``simulation_mode = "emitter"``).

Counterpart of ``examples/10_pulser_calibration/A01_generate_pulser_events.py``:
24 pulses (or the argument's count) of a square-pulse voltage emitter
driving an upright bicone at (500, 0, -180) m, amplitudes from 1 V to 1 kV
on a geometric ladder. Written as ``emitter_event_list.hdf5`` where h5py
imports, else as the ``.npz`` export of the ``EventInput`` that reading the
HDF5 file gives::

    python -m nuradiomc_tpu_torch.examples.e10_pulser_calibration.a01_generate_pulser_events [n]
"""

from __future__ import annotations

import os

import numpy as np

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.sim import io_input
from nuradiomc_tpu_torch.sim.io_hdf5 import EventInput
from nuradiomc_tpu_torch.utils import units


def pulser_columns(n):
    """(attributes, datasets) of the list, as the JAX example writes them."""
    attrs = {"simulation_mode": "emitter", "n_events": n, "start_event_id": 0}
    data = {
        "event_group_ids": np.arange(n), "shower_ids": np.arange(n),
        "emitter_model": np.array([b"square"] * n),
        "emitter_amplitudes": np.geomspace(1.0, 1000.0, n),
        "emitter_half_width": np.full(n, 1.0 * units.ns),
        "emitter_frequency": np.full(n, 0.3 * units.GHz),
        "emitter_antenna_type": np.array([b"bicone_v8_inf_n1.78"] * n),
        "emitter_orientation_phi": np.zeros(n), "emitter_orientation_theta": np.zeros(n),
        "emitter_rotation_phi": np.zeros(n),
        "emitter_rotation_theta": np.full(n, 90 * units.deg),
        "xx": np.full(n, 500.0), "yy": np.zeros(n), "zz": np.full(n, -180.0)}
    return attrs, data


def pulser_input(n) -> EventInput:
    """The ``EventInput`` that ``io_hdf5.read_input_hdf5`` builds from the
    list: the emitter columns, and the shower columns it fills in for an
    emitter list (energies from the amplitudes, hadronic, flavor 0, nc)."""
    attrs, data = pulser_columns(n)
    amps = data["emitter_amplitudes"]
    return EventInput(
        event_group_ids=data["event_group_ids"], shower_ids=data["shower_ids"],
        xx=data["xx"], yy=data["yy"], zz=data["zz"], zeniths=np.zeros(n),
        azimuths=np.zeros(n), energies=amps, shower_energies=amps,
        shower_type=np.full(n, "had", dtype="U8"), flavors=np.zeros(n, dtype=int),
        interaction_type=np.full(n, "nc", dtype="U8"), inelasticity=np.ones(n),
        vertex_times=np.zeros(n), attrs=attrs,
        emitter={k: v for k, v in data.items() if k.startswith("emitter_")})


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=24)
    args = p.parse_args(argv)
    _common.setup(args, device, dtype, None, outdir)
    path = os.path.join(outdir, "emitter_event_list.hdf5")
    if _common.hdf5():
        import h5py

        attrs, data = pulser_columns(args.n)
        with h5py.File(path, "w") as f:
            f.attrs.update(attrs)
            for k, v in data.items():
                f[k] = v
        route = "hdf5"
    else:
        path = os.path.splitext(path)[0] + ".npz"
        io_input.write_input_npz(pulser_input(args.n), path)
        route = "npz (no h5py)"
    print(f"wrote {os.path.basename(path)} ({args.n} pulser events, route: {route})")
    return {"path": path, "route": route, "n": args.n}


if __name__ == "__main__":
    main()
