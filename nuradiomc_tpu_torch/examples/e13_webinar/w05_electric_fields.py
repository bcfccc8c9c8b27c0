"""Webinar part 5: electric fields and voltage traces from the ``.nur`` file.

Counterpart of ``examples/13_webinar/W05_electric_fields.py``: for the
first events of the ``.nur`` file (until 8 electric fields are shown), each
SimStation electric field's peak eTheta and energy fluence, and each
channel's peak-to-peak voltage. The ``.nur`` files need no h5py::

    python -m nuradiomc_tpu_torch.examples.e13_webinar.w05_electric_fields [file.nur]
"""

from __future__ import annotations

import os

import numpy as np

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.sim.io_nur import EventReader


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("fname", nargs="?", default="results/NuMC_output.nur")
    args = p.parse_args(argv)
    _common.setup(args, device, dtype, None, outdir)
    reader = EventReader(os.path.join(outdir, args.fname))
    n_shown = 0
    fields, vpp = [], []
    for event in reader.get_events():
        for station in event.get_stations():
            sim_station = station.get_sim_station() if station.has_sim_station() else None
            if sim_station is None:
                continue
            for efield in sim_station.get_electric_fields():
                trace = np.asarray(efield.get_trace())
                tt = efield.get_times()
                fluence = np.trapezoid(np.sum(trace ** 2, axis=0), tt)
                print(f"event {event.get_id()} station {station.get_id()} "
                      f"channels {efield.get_channel_ids()} "
                      f"ray {efield.get_ray_tracing_solution_id()}: "
                      f"|eTheta|max = {np.abs(trace[1]).max():.3g} V/m, "
                      f"energy fluence ~ {fluence:.3g}")
                fields.append((event.get_id(), float(np.abs(trace[1]).max()), float(fluence)))
                n_shown += 1
            for channel in station.iter_channels():
                v = np.asarray(channel.get_trace())
                vpp.append(float(v.max() - v.min()))
                print(f"  channel {channel.get_id()}: Vpp = {v.max() - v.min():.3g} V")
        if n_shown >= 8:
            break
    reader.end()
    print("done;", n_shown, "electric fields inspected")
    return {"n_shown": n_shown, "fields": fields, "vpp": vpp}


if __name__ == "__main__":
    main()
