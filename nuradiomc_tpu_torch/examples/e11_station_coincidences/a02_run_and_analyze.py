"""Step 2: simulate the grid and count station coincidences.

Counterpart of ``examples/11_station_coincidences/A02_run_and_analyze.py``:
400 events (or the argument's count) at 1e19 eV, seed 7, in a 3 km x 2.7 km
cylinder through the stations of ``coincidence_detector.json``, a 2 sigma
high/low trigger, float64, chunks of 256, on the card (kernels 1 and 2 once
per chunk and station); then, for every triggered group, how many stations
fired, and per station how many of its groups fired the center too. Each
station's decisions come from the output HDF5's station groups where h5py
imports, else from the results dict::

    python -m nuradiomc_tpu_torch.examples.e11_station_coincidences.a02_run_and_analyze [n]
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.sim import evtgen
from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu_torch.utils import units

VOLUME = {"fiducial_rmin": 0, "fiducial_rmax": 3 * units.km,
          "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0}
CONFIG = {"sampling_rate": 2.0,
          "propagation": {"ice_model": "southpole_2015"},
          "signal": {"model": "Alvarez2000"},
          "weights": {"weight_mode": "core_mantle_crust_simple",
                      "cross_section_type": "ctw"}}
FILTERS = [FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
           FilterStage((0, 500 * units.MHz), "butter", {"order": 10})]


def _fired_hdf5(path):
    """Each station's fired groups from the output file's station groups."""
    import h5py

    fired = {}
    with h5py.File(path) as f:
        for key in f:
            if not key.startswith("station_"):
                continue
            sid = int(key.split("_")[1])
            grp = f[key]
            if "event_group_ids" not in grp:
                fired[sid] = set()
                continue
            egid = np.asarray(grp["event_group_ids"])
            mt = np.asarray(grp["multiple_triggers_per_event"])
            fired[sid] = set(int(g) for g in egid[np.any(mt, axis=1)])
    return fired


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=400)
    args = p.parse_args(argv)
    device, dtype = _common.setup(args, device, dtype, torch.float64, outdir)
    n = args.n
    data, attrs = evtgen.generate_eventlist_cylinder(None, n, 1e19, 1e19, VOLUME, seed=7)
    infile, list_route = _common.write_event_list(
        os.path.join(outdir, "coincidence_events.hdf5"), data, attrs)
    with open(os.path.join(outdir, "coincidence_detector.json")) as f:
        det = json.load(f)
    out_hdf5, out_npz = _common.output_paths(os.path.join(outdir, "coincidence_output.hdf5"))
    sim = Simulation(infile, det, config=CONFIG, filter_chain=FILTERS,
                     trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
                     chunk_size=256, device=device, dtype=dtype, outputfilename=out_hdf5)
    res = sim.run()
    station_pos = {int(s["station_id"]): (s["pos_easting"], s["pos_northing"])
                   for s in det["stations"].values()}
    if out_hdf5 is not None:
        fired = _fired_hdf5(out_hdf5)
        route = "hdf5"
    else:
        _common.save_results(out_npz, res, sim)
        gids = res["group_ids"]
        fired = {int(sid): set(int(g) for g in gids[trig])
                 for sid, trig in res["triggered_per_station"].items()}
        route = "results dict (no h5py)"

    n_trig = int(np.sum(res["triggered"]))
    all_fired = sorted(set().union(*fired.values())) if fired else []
    counts = {g: sum(g in s for s in fired.values()) for g in all_fired}
    n_coinc = sum(1 for c in counts.values() if c >= 2)
    print(f"event list {list_route}, station decisions from {route}")
    print(f"triggered {n_trig} / {n} event groups (any station)")
    rows = {}
    for sid in sorted(fired):
        x, y = station_pos[sid]
        d = float(np.hypot(x, y))
        with_center = sum(1 for g in fired[sid] if g in fired.get(101, set()))
        rows[sid] = (len(fired[sid]), with_center)
        print(f"station {sid} (d={d:7.1f} m): {len(fired[sid]):4d} triggers, "
              f"{with_center:4d} in coincidence with center")
    print(f"coincidences (>=2 stations): {n_coinc} / {len(all_fired)} triggered groups")
    return {"n_triggered": n_trig, "n_coincidences": n_coinc, "fired": fired,
            "stations": rows, "route": route, "results": res}


if __name__ == "__main__":
    main()
