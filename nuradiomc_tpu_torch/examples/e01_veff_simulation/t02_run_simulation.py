"""Step 2: the dipole Veff simulation.

Counterpart of ``examples/01_Veff_simulation/T02_run_simulation.py``: one
analytic VPol at 100 m, Alvarez2000, southpole_2015, two Butterworth filters,
a 2 sigma high/low trigger, float32 (``dtype=`` changes it), chunks of 1024
groups, on the card (kernels 1 and 2). Reads ``1e18_full.hdf5`` (or its
``.npz`` export) and writes ``output.hdf5``, or ``output.npz`` (the results
dict) where h5py is missing::

    python -m nuradiomc_tpu_torch.examples.e01_veff_simulation.t02_run_simulation [input]
"""

from __future__ import annotations

import os

import torch

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu_torch.utils import units

DETECTOR = {
    "channels": {"1": {
        "adc_n_samples": 256, "adc_sampling_frequency": 1.0,
        "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
        "ant_position_x": 0.0, "ant_position_y": 0.0, "ant_position_z": -100.0,
        "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
        "ant_type": "analytic_VPol", "amp_type": "", "cab_time_delay": 19.8,
        "adc_nbits": None, "channel_id": 0, "station_id": 101,
    }},
    "stations": {"1": {"station_id": 101, "pos_altitude": 0,
                       "pos_easting": 0, "pos_northing": 0}},
}
CONFIG = {"sampling_rate": 2.0,
          "propagation": {"ice_model": "southpole_2015"},
          "signal": {"model": "Alvarez2000"},
          "weights": {"weight_mode": "core_mantle_crust_simple",
                      "cross_section_type": "ctw"}}
FILTERS = [FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
           FilterStage((0, 500 * units.MHz), "butter", {"order": 10})]


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("inputfile", nargs="?", default="1e18_full.hdf5")
    args = p.parse_args(argv)
    device, dtype = _common.setup(args, device, dtype, torch.float32, outdir)
    inputfile = _common.event_list(os.path.join(outdir, args.inputfile))
    out_hdf5, out_npz = _common.output_paths(os.path.join(outdir, "output.hdf5"))
    sim = Simulation(inputfile, DETECTOR, config=CONFIG, filter_chain=FILTERS,
                     trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
                     outputfilename=out_hdf5, chunk_size=1024, device=device, dtype=dtype)
    results = sim.run()
    if out_npz is not None:
        _common.save_results(out_npz, results, sim)
    print(f"input {os.path.basename(inputfile)}, output "
          f"{os.path.basename(out_hdf5 or out_npz)} (route: "
          f"{'hdf5' if out_hdf5 else 'results dict (no h5py)'})")
    print(f"n_triggered = {results['n_triggered']}, "
          f"Veff = {results['veff'] / units.km ** 3:.4f} km^3")
    return {"n_triggered": results["n_triggered"], "veff": results["veff"],
            "results": results, "n_groups": len(results["group_ids"])}


if __name__ == "__main__":
    main()
