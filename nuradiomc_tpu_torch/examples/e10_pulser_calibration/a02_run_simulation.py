"""Step 2: propagate the pulser signals to a 4-dipole station and trigger.

Counterpart of ``examples/10_pulser_calibration/A02_run_simulation.py``:
the emitter run folds the square pulse with the emitting bicone's VEL
(the analytic VPol in its place), traces it through ARAsim_southpole ice
with focusing to four VPols at -170 to -200 m, and triggers a 2-of-4
high/low at 2 sigma; float64, chunks of 32, on the card (kernel 4 places the
materialized voltage spectra, kernel 2 triggers). The sweep must be
monotone: once an amplitude triggers, every larger one does::

    python -m nuradiomc_tpu_torch.examples.e10_pulser_calibration.a02_run_simulation [input]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu_torch.utils import units

DETECTOR = {
    "channels": {str(i + 1): {
        "adc_n_samples": 512, "adc_sampling_frequency": 1.0,
        "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
        "ant_position_x": 0.0, "ant_position_y": 0.0,
        "ant_position_z": -170.0 - 10 * i,
        "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
        "ant_type": "bicone_v8_inf_n1.78", "amp_type": "",
        "cab_time_delay": 0.0, "adc_nbits": None,
        "channel_id": i, "station_id": 2,
    } for i in range(4)},
    "stations": {"2": {"station_id": 2, "pos_altitude": 0,
                       "pos_easting": 0, "pos_northing": 0}},
}
CONFIG = {"sampling_rate": 5.0, "noise": False,
          "propagation": {"ice_model": "ARAsim_southpole", "focusing": True},
          "trigger": {"noise_temperature": 300}}
FILTERS = [FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
           FilterStage((0, 500 * units.MHz), "butter", {"order": 10})]
TRIGGERS = [TriggerSpec(name="dipole_2.0sigma", trigger_type="high_low",
                        threshold_high_sigma=2.0, threshold_low_sigma=-2.0,
                        number_of_coincidences=2)]


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("inputfile", nargs="?", default="emitter_event_list.hdf5")
    args = p.parse_args(argv)
    device, dtype = _common.setup(args, device, dtype, torch.float64, outdir)
    out_hdf5, out_npz = _common.output_paths(os.path.join(outdir, "pulser_output.hdf5"))
    sim = Simulation(_common.event_list(os.path.join(outdir, args.inputfile)), DETECTOR,
                     config=CONFIG, filter_chain=FILTERS, triggers=TRIGGERS,
                     antenna_replacements={"bicone_v8_inf_n1.78": "analytic_VPol"},
                     chunk_size=32, device=device, dtype=dtype, outputfilename=out_hdf5)
    res = sim.run()
    if out_npz is not None:
        _common.save_results(out_npz, res, sim)
    sweep = np.asarray(res["triggered"]).astype(int).tolist()
    n_trig = int(np.sum(res["triggered"]))
    print(f"output {os.path.basename(out_hdf5 or out_npz)}")
    print(f"triggered {n_trig} / {len(res['triggered'])} pulser events")
    print("amplitude sweep:", sweep)
    return {"n_triggered": n_trig, "sweep": sweep, "results": res}


if __name__ == "__main__":
    main()
