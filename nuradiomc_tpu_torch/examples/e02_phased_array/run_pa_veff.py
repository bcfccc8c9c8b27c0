"""The deep 4-channel phased array's Veff with noise.

Counterpart of ``examples/02_phased_array/run_pa_veff.py`` (NuRadioMC's
test/Veff/1e18eV/D05phased_array_deep.py): cheby1 filters, the trigger ADC,
x2 upsampling, 11 beams, the power threshold at 30.85 Vrms^2 (~100 Hz),
Alvarez2009, focusing, float32, chunks of 512 groups, on the card (kernels 1
and 3). Noise comes from the port's generators, so the triggered count is
held to the JAX example's statistically. Reads ``1e18_full.hdf5`` (or its
``.npz`` export); writes ``output_pa.hdf5``, or ``output_pa.npz`` (the
results dict) where h5py is missing::

    python -m nuradiomc_tpu_torch.examples.e02_phased_array.run_pa_veff [input]
"""

from __future__ import annotations

import os

import torch

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu_torch.utils import units

DETECTOR = {
    "channels": {str(i + 1): {
        "adc_n_samples": 256, "adc_sampling_frequency": 0.5, "adc_nbits": 8,
        "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
        "ant_position_x": 0.0, "ant_position_y": 0.0,
        "ant_position_z": -197.0 - i,
        "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
        "ant_type": "analytic_VPol", "amp_type": "", "cab_time_delay": 1051.0,
        "channel_id": i, "station_id": 1,
    } for i in range(4)},
    "stations": {"1": {"station_id": 1, "pos_altitude": 0,
                       "pos_easting": 0, "pos_northing": 0}},
}
CONFIG = {"sampling_rate": 2.0, "noise": True,
          "propagation": {"ice_model": "southpole_2015", "focusing": True},
          "signal": {"model": "Alvarez2009"},
          "weights": {"weight_mode": "core_mantle_crust_simple",
                      "cross_section_type": "ctw"}}
FILTERS = [FilterStage((96 * units.MHz, 100 * units.GHz), "cheby1", {"order": 4, "rp": 0.1}),
           FilterStage((0, 220 * units.MHz), "cheby1", {"order": 7, "rp": 0.1})]
TRIGGER = TriggerSpec(trigger_type="phased_array", pa_threshold_factor=30.85)


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("inputfile", nargs="?", default="1e18_full.hdf5")
    args = p.parse_args(argv)
    device, dtype = _common.setup(args, device, dtype, torch.float32, outdir)
    inputfile = _common.event_list(os.path.join(outdir, args.inputfile))
    out_hdf5, out_npz = _common.output_paths(os.path.join(outdir, "output_pa.hdf5"))
    sim = Simulation(inputfile, DETECTOR, config=CONFIG, filter_chain=FILTERS, trigger=TRIGGER,
                     outputfilename=out_hdf5, chunk_size=512, device=device, dtype=dtype)
    results = sim.run()
    if out_npz is not None:
        _common.save_results(out_npz, results, sim)
    veff_sr = results["veff"] / units.km ** 3 * 4 * 3.14159265
    print(f"output {os.path.basename(out_hdf5 or out_npz)}")
    print(f"n_triggered = {results['n_triggered']}, Veff*4pi = {veff_sr:.3f} km^3 sr")
    return {"n_triggered": results["n_triggered"], "veff": results["veff"],
            "veff_sr_km3": veff_sr, "results": results,
            "n_groups": len(results["group_ids"])}


if __name__ == "__main__":
    main()
