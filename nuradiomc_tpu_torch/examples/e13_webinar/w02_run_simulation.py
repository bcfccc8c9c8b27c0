"""Webinar part 2: the simulation.

Counterpart of ``examples/13_webinar/W02_run_simulation.py``: four bicones
(the analytic VPol in their place) between -90 and -97.5 m in Greenland ice
with GL1 attenuation, noise, Alvarez2009, the minimum-weight and
minimum-efield speedups, a 700 MHz low-pass and a 150 MHz high-pass, two
named triggers in one pass (a 2-of-4 high/low at 5 sigma within 40 ns and a
3 sigma threshold), float64, on the card (kernels 1 and 2; the ``.nur``
output re-runs the triggered groups with their traces). Writes the output
HDF5, or its ``.npz`` (the results dict) where h5py is missing, and the
``.nur`` file when asked for::

    python -m nuradiomc_tpu_torch.examples.e13_webinar.w02_run_simulation \\
        [--inputfilename input/input_1e18.hdf5] \\
        [--outputfilename results/NuMC_output.hdf5] \\
        [--outputfilenameNuRadioReco results/NuMC_output.nur]
"""

from __future__ import annotations

import os

import torch

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu_torch.utils import units


def channel(cid, z):
    return {"adc_n_samples": 256, "adc_sampling_frequency": 2.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
            "ant_position_x": 0.0, "ant_position_y": 0.0, "ant_position_z": z,
            "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
            "ant_type": "bicone_v8_inf_n1.78", "amp_type": "",
            "cab_time_delay": 0.0, "adc_nbits": None,
            "channel_id": cid, "station_id": 101}


DETECTOR = {
    "channels": {str(i + 1): channel(i, -90.0 - 2.5 * i) for i in range(4)},
    "stations": {"1": {"station_id": 101, "pos_altitude": 0, "pos_easting": 0,
                       "pos_northing": 0, "pos_site": "greenland"}},
}
CONFIG = {"sampling_rate": 2.0, "noise": True,
          "propagation": {"ice_model": "greenland_simple", "attenuation_model": "GL1"},
          "signal": {"model": "Alvarez2009"},
          "speedup": {"minimum_weight_cut": 1e-5, "min_efield_amplitude": 2},
          "trigger": {"noise_temperature": 300},
          "weights": {"weight_mode": "core_mantle_crust_simple",
                      "cross_section_type": "ctw"}}
FILTERS = [FilterStage((1 * units.MHz, 700 * units.MHz), "butter", {"order": 10}),
           FilterStage((150 * units.MHz, 800 * units.GHz), "butter", {"order": 8})]
TRIGGERS = [TriggerSpec(name="hilo_2of4_5sigma", threshold_high_sigma=5.0,
                        threshold_low_sigma=-5.0, highlow_coincidence=40.0,
                        number_of_coincidences=2, channels=(0, 1, 2, 3)),
            TriggerSpec(name="simple_3sigma", trigger_type="simple_threshold",
                        threshold_high_sigma=3.0)]


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--inputfilename", default="input/input_1e18.hdf5")
    p.add_argument("--outputfilename", default="results/NuMC_output.hdf5")
    p.add_argument("--outputfilenameNuRadioReco", default=None)
    args = p.parse_args(argv)
    device, dtype = _common.setup(args, device, dtype, torch.float64, outdir)
    output = os.path.join(outdir, args.outputfilename)
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    out_hdf5, out_npz = _common.output_paths(output)
    nur = (os.path.join(outdir, args.outputfilenameNuRadioReco)
           if args.outputfilenameNuRadioReco else None)
    sim = Simulation(_common.event_list(os.path.join(outdir, args.inputfilename)), DETECTOR,
                     config=CONFIG, filter_chain=FILTERS, triggers=TRIGGERS,
                     antenna_replacements={"bicone_v8_inf_n1.78": "analytic_VPol"},
                     outputfilename=out_hdf5, nur_outputfilename=nur, device=device,
                     dtype=dtype)
    res = sim.run()
    if out_npz is not None:
        _common.save_results(out_npz, res, sim)
    print(f"output {os.path.relpath(out_hdf5 or out_npz, outdir)}"
          + (f" and {os.path.relpath(nur, outdir)}" if nur else ""))
    print(f"simulated {len(res['triggered'])} events; "
          f"{int(res['n_triggered'])} triggered; Veff = "
          f"{res['veff'] / units.km ** 3:.4g} km^3 (x 4pi sr for water "
          f"equivalent comparisons)")
    return {"n_triggered": int(res["n_triggered"]), "veff": res["veff"], "results": res}


if __name__ == "__main__":
    main()
