"""A threshold-ladder Veff study in one simulation.

Counterpart of ``examples/09_threshold_ladder/run_ladder.py``: the dipole
station of example 01 with five named high/low triggers (1.5, 2, 2.5, 3 and
4 sigma) as one ``triggers=[...]`` list, every rung evaluated on the same
traces in one pass (kernel 2 with five columns), float32; then the Veff of
each rung and of the combination "loose_not_tight" (1.5 sigma and not 4
sigma) through the Veff table, exported to ``ladder_veffs.yaml``. The table
reads ``ladder_output.hdf5`` where h5py imports, else ``ladder_output.npz``
(the results dict)::

    python -m nuradiomc_tpu_torch.examples.e09_threshold_ladder.run_ladder [input]
"""

from __future__ import annotations

import os

import torch

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.examples.e01_veff_simulation.t02_run_simulation import (
    CONFIG, DETECTOR, FILTERS)
from nuradiomc_tpu_torch.sim import veff as veff_util
from nuradiomc_tpu_torch.sim.simulation import Simulation, TriggerSpec
from nuradiomc_tpu_torch.utils import units

SIGMAS = (1.5, 2.0, 2.5, 3.0, 4.0)
COMBINATIONS = {"loose_not_tight": {"triggers": ["hilo_1.5sigma"],
                                    "notriggers": ["hilo_4sigma"]}}


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("inputfile", nargs="?", default="1e18_full.hdf5")
    args = p.parse_args(argv)
    device, dtype = _common.setup(args, device, dtype, torch.float32, outdir)
    inputfile = _common.event_list(os.path.join(outdir, args.inputfile))
    output = os.path.join(outdir, "ladder_output.hdf5")
    out_hdf5, out_npz = _common.output_paths(output)
    sim = Simulation(
        inputfile, DETECTOR, config=CONFIG, filter_chain=FILTERS,
        triggers=[TriggerSpec(name=f"hilo_{s:g}sigma", threshold_high_sigma=s,
                              threshold_low_sigma=-s) for s in SIGMAS],
        outputfilename=out_hdf5, chunk_size=1024, device=device, dtype=dtype)
    results = sim.run()
    if out_npz is not None:
        _common.save_results(out_npz, results, sim)

    print(f"{'trigger':>14} {'n_trig':>7} {'Veff [km^3]':>12}")
    rungs = {}
    for iT, name in enumerate(results["trigger_names"]):
        n = int(results["multiple_triggers"][:, iT].sum())
        v = results["veff_per_trigger"][name] / units.km ** 3
        rungs[name] = (n, v)
        print(f"{name:>14} {n:>7} {v:>12.4f}")

    [post], route = _common.veff_tables(output, trigger_combinations=COMBINATIONS)
    combo = post["veffs"]["loose_not_tight"]
    print(f"{'loose_not_tight':>14} {combo[2]:>7.1f} {combo[0] / units.km**3:>12.4f}")
    yaml_path = os.path.join(outdir, "ladder_veffs.yaml")
    veff_util.export(yaml_path, [post])
    print(f"wrote {os.path.basename(out_hdf5 or out_npz)} + ladder_veffs.yaml "
          f"(Veff table from {route})")
    return {"rungs": rungs, "post": post, "route": route, "results": results,
            "yaml": yaml_path}


if __name__ == "__main__":
    main()
