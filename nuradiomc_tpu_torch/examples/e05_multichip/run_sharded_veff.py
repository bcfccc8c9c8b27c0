"""Effective-volume production over an ``(event, channel)`` process mesh.

Counterpart of ``examples/05_multichip/run_sharded_veff.py``, whose JAX mesh
is ``{'event': 4, 'channel': 2}`` over eight devices. Here the mesh is
``--procs`` processes (default 8: ``(procs // 2, 2)``, ``(procs, 1)`` for
an odd count) joined by ``torch.distributed`` over gloo
(``parallel.dryrun.spawn``), every rank on the same device (the card, or
the host with ``--device cpu``):

1. one step of the headline batch (64 groups x 2 showers x 4 channels, n_int
   256, n_base 512, float32) with the groups split over the event axis and
   the channels over the channel axis (kernels 1 and 2 on every rank), the
   global trigger count gathered over the event axis;
2. the production ``Simulation`` over the same mesh: 200 events (or the
   argument's count) at 1e18 eV, seed 21, made in memory, through four VPols,
   float64, chunks of 104 (whole chunks dealt over the event axis).

The mesh that ran is printed. The JAX example writes its input and output
HDF5 files to a temporary directory that nothing reads; here the list stays
in memory and no output file is written::

    python -m nuradiomc_tpu_torch.examples.e05_multichip.run_sharded_veff [n_events] [--procs 8]
"""

from __future__ import annotations

import numpy as np
import torch

from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.ops import pa_trigger, placement, raytrace, trigger_fused
from nuradiomc_tpu_torch.parallel import dryrun
from nuradiomc_tpu_torch.parallel import mesh as mesh_util
from nuradiomc_tpu_torch.sim import evtgen, io_input
from nuradiomc_tpu_torch.sim.pipeline import simulate_batch
from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu_torch.utils import units

DETECTOR = {
    "channels": {str(i + 1): {
        "adc_n_samples": 256, "adc_sampling_frequency": 1.0,
        "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
        "ant_position_x": 0.0, "ant_position_y": 0.0,
        "ant_position_z": -100.0 - 10.0 * i,
        "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
        "ant_type": "analytic_VPol", "amp_type": "", "cab_time_delay": 0.0,
        "adc_nbits": None, "channel_id": i, "station_id": 101,
    } for i in range(4)},
    "stations": {"1": {"pos_altitude": 0, "pos_easting": 0, "pos_northing": 0,
                       "pos_site": "southpole", "station_id": 101}},
}
CONFIG = {"sampling_rate": 2.0,
          "propagation": {"ice_model": "southpole_2015"},
          "signal": {"model": "Alvarez2000"},
          "weights": {"weight_mode": "core_mantle_crust_simple",
                      "cross_section_type": "ctw"}}
FILTERS = [FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
           FilterStage((0, 500 * units.MHz), "butter", {"order": 10})]
VOLUME = {"fiducial_rmin": 0, "fiducial_rmax": 3 * units.km,
          "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0}


def mesh_shape(n_procs):
    """The JAX example's mesh for ``n_procs`` devices."""
    return max(n_procs // 2, 1), 2 if n_procs % 2 == 0 else 1


def _worker(rank, n_procs, device, dtype, n_events):
    n_event, n_channel = mesh_shape(n_procs)
    mesh = mesh_util.make_mesh(n_event, n_channel, device=device)
    settings, ch, batch = convert.make_headline_inputs(
        n_groups=64, n_showers=2, n_channels=4, n_internal=256, n_base=512,
        device=mesh.device, dtype=torch.float32)
    out = simulate_batch(mesh_util.shard_batch(batch, mesh), ch, settings,
                         channel_axis=mesh.channel)
    triggered = mesh_util.all_gather(out.triggered, 0, mesh.event)
    step = {"n_trig": int(triggered.sum()), "n_groups": int(triggered.shape[0]),
            "max_amp_shape": tuple(out.max_amplitude.shape)}
    data, attrs = evtgen.generate_eventlist_cylinder(None, n_events, 1e18, 1e18, VOLUME,
                                                     seed=21)
    sim = Simulation(io_input.from_generated(data, attrs), DETECTOR, config=CONFIG,
                     filter_chain=FILTERS,
                     trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
                     chunk_size=104, device=device, dtype=dtype, mesh=mesh)
    res = sim.run()
    peak = (torch.cuda.max_memory_allocated(mesh.device) if mesh.device.type == "cuda" else 0)
    return {"mesh": mesh.shape, "device": str(mesh.device), "step": step, "peak_bytes": peak,
            "n_triggered": res["n_triggered"], "veff": res["veff"],
            "triggered": res["triggered"], "group_ids": res["group_ids"],
            "launches": {"placement_chain": placement.launches,
                         "placement_reduce": placement.reduce_launches,
                         "irfft_trigger": trigger_fused.launches,
                         "pa_trigger": pa_trigger.launches,
                         "ray_solver": raytrace.launches}}


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("n_events", nargs="?", type=int, default=200)
    p.add_argument("--procs", type=int, default=8)
    args = p.parse_args(argv)
    device, dtype = _common.setup(args, device, dtype, torch.float64, outdir)
    ranks = dryrun.spawn(_worker, args.procs, (device.type, dtype, args.n_events),
                         backend="gloo")
    r0 = ranks[0]
    step = r0["step"]
    print(f"processes: {args.procs} on {r0['device']}, mesh: {r0['mesh']}")
    print(f"max_amplitude of rank 0: {list(step['max_amp_shape'])} of "
          f"[{step['n_groups']}, 4] (groups over 'event', channels gathered over 'channel')")
    print(f"triggered {step['n_trig']} / {step['n_groups']} groups")
    print(f"production Simulation over mesh {r0['mesh']}: "
          f"n_triggered={r0['n_triggered']} veff={r0['veff']:.4g} m^3")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
    same = all(np.array_equal(r["triggered"], r0["triggered"]) for r in ranks)
    return {"mesh": r0["mesh"], "n_events": args.n_events, "step_triggered": step["n_trig"],
            "n_triggered": r0["n_triggered"], "veff": r0["veff"],
            "triggered": r0["triggered"], "group_ids": r0["group_ids"],
            "ranks_agree": same, "launches": launches,
            "peak_bytes": max(r["peak_bytes"] for r in ranks)}


if __name__ == "__main__":
    main()
