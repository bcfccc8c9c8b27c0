"""Multi-process runs of the port, and the sharded-equals-single dryrun.

:func:`spawn` runs a function in ``n_procs`` fresh processes
(``torch.multiprocessing.spawn``: a card needs the spawn start method) that
form one process group through a ``file://`` rendezvous in a temporary
directory, so parallel callers never share a port. Each process uses one
CPU thread. A failure in any rank raises in the caller: the process group
has a timeout, so ranks waiting on a failed one raise instead of hanging,
and ``spawn`` stops the others as soon as one fails.

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.dryrun_multichip``: the production orchestrator
(``Simulation.run``) on an ``(n/2, 2)`` mesh (``(n, 1)`` for an odd n)
against the same run in one process, on the 300-event ``evtgen`` list made
in memory (no h5py), in chunks of 64 groups (which do not divide 300), through a 4-VPol station with two named triggers
(``hilo_2sig``, ``simple_3sig``). ``triggered`` and ``multiple_triggers``
must be equal and Veff must agree at rtol 1e-12::

    python -m nuradiomc_tpu_torch.parallel.dryrun 4 --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import datetime
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from nuradiomc_tpu_torch.parallel import mesh as mesh_util

DRYRUN_CHUNK = 64       # does not divide the list's 300 groups


def _entry(rank, n_procs, tmp, backend, timeout, fn, args):
    torch.set_num_threads(1)
    mesh_util.init_distributed(backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
                               timeout=timeout, rank=rank, world_size=n_procs)
    out = fn(rank, n_procs, *args)
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def spawn(fn, n_procs: int, args=(), backend: str = "nccl",
          timeout: datetime.timedelta = mesh_util.DEFAULT_TIMEOUT) -> list:
    """``fn(rank, n_procs, *args)`` in ``n_procs`` processes joined in one
    process group (``backend``, ``timeout``); returns each rank's return
    value (picklable), in rank order. ``fn`` must be a module-level
    function."""
    with tempfile.TemporaryDirectory(prefix="nuradiomc_mesh_") as tmp:
        torch.multiprocessing.spawn(_entry, args=(n_procs, tmp, backend, timeout, fn, args),
                                    nprocs=n_procs, join=True)
        results = []
        for r in range(n_procs):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def dryrun_detector() -> dict:
    """The dryrun's station: four analytic VPols 10 m apart below 100 m."""
    def channel(cid):
        return {
            "adc_n_samples": 256, "adc_sampling_frequency": 1.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
            "ant_position_x": 0.0, "ant_position_y": 0.0,
            "ant_position_z": -100.0 - 10.0 * cid,
            "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
            "ant_type": "analytic_VPol", "amp_type": "", "cab_time_delay": 0.0,
            "adc_nbits": None, "channel_id": cid, "station_id": 101,
        }

    return {"channels": {str(i + 1): channel(i) for i in range(4)},
            "stations": {"1": {"pos_altitude": 0, "pos_easting": 0, "pos_northing": 0,
                               "pos_site": "southpole", "station_id": 101}}}


def dryrun_event_list(n_events=300, seed=17):
    """The dryrun's list in memory, ``(data, attrs)``: 1e18 eV neutrinos in
    r < 3 km, -2.7 km < z < 0."""
    from nuradiomc_tpu_torch.sim import evtgen
    from nuradiomc_tpu_torch.utils import units

    return evtgen.generate_eventlist_cylinder(
        None, n_events, 1e18, 1e18,
        {"fiducial_rmin": 0, "fiducial_rmax": 3 * units.km,
         "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0}, seed=seed)


def dryrun_simulation(mesh=None, device="cuda", dtype=torch.float64, noise=False,
                      chunk_size=DRYRUN_CHUNK, event_input=None, **kwargs):
    """The dryrun's ``Simulation``: ``event_input`` (default: the 300-event
    list of :func:`dryrun_event_list`) on the 4-VPol station with a 2 sigma
    high/low and a 3 sigma threshold trigger (the JAX dryrun's
    configuration), optionally with noise; ``kwargs`` (output files) go to
    ``Simulation``."""
    from nuradiomc_tpu_torch.sim import io_input
    from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
    from nuradiomc_tpu_torch.utils import units

    if event_input is None:
        event_input = io_input.from_generated(*dryrun_event_list())
    return Simulation(
        event_input, dryrun_detector(),
        config={"sampling_rate": 2.0, "noise": bool(noise),
                "propagation": {"ice_model": "southpole_2015"},
                "signal": {"model": "Alvarez2000"},
                "weights": {"weight_mode": "core_mantle_crust_simple",
                            "cross_section_type": "ctw"}},
        filter_chain=[FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
                      FilterStage((0, 500 * units.MHz), "butter", {"order": 10})],
        triggers=[TriggerSpec(name="hilo_2sig", threshold_high_sigma=2.0,
                              threshold_low_sigma=-2.0),
                  TriggerSpec(name="simple_3sig", trigger_type="simple_threshold",
                              threshold_high_sigma=3.0)],
        chunk_size=chunk_size, device=device, dtype=dtype, mesh=mesh, **kwargs)


RESULT_KEYS = ("group_ids", "triggered", "multiple_triggers", "trigger_times",
               "trigger_times_per_trigger", "weights", "max_amplitude", "veff",
               "veff_per_trigger", "n_triggered")


def _summary(res):
    return {k: res[k] for k in RESULT_KEYS}


def compare(mesh_res: dict, single: dict, what: str = "sharded") -> None:
    """Raise unless ``mesh_res`` equals ``single``: ``triggered``,
    ``multiple_triggers``, trigger times and weights equal, Veff (each
    trigger's too) within rtol 1e-12."""
    for k in ("group_ids", "triggered", "multiple_triggers", "trigger_times",
              "trigger_times_per_trigger", "weights"):
        if not np.array_equal(mesh_res[k], single[k], equal_nan=True):
            raise AssertionError(f"{what} {k} differs from the single-process run")
    pairs = [("veff", mesh_res["veff"], single["veff"])] + [
        (f"veff_per_trigger[{t}]", v, single["veff_per_trigger"][t])
        for t, v in mesh_res["veff_per_trigger"].items()]
    for name, v, ref in pairs:
        if not abs(v - ref) <= 1e-12 * abs(ref):
            raise AssertionError(f"{what} {name} {v!r} differs from the single-process {ref!r}")


def _dryrun_worker(rank, n_procs, n_channel, device, noise):
    mesh = mesh_util.make_mesh(n_event=n_procs // n_channel, n_channel=n_channel, device=device)
    res = _summary(dryrun_simulation(mesh=mesh, device=device, noise=noise).run())
    if rank == 0:
        compare(res, _summary(dryrun_simulation(device=device, noise=noise).run()))
    return {"shape": mesh.shape, "n_triggered": res["n_triggered"], "veff": res["veff"],
            "per_trigger": res["multiple_triggers"].sum(axis=0).tolist()}


def dryrun_multichip(n_procs: int, backend: str = "nccl", device: str = "cuda",
                     noise: bool = False) -> dict:
    """The sharded dryrun on ``n_procs`` processes; raises if the sharded
    run differs from the single-process one. Returns rank 0's summary."""
    n_channel = 2 if n_procs % 2 == 0 and n_procs >= 2 else 1
    out = spawn(_dryrun_worker, n_procs, (n_channel, device, noise), backend=backend)[0]
    print(f"dryrun_multichip: mesh={out['shape']} n_triggered={out['n_triggered']} "
          f"per-trigger={out['per_trigger']} veff={out['veff']:.6g} noise={noise} "
          "== single-process OK")
    return out


def dryrun_runner(mesh, device, ckpt_dir, n_per_batch, budget, stop_after, noise=True,
                  fail_rank=None):
    """``Runner`` runs of the dryrun station on ``mesh`` (None: this process
    alone), streaming ``evtgen`` batches of ``n_per_batch`` events (batch i
    from seed 100 + i) through its ``Simulation`` to a budget of ``budget``
    triggered groups: uninterrupted (``whole``); stopped after
    ``stop_after`` batches (``first``) and resumed from its checkpoint in
    ``ckpt_dir`` (``resumed``); and with the wall-time budget spent at once
    on every rank but 0 (``clock``: rank 0 decides). With ``fail_rank``,
    that rank's batches raise and no crash is tolerated. Returns each run's
    (state, wall seconds)."""
    import time

    from nuradiomc_tpu_torch.sim import earth_attenuation, io_input, runner

    rank = 0 if mesh is None else mesh.rank

    def make_batch(limit):
        def make(i, rng):
            if limit is not None and i >= limit:
                return None, None
            inp = io_input.from_generated(*dryrun_event_list(n_per_batch, seed=100 + i))
            # the groups' weights, in the results' (sorted group id) order
            _, first = np.unique(inp.event_group_ids, return_index=True)
            weights = earth_attenuation.get_weight(
                inp.zeniths[first], inp.energies[first], inp.flavors[first],
                mode="core_mantle_crust_simple", cross_section_type="ctw")
            return inp, weights
        return make

    def run_batch(inp):
        if rank == fail_rank:
            raise RuntimeError(f"rank {rank} fails on purpose")
        res = dryrun_simulation(mesh=mesh, device=device, noise=noise, event_input=inp).run()
        return res["triggered"], res

    def run(limit, name, max_runtime=3600.0):
        path = None if name is None else os.path.join(ckpt_dir, f"{name}.json")
        t0 = time.perf_counter()
        state = runner.Runner(make_batch(limit), run_batch, n_triggers_max=budget,
                              max_runtime=max_runtime, checkpoint_path=path,
                              max_crashes=0, mesh=mesh).run()
        return state, time.perf_counter() - t0

    whole = run(None, "whole")
    first = run(stop_after, "resumed")
    resumed = run(None, "resumed")
    clock = run(None, None, max_runtime=3600.0 if rank == 0 else 0.0)
    return {"whole": whole, "first": first, "resumed": resumed, "clock": clock}


def runner_worker(rank, n_procs, n_channel, device, ckpt_dir, n_per_batch, budget,
                  stop_after, noise=True, fail_rank=None):
    """:func:`dryrun_runner` on an ``(n_procs / n_channel, n_channel)``
    mesh (a :func:`spawn` function)."""
    mesh = mesh_util.make_mesh(n_procs // n_channel, n_channel, device=device)
    return dryrun_runner(mesh, device, ckpt_dir, n_per_batch, budget, stop_after, noise,
                         fail_rank)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_procs", type=int)
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--noise", action="store_true")
    a = ap.parse_args()
    dryrun_multichip(a.n_procs, a.backend, a.device, a.noise)
