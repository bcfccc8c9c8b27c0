"""Module-level functions that tests/test_torch_mesh.py and
tests/test_torch_runner.py run in spawned processes (``parallel.dryrun.spawn``
pickles them by reference; this module imports neither jax nor the JAX
package, so a child process starts quickly)."""

import warnings

import torch
import torch.distributed as dist

from nuradiomc_tpu_torch.parallel import dryrun
from nuradiomc_tpu_torch.parallel import mesh as mesh_util


def mesh_runs(rank, n_procs, shapes, out_dir=None, device="cpu"):
    """The dryrun list through ``Simulation(mesh=)`` on each (n_event,
    n_channel) of ``shapes``, noise off and on: each run's results. With
    ``out_dir``, the noisy runs on (2, 2) are given output files named by
    rank (only rank 0 may write them)."""
    out = {}
    for shape in shapes:
        mesh = mesh_util.make_mesh(*shape, device=device)
        for noise in (False, True):
            files = {}
            if out_dir and noise and tuple(shape) == (2, 2):
                files = {"outputfilename": f"{out_dir}/mesh_{rank}.hdf5",
                         "nur_outputfilename": f"{out_dir}/mesh_{rank}.nur"}
            sim = dryrun.dryrun_simulation(mesh=mesh, device=device, noise=noise, **files)
            out[(tuple(shape), noise)] = {k: v for k, v in sim.run().items()
                                          if k in dryrun.RESULT_KEYS}
    return out


def collectives(rank, n_procs):
    """The helpers of ``parallel.mesh`` on a (1, n) mesh."""
    mesh = mesh_util.make_mesh(1, n_procs, device="cpu")
    ax = mesh.channel
    t = torch.tensor([float(rank), 10.0 - rank], dtype=torch.float64)
    z = torch.full((2, 1), complex(rank, -rank), dtype=torch.complex128)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        odd = mesh_util.make_mesh(3, 1, device="cpu")
        again = mesh_util.init_distributed("gloo")
    auto = dryrun.dryrun_simulation(mesh="auto", device="cpu").mesh
    try:
        dryrun.dryrun_simulation(mesh=mesh, device="cuda")
        mismatch = None
    except ValueError as e:
        mismatch = str(e)
    return {
        "auto_shape": auto.shape, "auto_device": str(auto.device), "mismatch": mismatch,
        "coords": (mesh.event.index, mesh.channel.index), "shape": mesh.shape,
        "min": mesh_util.all_reduce_min(t, ax).tolist(),
        "max": mesh_util.all_reduce_max(t, ax).tolist(),
        "or": mesh_util.all_reduce_or(torch.tensor([rank == 0, False, True]), ax).tolist(),
        "gather": mesh_util.all_gather(z, 1, ax).numpy(),
        "gather_bool": mesh_util.all_gather(torch.tensor([[rank == 1]]), 0, ax).tolist(),
        "objects": mesh_util.gather_objects({"rank": rank}, ax),
        "broadcast": mesh_util.broadcast_object(f"from {rank}", mesh.world),
        "fallback_shape": odd.shape,
        "again": again,
        "warnings": [str(w.message) for w in caught],
    }


def fails(rank, n_procs):
    """Rank 1 raises; the others wait for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()
    return rank


def _split_case(name):
    """(settings, channels, batch, simulate_batch keywords) of one branch of
    the chain, float64 on the CPU, at a few groups."""
    from nuradiomc_tpu_torch import convert
    from nuradiomc_tpu_torch.sim import io_input

    f64 = dict(device="cpu", dtype=torch.float64)
    if name == "mooresbay":          # 6 ray slots, 3 readout windows, MB1
        s, ch, b = convert.make_mooresbay_inputs(96, **f64)
        return s, ch, b, {}
    if name == "gen2":               # birefringence, the non-factored chain, kernel 4
        s, chps, b = convert.make_gen2_inputs(32, **f64)
        return s, chps[0], b, {"keep_efields": True}
    if name == "multitrigger":       # noise, focusing, ten triggers with a phased array
        s, ch, b = convert.make_multitrigger_inputs(48, **f64)
        return s, ch, b, {"keep_traces": True}
    if name == "emitter":            # a pulser through an emitting antenna, 8 channels
        sim = convert.emitter_simulation(str(io_input.INPUT_EMITTER_VOLTAGE), **f64)
        return (sim.settings, sim.channel_params,
                sim._on_device(sim._build_batches()[-1], slice(0, 24)), {"emitter": sim._emitter})
    raise ValueError(name)


def pipeline_split(rank, n_procs, cases):
    """``simulate_batch`` with its channels split over an axis of ``n_procs``
    ranks against the unsharded call in this process, the same noise
    generator seed for both: per case, the output fields that differ with
    their largest difference over their largest magnitude (none: equal bit
    for bit, NaN where NaN), the fired count and the channel count."""
    from nuradiomc_tpu_torch.sim.pipeline import simulate_batch

    mesh = mesh_util.make_mesh(1, n_procs, device="cpu")
    out = {}
    for name in cases:
        s, ch, batch, kw = _split_case(name)

        def run(axis):
            gen = torch.Generator().manual_seed(7) if s.add_noise else None
            return simulate_batch(batch, ch, s, noise_generator=gen, channel_axis=axis, **kw)

        split, whole = run(mesh.channel), run(None)
        differ = {}
        for field in whole._fields:
            a, b = getattr(split, field), getattr(whole, field)
            if (a is None) != (b is None) or (a is not None and a.shape != b.shape):
                differ[field] = float("inf")
            elif a is not None and not torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)):
                den = float(b.abs().nan_to_num().max()) or 1.0
                differ[field] = float((a - b).abs().nan_to_num().max()) / den
        out[name] = (differ, int(whole.triggered.sum()), ch.positions.shape[0])
    return out
