"""Multi-process runs of the port on the CPU: ``torch.distributed`` with the
gloo backend, ``file://`` rendezvous (``parallel.dryrun.spawn``), one thread
per process.

* The dryrun list (300 events, the 4-VPol station with two named triggers,
  chunks of 64 groups, which do not divide 300) through ``Simulation(mesh=)``
  on (2, 1), (1, 2) and (2, 2) meshes equals the single-process run bit for
  bit, with noise off and on: ``triggered``, ``multiple_triggers``, trigger
  times, weights and amplitudes equal, Veff within rtol 1e-12; every rank
  holds the same results.
* Rank 0 alone writes the output HDF5 and the ``.nur`` file (its re-run of
  the triggered groups on the mesh), equal to the single-process files.
* The float64 noiseless sets equal the JAX package's single-device
  ``Simulation`` on the same list.
* The collective helpers of ``parallel.mesh``, the mesh's shape fallback,
  ``Simulation(mesh="auto")``, a device that is not the mesh's, a second
  ``init_distributed`` and NCCL's refusal of two ranks on one card.
* A rank that raises makes the caller raise at once, while the others wait
  in a collective, well inside the process group's timeout.
"""

import datetime
import os
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import jax.numpy as jnp  # noqa: E402

import torch_mesh_workers as workers  # noqa: E402
from nuradiomc_tpu.sim import evtgen as jevtgen  # noqa: E402
from nuradiomc_tpu.sim.simulation import FilterStage, Simulation, TriggerSpec  # noqa: E402
from nuradiomc_tpu.utils import units  # noqa: E402
from nuradiomc_tpu_torch.parallel import dryrun  # noqa: E402
from nuradiomc_tpu_torch.parallel import mesh as mesh_util  # noqa: E402
from nuradiomc_tpu_torch.sim.pipeline import ChannelParams, ShowerBatch  # noqa: E402

torch.set_num_threads(1)
SHAPES_2 = ((2, 1), (1, 2))
SHAPES_4 = ((2, 2),)
EXACT = ("group_ids", "triggered", "multiple_triggers", "trigger_times",
         "trigger_times_per_trigger", "weights", "max_amplitude")


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_outputs"))


@pytest.fixture(scope="module")
def single(out_dir):
    """The single-process runs, noise off and on (with output files)."""
    files = {"outputfilename": f"{out_dir}/single.hdf5",
             "nur_outputfilename": f"{out_dir}/single.nur"}
    return {noise: dryrun.dryrun_simulation(device="cpu", noise=noise,
                                            **(files if noise else {})).run()
            for noise in (False, True)}


@pytest.fixture(scope="module")
def sharded(out_dir):
    """Every rank's results: two processes on (2, 1) and (1, 2), four on
    (2, 2), whose noisy run writes the output files."""
    out = {}
    for n, shapes in ((2, SHAPES_2), (4, SHAPES_4)):
        ranks = dryrun.spawn(workers.mesh_runs, n, (shapes, out_dir), backend="gloo")
        for key in ranks[0]:
            out[key] = [r[key] for r in ranks]
    return out


@pytest.mark.parametrize("noise", [False, True], ids=["noiseless", "noise"])
@pytest.mark.parametrize("shape", SHAPES_2 + SHAPES_4, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_equals_single_process(single, sharded, shape, noise):
    ref = single[noise]
    for rank, res in enumerate(sharded[(shape, noise)]):
        for k in EXACT:
            np.testing.assert_array_equal(res[k], ref[k], err_msg=f"rank {rank} {k}")
        dryrun.compare(res, ref)
    assert ref["n_triggered"] >= (10 if noise else 2)
    assert len(ref["group_ids"]) % dryrun.DRYRUN_CHUNK


def test_rank_0_writes_the_output_files(single, sharded, out_dir):
    """Rank 0 alone writes the output HDF5 and the ``.nur`` file (whose
    re-run of the triggered groups runs on the mesh); both equal the
    single-process run's files."""
    import h5py

    from nuradiomc_tpu_torch.sim import io_nur
    written = sorted(f for f in os.listdir(out_dir) if f.startswith("mesh_"))
    assert written == ["mesh_0.hdf5", "mesh_0.nur"]
    with h5py.File(f"{out_dir}/mesh_0.hdf5") as a, h5py.File(f"{out_dir}/single.hdf5") as b:
        assert sorted(a) == sorted(b) and a.attrs["Veff"] == b.attrs["Veff"]
        for k in ("triggered", "weights", "multiple_triggers", "trigger_times"):
            np.testing.assert_array_equal(a[k][()], b[k][()], err_msg=k)
    mine = list(io_nur.EventReader(f"{out_dir}/mesh_0.nur").run())
    ref = list(io_nur.EventReader(f"{out_dir}/single.nur").run())
    assert [e.get_id() for e in mine] == [e.get_id() for e in ref]
    assert len(mine) == single[True]["n_triggered"] >= 10
    for a, b in zip(mine, ref):
        for ca, cb in zip(a.get_station(101).iter_channels(), b.get_station(101).iter_channels()):
            np.testing.assert_array_equal(ca.get_trace(), cb.get_trace())


def test_noiseless_sets_equal_jax(single, tmp_path):
    infile = str(tmp_path / "in.hdf5")
    jevtgen.generate_eventlist_cylinder(
        infile, 300, 1e18, 1e18,
        {"fiducial_rmin": 0, "fiducial_rmax": 3 * units.km,
         "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0}, seed=17)
    ref = Simulation(
        infile, dryrun.dryrun_detector(),
        config={"sampling_rate": 2.0, "propagation": {"ice_model": "southpole_2015"},
                "signal": {"model": "Alvarez2000"},
                "weights": {"weight_mode": "core_mantle_crust_simple",
                            "cross_section_type": "ctw"}},
        filter_chain=[FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
                      FilterStage((0, 500 * units.MHz), "butter", {"order": 10})],
        triggers=[TriggerSpec(name="hilo_2sig", threshold_high_sigma=2.0,
                              threshold_low_sigma=-2.0),
                  TriggerSpec(name="simple_3sig", trigger_type="simple_threshold",
                              threshold_high_sigma=3.0)],
        chunk_size=dryrun.DRYRUN_CHUNK, dtype=jnp.float64).run()
    res = single[False]
    for k in ("group_ids", "triggered", "multiple_triggers", "weights"):
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)
    np.testing.assert_allclose(res["veff"], ref["veff"], rtol=1e-12)
    assert res["multiple_triggers"].sum() >= 3


def test_collective_helpers():
    ranks = dryrun.spawn(workers.collectives, 2, backend="gloo")
    for rank, r in enumerate(ranks):
        assert r["coords"] == (0, rank) and r["shape"] == {"event": 1, "channel": 2}
        assert r["min"] == [0.0, 9.0] and r["max"] == [1.0, 10.0]
        assert r["or"] == [True, False, True]
        np.testing.assert_array_equal(r["gather"], [[0j, 1 - 1j], [0j, 1 - 1j]])
        assert r["gather_bool"] == [[False], [True]]
        assert r["objects"] == [{"rank": 0}, {"rank": 1}]
        assert r["broadcast"] == "from 0"
        assert r["fallback_shape"] == {"event": 1, "channel": 2}
        assert r["again"] == (rank, 2)
        assert any("does not match the 2 ranks" in w for w in r["warnings"])
        assert any("already initialized" in w for w in r["warnings"])
        # Simulation(mesh="auto"): every rank on one event axis, on the asked device
        assert r["auto_shape"] == {"event": 2, "channel": 1} and r["auto_device"] == "cpu"
        assert "the mesh runs on cpu" in r["mismatch"]


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank per card"):
        mesh_util.init_distributed("nccl", init_method="tcp://localhost:1", rank=0)


def test_a_failing_rank_raises_in_the_caller():
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        dryrun.spawn(workers.fails, 2, backend="gloo",
                     timeout=datetime.timedelta(seconds=60))
    assert time.perf_counter() - t0 < 45


def _channel_params(C, F=5):
    g = torch.Generator().manual_seed(3)

    def r(*shape):
        return torch.rand(*shape, generator=g, dtype=torch.float64)

    return ChannelParams(positions=r(C, 3), cable_delays=r(C), rot=r(C, 3, 3),
                         kind=torch.arange(C), templates=r(C, 3, F).to(torch.complex128),
                         filter_response=r(C, F).to(torch.complex128),
                         filter_response_int=r(C, F).to(torch.complex128),
                         threshold_high=r(C), threshold_low=r(C), noise_amplitude=r(C),
                         min_efield_amplitude=r(C))


def test_placement_helpers():
    axis = mesh_util.Axis("channel", 2, 1, None, "gloo")
    mesh = mesh_util.Mesh(n_event=3, n_channel=2, rank=3, device=torch.device("cpu"),
                          event=mesh_util.Axis("event", 3, 1, None, "gloo"), channel=axis,
                          world=mesh_util.Axis("world", 6, 3, None, "gloo"))
    assert mesh.shape == {"event": 3, "channel": 2}
    assert [mesh_util.pad_groups(n, mesh) for n in (1, 3, 4, 6)] == [3, 3, 6, 6]
    ch = _channel_params(4)
    part = mesh_util.shard_channels(ch, mesh)
    for a, b in zip(part, ch):
        if a is not None:
            torch.testing.assert_close(a, b[2:4], rtol=0, atol=0)
    assert mesh_util.shard_channels(_channel_params(3), mesh).positions.shape[0] == 3
    assert mesh_util.channel_split(4, None) is None
    batch = ShowerBatch(*[torch.arange(12.0).reshape(6, 2)] * 7)
    assert mesh_util.shard_batch(batch, mesh).energies.tolist() == [[4.0, 5.0], [6.0, 7.0]]
    with pytest.raises(ValueError, match="pad the batch"):
        mesh_util.shard_batch(ShowerBatch(*[torch.zeros(4, 2)] * 7), mesh)
    # a single-rank axis or none: the helpers pass tensors through
    t = torch.tensor([1.0, 2.0])
    for fn in (mesh_util.all_reduce_min, mesh_util.all_reduce_max):
        assert fn(t, None) is t
    assert mesh_util.all_gather(t, 0, None) is t
    assert mesh_util.gather_objects(5, None) == [5]
    assert mesh_util.broadcast_object(5, None) == 5
