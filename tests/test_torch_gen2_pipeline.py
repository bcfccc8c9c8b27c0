"""The non-factored chain (birefringence, keep_efields) and the Gen2
composed workload: the port held to the JAX package and to the
``gen2_trig`` pin on the CPU.

* inputs: the port's ``convert.gen2_simulation`` on the ``.npz`` export of
  the tau input builds the same batch and settings as the JAX package's
  ``Simulation`` on the HDF5 file with the same detector and config (the
  JAX package's ``bench._gen2_setup`` workload).
* float64, 8 groups of that batch (five that trigger in the pin, three that
  do not), 3 stations, S 10, ``birefringence_points`` 32, ``keep_efields``:
  triggered vectors, candidates and solution masks exact;
  ``max_amp_per_solution`` rtol 1e-6 and the efields within 1e-6 of their
  largest value. 96 solver steps so both solvers converge; what remains is
  the ~2e-9 relative spread of refracted/reflected C0 roots between two
  correct implementations (tests/test_torch_raytrace.py), which moves
  amplitudes by up to ~1e-7 here.
* the same without birefringence, ``keep_efields`` only: the non-factored
  chain equals the JAX package's and decides as the factored one does.
* float32, the port alone: the first 64 groups of ``make_gen2_inputs``
  against ``gen2_trig[:64]``, at most 8 flips (bench.py:135).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.sim import pipeline as jpipe
from nuradiomc_tpu.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu.utils import units
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim import pipeline as tpipe
from nuradiomc_tpu_torch.sim.io_input import INPUT_GEN2

torch.set_num_threads(1)
HDF5 = "gen2_taus_2048_seed21.hdf5"
GROUPS = [13, 18, 22, 37, 57, 0, 1, 2]
PIN = "tests/golden/bench_pins.npz"


@pytest.fixture(scope="module")
def sims():
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jsim = Simulation(
        os.path.join(root, ".bench_cache", HDF5), convert.GEN2_DETECTOR,
        config=convert.GEN2_CONFIG,
        filter_chain=[FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
                      FilterStage((0, 500 * units.MHz), "butter", {"order": 10})],
        trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
        dtype=jnp.float64)
    return jsim, convert.gen2_simulation(INPUT_GEN2, device="cpu", dtype=torch.float64)


def test_gen2_inputs_match_jax(sims):
    jsim, tsim = sims
    jb, tb = jsim._build_batches()[-1], tsim._build_batches()[-1]
    assert np.asarray(jb.energies).shape == (2048, 10)
    for name in jb._fields:
        if name == "k_L" or getattr(jb, name) is None:   # k_L: Alvarez2009 only
            continue
        np.testing.assert_array_equal(getattr(tb, name), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    ref = convert.settings_from_jax(jsim.settings)
    for f in dataclasses.fields(ref):
        if f.name != "triggers":
            assert getattr(tsim.settings, f.name) == getattr(ref, f.name), f.name
    assert tsim.settings.birefringence and tsim.settings.birefringence_model == "southpole_A"
    hl = ("name", "trigger_type", "threshold_high", "threshold_low", "highlow_coincidence",
          "number_of_coincidences", "channel_coincidence")
    for a, b in zip(tsim.settings.triggers, ref.triggers):
        assert [getattr(a, k) for k in hl] == [getattr(b, k) for k in hl]
    assert list(tsim.channel_params_per_station) == list(jsim.channel_params_per_station)


def _run_both(sims, **change):
    jsim, _ = sims
    s = dataclasses.replace(jsim.settings, birefringence_points=32, n_bisect=96, **change)
    jb = jax.tree.map(lambda a: None if a is None else np.asarray(a)[GROUPS],
                      jsim._build_batches()[-1])
    step = jax.jit(lambda bb, cc: jpipe.simulate_batch(bb, cc, s, keep_efields=True))
    ps = convert.settings_from_jax(s)
    for sid, jch in jsim.channel_params_per_station.items():
        _, pc, pb = convert.from_jax(s, jch, jb, device="cpu", dtype=torch.float64)
        yield sid, step(jb, jch), tpipe.simulate_batch(pb, pc, ps, keep_efields=True), (pb, pc, ps)


def _compare(ref, port):
    valid = np.asarray(ref.sol_mask)
    np.testing.assert_array_equal(port.sol_mask.numpy(), valid)
    np.testing.assert_array_equal(port.triggered.numpy(), np.asarray(ref.triggered))
    np.testing.assert_array_equal(port.candidate.numpy(), np.asarray(ref.candidate))
    np.testing.assert_allclose(port.max_amp_per_solution.numpy()[valid],
                               np.asarray(ref.max_amp_per_solution)[valid], rtol=1e-6, atol=0)
    ref_e = np.asarray(ref.efields)
    assert port.efields.shape == ref_e.shape
    sel = np.broadcast_to(valid[None, ..., None], ref_e.shape)
    np.testing.assert_allclose(port.efields.numpy()[sel], ref_e[sel],
                               atol=1e-6 * np.abs(ref_e[sel]).max(), rtol=0)


def test_birefringence_float64_matches_jax(sims):
    pin = np.load(PIN)["gen2_trig"].astype(int)[GROUPS]
    count = np.zeros(len(GROUPS), dtype=int)
    for _, ref, port, _ in _run_both(sims):
        assert port.c0.dtype == torch.float64
        _compare(ref, port)
        count += port.triggered.numpy()
    assert count.sum() >= 5
    np.testing.assert_array_equal(count, pin)       # the float32 pin holds in float64 too


def test_keep_efields_float64_matches_jax_and_factored_chain(sims):
    for _, ref, port, (pb, pc, ps) in _run_both(sims, birefringence=False):
        _compare(ref, port)
        factored = tpipe.simulate_batch(pb, pc, dataclasses.replace(ps, birefringence=False))
        assert factored.efields is None
        np.testing.assert_array_equal(factored.triggered.numpy(), port.triggered.numpy())
        np.testing.assert_allclose(factored.max_amplitude.numpy(), port.max_amplitude.numpy(),
                                   rtol=1e-9)


def test_gen2_float32_prefix_matches_pin():
    settings, chps, batch = convert.make_gen2_inputs(64, device="cpu", dtype=torch.float32)
    assert batch.energies.shape == (64, 10) and batch.vertices.dtype == torch.float32
    vec = sum(tpipe.simulate_batch(batch, ch, settings).triggered.long() for ch in chps)
    ref = np.load(PIN)["gen2_trig"].astype(np.int64)[:64]
    flips = int((vec.numpy() != ref).sum())
    assert ref.sum() > 0 and flips <= 8, flips


def test_simulation_reads_birefringence_config():
    sim = convert.gen2_simulation(INPUT_GEN2, {"propagation": {"angle_to_iceflow": 30.0,
                                                               "birefringence_model": "southpole_B"}},
                                  device="cpu")
    assert sim.settings.birefringence_model == "southpole_B"
    assert sim.settings.birefringence_iceflow == pytest.approx(np.deg2rad(30.0))
    assert convert.gen2_simulation(INPUT_GEN2, device="cpu").settings.birefringence_iceflow == \
        pytest.approx(np.deg2rad(-131.0))
    with pytest.raises(NotImplementedError, match="analytical"):
        convert.gen2_simulation(INPUT_GEN2, {"propagation": {
            "birefringence_propagation": "numerical"}}, device="cpu")
