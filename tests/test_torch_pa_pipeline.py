"""The port's ``simulate_batch`` on the phased-array path held to the JAX
package's on the CPU, float64.

Inputs: 40 groups of tests/golden/pa_noiseless_input.hdf5 (the 16 groups
NuRadioMC triggers there and the first 24 others) built by the JAX
package's ``Simulation`` with the phased-array workload's detector, config
and filters (Alvarez2009 with the input's k_L, implicit focusing, trigger
ADC, x2 upsampling, 11 beams), noise off, converted with
``convert.from_jax``. The JAX reference runs its XLA path (float64 never
reaches the Pallas kernel).

* triggered sets identical, per-solution masks identical;
* trigger times rtol 1e-8: both are t0 + frame * 8 ns, and t0, the earliest
  arrival, carries the travel time of a refracted ray where that is the
  earliest (turning-point tolerance, measured 3.5e-9 relative);
* max amplitudes and the focusing factor: direct and reflected rays rtol
  1e-6; refracted rays, whose focusing derivative is a difference quotient
  at the turning point (tests/test_torch_pa_ops.py states why), focusing
  within 5e-3, and the amplitudes they feed within 5e-3.

The same for the undigitized trigger (``pa_digitize=False``: trigger traces
at the internal rate, x2 upsampled), and the settings conversion of the
phased-array fields.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from nuradiomc_tpu.sim import pipeline as jpipe
from nuradiomc_tpu.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim import pipeline as tpipe

torch.set_num_threads(1)
HERE = os.path.dirname(__file__)
INPUT = os.path.join(HERE, "golden", "pa_noiseless_input.hdf5")
GOLDEN = os.path.join(HERE, "golden", "e2e_pa_noiseless_reference.npz")


@pytest.fixture(scope="module")
def jax_inputs():
    port = convert.pa_simulation(INPUT, {"noise": False}, device="cpu")
    sim = Simulation(
        INPUT, convert.PA_DETECTOR, config=port.config,
        filter_chain=[FilterStage(f.passband, f.filter_type, f.kwargs)
                      for f in port.filter_chain],
        trigger=TriggerSpec(trigger_type="phased_array"),
        antenna_replacements=port.antenna_replacements)
    group_ids, _, _, _, batch = sim._build_batches()
    ref_ids = np.unique(np.load(GOLDEN)["group_ids"])
    trig = np.flatnonzero(np.isin(group_ids, ref_ids))
    others = np.setdiff1d(np.arange(len(group_ids)), trig)[:24]
    sel = np.sort(np.concatenate([trig, others]))
    batch = jax.tree.map(lambda a: np.asarray(a)[sel], batch)
    return sim.settings, sim.channel_params, batch


def _run_both(settings, ch, batch):
    ref = jax.jit(lambda b: jpipe.simulate_batch(b, ch, settings))(batch)
    ps, pc, pb = convert.from_jax(settings, ch, batch, device="cpu", dtype=torch.float64)
    return ref, tpipe.simulate_batch(pb, pc, ps)


@pytest.fixture(scope="module", params=["digitized", "undigitized"])
def case(request, jax_inputs):
    settings, ch, batch = jax_inputs
    if request.param == "undigitized":
        settings = dataclasses.replace(settings, triggers=tuple(
            dataclasses.replace(t, pa_digitize=False) for t in settings.triggers))
    return _run_both(settings, ch, batch)


def test_pa_simulate_batch_matches_jax(case):
    ref, port = case
    valid = np.asarray(ref.sol_mask)
    np.testing.assert_array_equal(port.sol_mask.numpy(), valid)
    trig = np.asarray(ref.triggered)
    np.testing.assert_array_equal(port.triggered.numpy(), trig)
    assert 0 < trig.sum() < len(trig)
    np.testing.assert_allclose(port.trigger_time.numpy()[trig],
                               np.asarray(ref.trigger_time)[trig], rtol=1e-8)
    st = np.asarray(ref.sol_type)
    refracted = valid & (st == 2)
    plain = valid & ~refracted
    foc_r, foc_p = np.asarray(ref.focusing), port.focusing.numpy()
    assert np.any(foc_r[valid] != 1.0)
    np.testing.assert_allclose(foc_p[plain], foc_r[plain], rtol=1e-6)
    np.testing.assert_allclose(foc_p[refracted], foc_r[refracted], rtol=5e-3)
    amp_r, amp_p = np.asarray(ref.max_amp_per_solution), port.max_amp_per_solution.numpy()
    np.testing.assert_allclose(amp_p[plain], amp_r[plain], rtol=1e-6)
    np.testing.assert_allclose(amp_p[refracted], amp_r[refracted], rtol=5e-3)
    np.testing.assert_allclose(port.max_amplitude.numpy(), np.asarray(ref.max_amplitude),
                               rtol=5e-3)


def test_settings_from_jax_carries_pa_fields(jax_inputs):
    settings, _, _ = jax_inputs
    ps = convert.settings_from_jax(settings)
    assert ps.apply_focusing and ps.askaryan_model == "Alvarez2009"
    for name in ("pa_rolls", "pa_window", "pa_step", "pa_upsampling", "pa_threshold",
                 "pa_digitize", "pa_adc_fs", "pa_adc_nbits", "pa_adc_range"):
        assert getattr(ps.triggers[0], name) == getattr(settings.triggers[0], name), name
    assert ps.triggers[0].pa_digitize and len(ps.triggers[0].pa_rolls) == 11


def test_noise_needs_a_generator_and_mixed_lists_need_plain(jax_inputs):
    settings, ch, batch = jax_inputs
    ps, pc, pb = convert.from_jax(settings, ch, batch, device="cpu", dtype=torch.float64)
    noisy = dataclasses.replace(ps, add_noise=True)
    with pytest.raises(ValueError, match="noise_generator"):
        tpipe.simulate_batch(pb, pc, noisy)
    outs = [tpipe.simulate_batch(pb, pc, noisy,
                                 noise_generator=torch.Generator().manual_seed(seed))
            for seed in (1, 1, 2)]
    assert torch.equal(outs[0].max_amplitude, outs[1].max_amplitude)
    assert not torch.equal(outs[0].max_amplitude, outs[2].max_amplitude)
    hl = tpipe.TriggerSettings(name="hl", threshold_high=2e-5, threshold_low=-2e-5)
    mixed = dataclasses.replace(ps, triggers=ps.triggers + (hl,))
    # a list that mixes phased-array and high/low triggers runs on both routes
    both = tpipe.simulate_batch(pb, pc, mixed)
    plain = tpipe.simulate_batch(pb, pc, dataclasses.replace(mixed, trigger_impl="plain"))
    assert torch.equal(both.triggered_per, plain.triggered_per)
    pa_only = tpipe.simulate_batch(pb, pc, ps)
    hl_only = tpipe.simulate_batch(pb, pc, dataclasses.replace(ps, triggers=(hl,)))
    assert torch.equal(both.triggered_per[:, 0], pa_only.triggered)
    assert torch.equal(both.triggered_per[:, 1], hl_only.triggered)
