"""The multi-trigger station path of the port held to the JAX package's on the
CPU, float64.

``simulate_batch`` on 35 groups of tests/golden/pa_noiseless_input.hdf5 (the
groups NuRadioMC triggers there and the first 24 others), built by the JAX
package's ``Simulation`` with the phased-array workload's 4-channel detector,
config and filters, converted with ``convert.from_jax``; focusing is off
unless a case says otherwise, so that no turning-point difference quotient
enters the amplitudes:

* a mixed list (2-sigma high/low on all channels, 3-sigma threshold on
  channels (0, 1), the digitized phased array, and a 2-sigma high/low that
  ``requires`` the phased array): ``triggered_per`` equal, ``max_amplitude``
  rtol 1e-9 in groups without a refracted ray and 2e-4 with one,
  ``trigger_times_per`` rtol 1e-8 (both are t0 + bin * dt, and t0, the
  earliest arrival, carries a refracted ray's travel time where that is the
  earliest: turning-point tolerance, measured 4e-8 relative at most);
* the same with a separate trigger chain and ``band_limit_eps=1e-2``: also
  the placement width ``K_place`` equal to the JAX package's;
* ``n_windows=2`` on a batch whose second shower arrives later than
  ``(n_base - n_internal) * dt``: decisions and times equal, and differing
  from ``n_windows=1``;
* ``focusing_mode="numeric"``: the focusing factor rtol 1e-7 on direct and
  reflected rays and 5e-3 on refracted ones, decisions equal.

The ``.npz`` export of the input equals what the JAX package's HDF5 reader
returns. And ``Simulation`` of the three-trigger station on the whole 3000-event
input: per-trigger triggered sets equal to the JAX package's own float64
sets (the pin file ``nuradiomc_tpu_torch/data/multitrigger_jax_sets.npz``,
written by ``python tests/test_torch_multitrigger.py``) and within one
borderline group per trigger name of the NuRadioMC golden.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from nuradiomc_tpu.sim import pipeline as jpipe
from nuradiomc_tpu.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu.utils import units
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.ops import placement
from nuradiomc_tpu_torch.sim import io_input
from nuradiomc_tpu_torch.sim import pipeline as tpipe

torch.set_num_threads(1)
HERE = os.path.dirname(__file__)
INPUT = os.path.join(HERE, "golden", "pa_noiseless_input.hdf5")
GOLDEN_PA = os.path.join(HERE, "golden", "e2e_pa_noiseless_reference.npz")
GOLDEN_MT = os.path.join(HERE, "golden", "e2e_multitrigger_reference.npz")
PIN = io_input.DATA_DIR / "multitrigger_jax_sets.npz"
MIN_W = 1e-5

TRIGGERS = [
    TriggerSpec(name="hilo_2sig", trigger_type="high_low",
                threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
    TriggerSpec(name="simple_3sig", trigger_type="simple_threshold",
                channels=(0, 1), threshold_high_sigma=3.0),
    TriggerSpec(name="PA_4channel", trigger_type="phased_array"),
]
GATED = TriggerSpec(name="hilo_2sig_after_pa", trigger_type="high_low",
                    threshold_high_sigma=2.0, threshold_low_sigma=-2.0,
                    requires="PA_4channel")
NARROW_CHAIN = [FilterStage((120 * units.MHz, 100 * units.GHz), "butter", {"order": 4}),
                FilterStage((0, 200 * units.MHz), "butter", {"order": 8})]


def _jax_simulation(triggers, **kwargs):
    port = convert.pa_simulation(INPUT, {"noise": False}, device="cpu")
    return Simulation(
        INPUT, convert.PA_DETECTOR, config=port.config,
        filter_chain=[FilterStage(f.passband, f.filter_type, f.kwargs)
                      for f in port.filter_chain],
        triggers=triggers, antenna_replacements=port.antenna_replacements, **kwargs)


def _inputs(sim):
    group_ids, _, _, _, batch = sim._build_batches()
    ref_ids = np.unique(np.load(GOLDEN_PA)["group_ids"])
    trig = np.flatnonzero(np.isin(group_ids, ref_ids))
    others = np.setdiff1d(np.arange(len(group_ids)), trig)[:24]
    sel = np.sort(np.concatenate([trig, others]))
    batch = jax.tree.map(lambda a: np.asarray(a)[sel], batch)
    # 96 solver steps, so that both packages' bisections converge
    settings = dataclasses.replace(sim.settings, apply_focusing=False, n_bisect=96)
    return settings, sim.channel_params, batch


@pytest.fixture(scope="module")
def jax_inputs():
    return _inputs(_jax_simulation(TRIGGERS + [GATED]))


def _run_both(settings, ch, batch):
    ref = jax.jit(lambda b: jpipe.simulate_batch(b, ch, settings))(batch)
    ps, pc, pb = convert.from_jax(settings, ch, batch, device="cpu", dtype=torch.float64)
    return ref, tpipe.simulate_batch(pb, pc, ps)


def _assert_decisions_equal(ref, port):
    per = np.asarray(ref.triggered_per)
    np.testing.assert_array_equal(port.triggered_per.numpy(), per)
    np.testing.assert_array_equal(port.triggered.numpy(), np.asarray(ref.triggered))
    times_r, times_p = np.asarray(ref.trigger_times_per), port.trigger_times_per.numpy()
    np.testing.assert_allclose(times_p[per], times_r[per], rtol=1e-8)
    np.testing.assert_allclose(port.trigger_time.numpy()[per.any(axis=1)],
                               np.asarray(ref.trigger_time)[per.any(axis=1)], rtol=1e-8)
    np.testing.assert_allclose(port.base_t0.numpy(), np.asarray(ref.base_t0), rtol=1e-8)
    # a refracted ray's arrival time carries the turning-point tolerance
    # (measured 4e-8 relative, 1e-4 ns), which moves its pulse against the
    # other ray's in the channel's sum: groups with such a ray to 2e-4
    bent = _has_refracted(ref)
    amp_r, amp_p = np.asarray(ref.max_amplitude), port.max_amplitude.numpy()
    assert bent.any() and not bent.all()
    np.testing.assert_allclose(amp_p[~bent], amp_r[~bent], rtol=1e-9)
    np.testing.assert_allclose(amp_p[bent], amp_r[bent], rtol=2e-4)
    return per


def _has_refracted(ref):
    """[G] groups with a valid refracted solution (solution type 2)."""
    refracted = np.asarray(ref.sol_mask) & (np.asarray(ref.sol_type) == 2)
    return refracted.reshape(refracted.shape[0], -1).any(axis=1)


def test_mixed_trigger_list_matches_jax(jax_inputs):
    settings, ch, batch = jax_inputs
    ref, port = _run_both(settings, ch, batch)
    per = _assert_decisions_equal(ref, port)
    assert per.shape == (len(per), 4) and len(per) > 24
    # every kind fires somewhere, the columns differ, and the gate bites:
    # the gated trigger is the AND of its own decision with the phased array's
    assert np.all(per.sum(axis=0) > 0) and len({tuple(c) for c in per.T}) >= 3
    ungated = dataclasses.replace(settings, triggers=tuple(
        dataclasses.replace(t, requires=None) for t in settings.triggers))
    ps, pc, pb = convert.from_jax(ungated, ch, batch, device="cpu", dtype=torch.float64)
    free = tpipe.simulate_batch(pb, pc, ps).triggered_per.numpy()
    np.testing.assert_array_equal(per[:, 3], free[:, 3] & free[:, 2])
    assert np.any(free[:, 3] & ~per[:, 3])
    np.testing.assert_array_equal(per[:, :3], free[:, :3])
    # the channel subset: the threshold trigger reads channels (0, 1) only
    assert ps.triggers[1].channels == (0, 1) and ps.triggers[0].channels == ()
    # plain route and wrapper route agree on the CPU
    plain = tpipe.simulate_batch(pb, pc, dataclasses.replace(ps, trigger_impl="plain"))
    np.testing.assert_array_equal(plain.triggered_per.numpy(), free)


def test_requires_must_name_an_earlier_trigger(jax_inputs):
    settings, ch, batch = jax_inputs
    ps, pc, pb = convert.from_jax(settings, ch, batch, device="cpu", dtype=torch.float64)
    # the settings refuse the list when they are built, and an empty one
    with pytest.raises(ValueError, match="declared earlier"):
        dataclasses.replace(ps, triggers=(ps.triggers[3],) + ps.triggers[:3])
    with pytest.raises(ValueError, match="at least one trigger"):
        dataclasses.replace(ps, triggers=())


def test_separate_trigger_chain_matches_jax(monkeypatch):
    settings, ch, batch = _inputs(_jax_simulation(TRIGGERS + [GATED],
                                                  trigger_filter_chain=NARROW_CHAIN))
    assert ch.trigger_filter_response is not None
    settings = dataclasses.replace(settings, band_limit_eps=1e-2)
    seen = {}
    wrapped = placement.chain_placement_reduce

    def spy(*args, **kw):
        seen.update(K_place=kw["K_place"], K_int=args[0].shape[1])
        return wrapped(*args, **kw)

    monkeypatch.setattr(placement, "chain_placement_reduce", spy)
    ref, port = _run_both(settings, ch, batch)
    per = _assert_decisions_equal(ref, port)
    assert np.all(per.sum(axis=0) > 0)
    # the JAX package's widths (pipeline.py:1127-1158): the efield grid stays
    # full, the placement covers the wider of the two chains' supports
    F_base = settings.n_base // 2 + 1
    K_base = jpipe._band_support((ch.filter_response,), 1e-2, F_base)
    K_trig = jpipe._band_support((ch.trigger_filter_response,), 1e-2, F_base)
    assert K_base < K_trig < F_base
    assert seen == {"K_place": max(K_base, K_trig), "K_int": settings.n_internal // 2 + 1}
    # the triggers read the narrower chain: not the readout chain's decisions
    same_chain, _ = _run_both(settings, ch._replace(trigger_filter_response=None), batch)
    assert not np.array_equal(np.asarray(same_chain.triggered_per), per)
    # max_amplitude stays the readout chain's (with one chain the efield
    # grid is band-limited too, which leaks O(eps^2) into the amplitudes)
    np.testing.assert_allclose(np.asarray(same_chain.max_amplitude),
                               port.max_amplitude.numpy(), rtol=1e-3)


def test_two_readout_windows_match_jax(jax_inputs):
    settings, ch, batch = jax_inputs
    cap = (settings.n_base - settings.n_internal) * settings.dt
    # a second, ten times more energetic shower per group, 500 ns past the
    # first window's reach
    late = jax.tree.map(np.copy, batch)
    late = late._replace(vertex_times=np.asarray(batch.vertex_times) + cap + 500.0,
                         energies=10.0 * np.asarray(batch.energies))
    two = jax.tree.map(lambda a, b: np.concatenate([a, b], axis=1), batch, late)
    ref2, port2 = _run_both(dataclasses.replace(settings, n_windows=2), ch, two)
    per2 = _assert_decisions_equal(ref2, port2)
    ref1, port1 = _run_both(settings, ch, two)
    per1 = _assert_decisions_equal(ref1, port1)
    assert per2.sum() > per1.sum() and not np.any(per1 & ~per2)
    assert np.all(port2.max_amplitude.numpy() >= port1.max_amplitude.numpy())
    # a group that fires only in the second window reports that window's time
    only_late = per2[:, 0] & ~per1[:, 0]
    assert only_late.any()
    t2 = port2.trigger_times_per.numpy()[:, 0]
    assert np.all(t2[only_late] > port2.base_t0.numpy()[only_late] + cap)


def test_numeric_focusing_matches_jax(jax_inputs):
    settings, ch, batch = jax_inputs
    numeric = dataclasses.replace(settings, apply_focusing=True, focusing_mode="numeric")
    ref, port = _run_both(numeric, ch, batch)
    per = np.asarray(ref.triggered_per)
    np.testing.assert_array_equal(port.triggered_per.numpy(), per)
    valid = np.asarray(ref.sol_mask)
    foc_r, foc_p = np.asarray(ref.focusing), port.focusing.numpy()
    assert np.any(np.abs(foc_r[valid] - 1.0) > 1e-3)
    # direct and reflected rays to 1e-7; a refracted ray's finite difference
    # is taken at its turning point (tests/test_torch_pa_ops.py states why)
    refracted = valid & (np.asarray(ref.sol_type) == 2)
    np.testing.assert_allclose(foc_p[valid & ~refracted], foc_r[valid & ~refracted], rtol=1e-7)
    np.testing.assert_allclose(foc_p[refracted], foc_r[refracted], rtol=5e-3)
    # not the implicit derivative: the finite difference differs from it
    implicit = dataclasses.replace(numeric, focusing_mode="implicit")
    ps, pc, pb = convert.from_jax(implicit, ch, batch, device="cpu", dtype=torch.float64)
    foc_i = tpipe.simulate_batch(pb, pc, ps).focusing.numpy()
    assert np.any(np.abs(foc_i[valid] - foc_p[valid]) > 1e-6 * foc_p[valid])
    with pytest.raises(ValueError, match="focusing_mode"):
        tpipe.simulate_batch(pb, pc, dataclasses.replace(ps, focusing_mode="exact"))


def test_npz_export_of_the_input_matches_hdf5_reader():
    from nuradiomc_tpu.sim import io_hdf5
    ref = io_hdf5.read_input_hdf5(INPUT)
    exp = io_input.read_input(io_input.INPUT_PA_NOISELESS)
    for name in io_input._ARRAYS:
        a, b = getattr(exp, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert sorted(exp.attrs) == sorted(ref.attrs)
    for key, value in ref.attrs.items():
        np.testing.assert_array_equal(exp.attrs[key], value, err_msg=key)


def _sets(res):
    ok = res["weights"] >= MIN_W
    return {name: np.sort(res["group_ids"][res["multiple_triggers"][:, i] & ok]).astype(np.int64)
            for i, name in enumerate(res["trigger_names"])}


def test_three_trigger_station_matches_jax_sets_and_golden():
    """``convert.multitrigger_simulation`` on the .npz export of the input:
    the configuration of tests/test_e2e_multitrigger.py's golden test."""
    sim = convert.multitrigger_simulation(str(io_input.INPUT_PA_NOISELESS), chunk_size=1024,
                                          device="cpu", dtype=torch.float64)
    res = sim.run()
    pin = np.load(PIN)
    golden = np.load(GOLDEN_MT)
    names = [n.decode() for n in golden["trigger_names"]]
    assert res["trigger_names"] == names == [str(n) for n in pin["trigger_names"]]
    mine = _sets(res)
    for i, name in enumerate(names):
        np.testing.assert_array_equal(mine[name], pin[name], err_msg=name)
        ref = set(int(g) for g in np.unique(golden["group_ids"][golden["multiple_triggers"][:, i]]))
        assert len(ref ^ set(int(g) for g in mine[name])) <= 1, name
        np.testing.assert_allclose(res["veff_per_trigger"][name],
                                   float(pin["veff_" + name]), rtol=1e-12)
    np.testing.assert_allclose(sim.Vrms_trigger, float(pin["Vrms_trigger"]), rtol=1e-12)


if __name__ == "__main__":
    # writes the pin file: the JAX package's own float64 per-trigger sets
    sys.path.insert(0, HERE)
    import conftest  # noqa: F401  (pins jax to the CPU in float64)
    import jax.numpy as jnp
    jsim = _jax_simulation(TRIGGERS, chunk_size=512, dtype=jnp.float64)
    jres = jsim.run()
    out = {"trigger_names": np.asarray(jres["trigger_names"]),
           "Vrms_trigger": np.float64(jsim.Vrms_trigger)}
    for name, ids in _sets(jres).items():
        out[name] = ids
        out["veff_" + name] = np.float64(jres["veff_per_trigger"][name])
    np.savez(PIN, **out)
    print({k: (v.tolist() if v.ndim else v.item()) for k, v in out.items()})
