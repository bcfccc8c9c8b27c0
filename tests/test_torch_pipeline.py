"""The port's ``simulate_batch`` held to the JAX package's on the CPU.

Inputs: ``__graft_entry__._make_settings_and_inputs()`` (8 groups, 2
showers, 4 channels, 256/512 samples) with the bench's band limit
(``band_limit_eps=1e-2``), converted with ``convert.from_jax``.

* float64, JAX XLA path vs the port (kernel wrappers, plain versions on the
  CPU), 96 solver steps so both solvers converge: rtol 1e-9 on the
  per-solution fields and amplitudes, decisions exact. A second case turns
  on the options of the path the bench leaves off: a distance cut tight
  enough to drop 12 of the 52 valid solutions, no ice attenuation, no band
  limit, and two named triggers, the second a 2-channel threshold trigger
  gated on the first.
* float32, JAX Pallas placement + trigger kernels (interpret mode) vs the
  port, the bench's 28 solver steps: decisions exact; fields to rtol 1e-3
  (c0, travel time, launch vectors, trigger time) and 2e-2 (amplitudes).
  The float32 reference is partly float64 here: tests/conftest.py enables
  x64, so JAX evaluates rfftfreq and the Askaryan spectrum in float64, while
  the port stays in float32 (as JAX does with x64 off, where the pins were
  written). Measured: C0 8e-6, travel time 1.7e-5, amplitudes 1.2e-2 —
  a 1.7e-5 shift of a ~5 us travel time moves a pulse by ~0.1 ns, a fifth
  of a sample, which changes the sum of two rays in a channel by ~1%.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_settings_and_inputs
from nuradiomc_tpu.sim import pipeline as jpipe
from nuradiomc_tpu_torch.convert import from_jax
from nuradiomc_tpu_torch.sim import pipeline as tpipe

torch.set_num_threads(1)
FIELDS = ("c0", "travel_time", "launch_vector", "max_amp_per_solution",
          "max_amplitude", "trigger_time")


def _f64(tree):
    def up(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return a.astype(np.float64)
        if a.dtype == np.complex64:
            return a.astype(np.complex128)
        return a
    return jax.tree.map(up, tree)


OPTIONS = {
    "bench": dict(band_limit_eps=1e-2),
    "options": dict(
        distance_cut=True, distance_cut_coefficients=(3.3, 0.0, 0.0, 0.0),
        attenuate_ice=False, triggers=(
            jpipe.TriggerSettings(name="hl", threshold_high=2e-5, threshold_low=-2e-5),
            jpipe.TriggerSettings(name="thr", trigger_type="simple_threshold",
                                  threshold_high=1e-4, number_of_coincidences=2,
                                  requires="hl"))),
}


@pytest.fixture(scope="module", params=sorted(OPTIONS))
def case64(request):
    s, ch, b = _make_settings_and_inputs()
    s = dataclasses.replace(s, n_bisect=96, **OPTIONS[request.param])
    ch, b = _f64(ch), _f64(b)
    ref = jax.jit(lambda bb: jpipe.simulate_batch(bb, ch, s))(b)
    ps, pc, pb = from_jax(s, ch, b, device="cpu", dtype=torch.float64)
    return ref, tpipe.simulate_batch(pb, pc, ps)


@pytest.fixture(scope="module")
def case32():
    s, ch, b = _make_settings_and_inputs()
    s = dataclasses.replace(s, band_limit_eps=1e-2, placement_impl="pallas",
                            trigger_impl="pallas")
    ref = jax.jit(lambda bb: jpipe.simulate_batch(bb, ch, s))(b)
    ps, pc, pb = from_jax(s, ch, b, device="cpu", dtype=torch.float32)
    return ref, tpipe.simulate_batch(pb, pc, ps)


def _compare(ref, port, rtol_fields):
    valid = np.asarray(ref.sol_mask)
    np.testing.assert_array_equal(port.sol_mask.numpy(), valid)
    np.testing.assert_array_equal(port.triggered.numpy(), np.asarray(ref.triggered))
    trig = np.asarray(ref.triggered)
    assert trig.any()
    np.testing.assert_array_equal(port.triggered_per.numpy(),
                                  np.asarray(ref.triggered_per))
    for name in FIELDS:
        r = np.asarray(getattr(ref, name))
        p = getattr(port, name).numpy()
        if name == "trigger_time":
            r, p = r[trig], p[trig]
        elif r.shape[:4] == valid.shape:
            r, p = r[valid], p[valid]
        np.testing.assert_allclose(p, r, rtol=rtol_fields[name], atol=0, err_msg=name)


def test_simulate_batch_float64_matches_xla_path(case64):
    ref, port = case64
    assert port.c0.dtype == torch.float64
    _compare(ref, port, dict.fromkeys(FIELDS, 1e-9))


def test_simulate_batch_float32_matches_pallas_path(case32):
    ref, port = case32
    assert port.c0.dtype == torch.float32
    _compare(ref, port, {"c0": 1e-3, "travel_time": 1e-3, "launch_vector": 1e-3,
                         "trigger_time": 1e-3, "max_amp_per_solution": 2e-2,
                         "max_amplitude": 2e-2})


def test_plain_impl_equals_kernel_impl_on_cpu(case32):
    _, port = case32
    s, ch, b = _make_settings_and_inputs()
    ps, pc, pb = from_jax(dataclasses.replace(s, band_limit_eps=1e-2), ch, b,
                          device="cpu", dtype=torch.float32)
    plain = tpipe.simulate_batch(pb, pc, dataclasses.replace(
        ps, placement_impl="plain", trigger_impl="plain"))
    for name in FIELDS + ("triggered",):
        np.testing.assert_array_equal(getattr(plain, name).numpy(),
                                      getattr(port, name).numpy())


def test_unported_options_raise():
    """What still raises: a model name the pipeline does not know; the
    options ported since then run (their own test files hold them to the JAX
    package), ``keep_traces`` among them (tests/test_torch_nur_output.py)."""
    s, ch, b = _make_settings_and_inputs()
    ps, pc, pb = from_jax(s, ch, b, device="cpu", dtype=torch.float32)
    kept = tpipe.simulate_batch(pb, pc, ps, keep_traces=True)
    assert kept.traces.shape == (pb.energies.shape[0], pc.positions.shape[0], ps.n_base)
    with pytest.raises(NotImplementedError, match="not implemented"):
        tpipe.simulate_batch(pb, pc, dataclasses.replace(ps, askaryan_model="HCRB2017"))
    with pytest.raises(NotImplementedError, match="not implemented"):
        tpipe.simulate_batch(pb, pc, dataclasses.replace(ps, attenuation_model="XX1"))
    # bottom reflections want an ice with a reflector, ARZ its library
    with pytest.raises(ValueError, match="reflective bottom"):
        tpipe.simulate_batch(pb, pc, dataclasses.replace(ps, n_reflections=1))
    with pytest.raises(ValueError, match="arz_library"):
        tpipe.simulate_batch(pb, pc, dataclasses.replace(ps, askaryan_model="ARZ2019"))
    # the settings' own checks run when they are built
    with pytest.raises(ValueError, match="'kernel' or 'plain'"):
        dataclasses.replace(ps, placement_impl="pallas")
    # GL1 attenuation runs on this batch now
    out = tpipe.simulate_batch(pb, pc, dataclasses.replace(ps, attenuation_model="GL1"))
    assert out.triggered.shape == (pb.energies.shape[0],)
