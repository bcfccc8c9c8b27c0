"""The port's time-domain Askaryan pulse, time-domain noise and
noise-trigger-rate tuning held to the JAX package, on the CPU in float64.

* ``askaryan.get_time_trace``: ZHS1992, Alvarez2000 and Alvarez2009 on 12
  showers from a numpy seed, each trace within 1e-10 of its peak;
* ``noise.bandlimited_noise_trace``: the transform of the numbers
  ``jax.random`` draws (rebuilt from the JAX package's split keys) within
  1e-12 of the peak, and the port's own draws at the asked RMS within 2%;
* ``noise_rate``: tests/test_noise_rate.py's 4-channel phased array with
  an 8-bit ADC. The transform (``max_beam_power_from_spectra``) of the
  spectra the JAX package draws for 128 traces against its
  ``max_beam_power_batch`` at rtol 1e-10; the rate curve and tuned threshold
  equal to the JAX package's on the same maxima; 4096 traces of the port's
  own draws: the filtered noise's RMS within 2% of Vrms, and that test's
  two properties (the tuned threshold reproduces its rate within 50%, the
  rate at the reference's 30.85 Vrms^2 below 10/(64 trace durations), the
  curve monotone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.ops import askaryan as jask
from nuradiomc_tpu.ops import filters as jfilters
from nuradiomc_tpu.ops import noise as jnoise
from nuradiomc_tpu.ops import phased_array as jpa
from nuradiomc_tpu.sim import noise_rate as jrate
from nuradiomc_tpu_torch.ops import askaryan as task
from nuradiomc_tpu_torch.ops import noise as tnoise
from nuradiomc_tpu_torch.sim import noise_rate as trate
from nuradiomc_tpu_torch.utils import fft as tfft
from nuradiomc_tpu_torch.utils import units


@pytest.mark.parametrize("model", ["ZHS1992", "Alvarez2000", "Alvarez2009"])
def test_time_trace_matches_the_jax_package(model):
    rng = np.random.default_rng(21)
    n = 12
    energy = 10 ** rng.uniform(16, 19, n) * units.eV
    theta = np.deg2rad(rng.uniform(50.0, 60.0, n))
    is_em = rng.uniform(size=n) < 0.5
    n_index = rng.uniform(1.3, 1.78, n)
    R = rng.uniform(100.0, 2000.0, n)
    k_L = task.draw_alvarez2009_k_L(energy, is_em, np.random.default_rng(3))
    N, dt = 512, 0.5
    want = np.asarray(jax.vmap(lambda e, t, m, ni, r, k: jask.get_time_trace(
        e, t, N, dt, m, ni, r, model, k_L=k))(energy, theta, is_em, n_index, R, k_L))
    got = task.get_time_trace(*(torch.as_tensor(x) for x in (energy, theta)), N, dt,
                              torch.as_tensor(is_em), *(torch.as_tensor(x) for x in (n_index, R)),
                              model, k_L=torch.as_tensor(k_L)).numpy()
    assert got.shape == want.shape == (n, N)
    peak = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-10 * peak)


def test_noise_trace_transform_of_jax_draws():
    n, fs, amp = 1024, 2.0, 3e-6
    F = n // 2 + 1
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jnoise.bandlimited_noise_trace(key, n, fs, amp, None, fs / 2,
                                                         dtype=jnp.float64))
        key_amp, key_phase = jax.random.split(key)
        draws = tuple(torch.as_tensor(np.asarray(x)) for x in (
            jax.random.uniform(key_amp, (F,), dtype=jnp.float64,
                               minval=jnp.finfo(jnp.float64).tiny),
            jax.random.uniform(key_phase, (F,), dtype=jnp.float64)))
        got = tfft.freq2time(tnoise.noise_spectrum_from_draws(
            draws, n, fs, torch.tensor(amp, dtype=torch.float64), None, fs / 2), fs, n=n).numpy()
        assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want).max())


def test_noise_trace_draws_have_the_asked_rms():
    gen = torch.Generator().manual_seed(5)
    amp = 2e-6
    trace = tnoise.bandlimited_noise_trace(gen, (2048,), 1024, 2.0, torch.tensor(amp), None,
                                           1.0, dtype=torch.float64)
    assert trace.shape == (2048, 1024)
    assert abs(float(trace.pow(2).mean().sqrt()) / amp - 1) < 0.02


# ---- noise_rate: tests/test_noise_rate.py's phased array ----------------------

FS, N, C = 2.0, 1024, 4
VRMS = 5.6749e-6


def _setup():
    ff = np.fft.rfftfreq(N, 1 / FS)
    chain = [((96 * units.MHz, 100 * units.GHz), "cheby1", {"order": 4, "rp": 0.1}),
             ((0, 220 * units.MHz), "cheby1", {"order": 7, "rp": 0.1})]
    filt = jfilters.chain_response(ff, chain)
    bw = np.trapezoid(np.abs(filt) ** 2, ff)
    amp = VRMS / np.sqrt(bw / (0.5 * FS))
    rolls = jpa.beam_rolls(np.array([-197.0, -198.0, -199.0, -200.0]), np.zeros(4),
                           jpa.default_angles, 1.75, 1.0)
    kw = dict(window=16, step=8, adc_fs=0.5, adc_nbits=8, adc_range=VRMS * 255 / 15,
              upsampling=2)
    return filt, amp, rolls, kw


@pytest.fixture(scope="module")
def jax_maxima():
    """The JAX package's maxima of 128 traces and the spectra it drew."""
    filt, amp, rolls, kw = _setup()
    key, B = jax.random.PRNGKey(4), 128
    want = np.asarray(jax.jit(lambda k: jrate.max_beam_power_batch(
        k, B, N, FS, amp, jnp.asarray(filt), rolls, C, dtype=jnp.float64, **kw))(key))
    # its draws: one key per (trace, channel), split into amplitude and phase
    keys = jax.random.split(key, B * C)
    spectra = jax.vmap(lambda k: jnoise.bandlimited_noise_spectrum(
        k, N, FS, amp, None, FS / 2, "rayleigh", jnp.float64))(keys).reshape(B, C, -1)
    F = N // 2 + 1

    def draws(k):
        ka, kp = jax.random.split(k)
        return (jax.random.uniform(ka, (F,), dtype=jnp.float64,
                                   minval=jnp.finfo(jnp.float64).tiny),
                jax.random.uniform(kp, (F,), dtype=jnp.float64))

    u_amp, u_phase = jax.vmap(draws)(keys)
    return want, np.asarray(spectra), (np.asarray(u_amp).reshape(B, C, F),
                                       np.asarray(u_phase).reshape(B, C, F))


def test_transform_of_jax_draws_matches_max_beam_power_batch(jax_maxima):
    want, spectra, (u_amp, u_phase) = jax_maxima
    filt, amp, rolls, kw = _setup()
    # the port's spectrum from the JAX package's uniforms equals its spectra
    spec = tnoise.noise_spectrum_from_draws(
        (torch.as_tensor(u_amp), torch.as_tensor(u_phase)), N, FS,
        torch.tensor(amp, dtype=torch.float64), None, FS / 2)
    assert np.all(np.abs(spec.numpy() - spectra) <= 1e-12 * np.abs(spectra).max())
    got = trate.max_beam_power_from_spectra(spec, N, FS, filt, rolls, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def test_rate_curve_and_threshold_equal_the_jax_package(jax_maxima):
    mp = jax_maxima[0]
    duration = N / FS
    thrs = np.linspace(5, 40, 8) * VRMS ** 2
    np.testing.assert_array_equal(trate.estimate_rate_curve(thrs, mp, duration),
                                  jrate.estimate_rate_curve(thrs, mp, duration))
    for target in (1.0 / (16 * duration), 100.0 * units.Hz, 1.0 / duration):
        assert trate.tune_threshold(target, mp, duration) == \
            jrate.tune_threshold(target, mp, duration)


@pytest.fixture(scope="module")
def port_maxima():
    filt, amp, rolls, kw = _setup()
    return trate.run_phased_array_tuning(4096, N, FS, amp, filt, rolls, C, seed=1, batch=1024,
                                         device="cpu", dtype=torch.float64, **kw)


def test_port_draws_filtered_rms():
    filt, amp, _, _ = _setup()
    gen = trate.chunk_generator(1, 0, "cpu")
    spec = tnoise.bandlimited_noise_spectrum(gen, (512, C), N, FS, amp, None, FS / 2,
                                             "rayleigh", torch.float64)
    traces = tfft.freq2time(spec * torch.as_tensor(filt), FS, n=N)
    assert abs(float(traces.pow(2).mean().sqrt()) / VRMS - 1) < 0.02


def test_port_tuned_threshold_reproduces_its_rate(port_maxima):
    duration = N / FS
    target = 1.0 / (64 * duration)  # a rate resolvable with 4096 traces
    thr = trate.tune_threshold(target, port_maxima, duration)
    rate = trate.estimate_rate_curve(np.array([thr]), port_maxima, duration)[0]
    assert abs(rate / target - 1) < 0.5


def test_port_reference_working_point_regime(port_maxima):
    duration = N / FS
    rate_at_ref = trate.estimate_rate_curve(np.array([30.85 * VRMS ** 2]), port_maxima,
                                            duration)[0]
    assert rate_at_ref < 10.0 / (duration * 64)
    rates = trate.estimate_rate_curve(np.linspace(5, 40, 8) * VRMS ** 2, port_maxima, duration)
    assert np.all(np.diff(rates) <= 1e-12)
