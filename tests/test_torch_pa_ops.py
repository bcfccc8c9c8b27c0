"""The port's phased-array-path modules held to the JAX package on the CPU:
Alvarez2009 spectra and k_L draws, implicit focusing, noise, the trigger
ADC, beamforming and power sums, the resampling matrices, and the plain
version of kernel 3 against ``pa_pallas.fused_pa_trigger`` (Pallas in
interpret mode, as tests/test_pa_pallas.py runs it).

Tolerances, with their reasons:

* Alvarez2009: float64 within 1e-10 of each spectrum's peak; k_L draws
  identical (the same numpy code and Philox stream).
* focusing derivative: computed from the same (JAX) ray solutions, float64,
  as central differences of the miss function over a step of 1e-6 in log C0.
  Direct and reflected rays rtol 1e-8 (measured 5e-10). Refracted rays
  evaluate the path at their turning point, where a square root of a
  vanishing argument makes two correct implementations differ (the
  turning-point property tests/test_torch_raytrace.py states for C1 and path
  length): measured, their miss values differ by up to 1.2e-5 m at the same
  log C0, and the difference quotient over misses of ~2e-3 m turns that into
  up to 3.6e-3 relative in the derivative (1.8e-3 in the focusing factor,
  its square root). Refracted rays: half within rtol 1e-8, all within 1e-2.
* noise: the transform fed the numbers ``jax.random`` drew equals JAX to
  rounding (rtol 1e-12 float64, 2e-6 float32 of the spectrum's peak); the
  sampler's trace RMS within 2% of the amplitude over 4096 realizations.
* ADC counts and voltages bit-exact; beam rolls and matrices exact (the
  port's copies in ``ops/fft_plan.py`` against the JAX package's).
* beams and power sums: float64 rtol 1e-12; float32 within 1e-5 of the
  largest power (the cumsum runs in another order).
* kernel 3's plain version vs the Pallas kernel: decisions equal on groups
  whose best beam power lies more than 1e-4 from the threshold, first frames
  equal where both fire, amplitudes rtol 1e-5 (test_pa_pallas.py's rules).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.models import ice as jice
from nuradiomc_tpu.ops import adc as jadc
from nuradiomc_tpu.ops import askaryan as jaskaryan
from nuradiomc_tpu.ops import noise as jnoise
from nuradiomc_tpu.ops import phased_array as jpa
from nuradiomc_tpu.ops import raytrace as jrt
from nuradiomc_tpu.ops.pa_pallas import fused_pa_trigger as jax_fused_pa_trigger
from nuradiomc_tpu.sim import pipeline as jpipe
from nuradiomc_tpu.utils import units
from nuradiomc_tpu_torch.models import ice as tice
from nuradiomc_tpu_torch.ops import adc as tadc
from nuradiomc_tpu_torch.ops import askaryan as taskaryan
from nuradiomc_tpu_torch.ops import fft_plan
from nuradiomc_tpu_torch.ops import noise as tnoise
from nuradiomc_tpu_torch.ops import pa_trigger
from nuradiomc_tpu_torch.ops import phased_array as tpa
from nuradiomc_tpu_torch.ops import raytrace as trt

torch.set_num_threads(1)


def t(a, dtype=None):
    return torch.as_tensor(np.asarray(a) if dtype is None else np.asarray(a, dtype))


def _shower_params(n, seed):
    rng = np.random.default_rng(seed)
    return dict(energy=10 ** rng.uniform(15, 19.5, n) * units.eV,
                theta=rng.uniform(0.6, 1.0, n), is_em=rng.uniform(size=n) < 0.5,
                n_index=rng.uniform(1.35, 1.78, n), R=rng.uniform(100, 3000, n),
                k_L=rng.uniform(20.0, 60.0, n))


def test_alvarez2009_spectrum():
    p = _shower_params(48, 3)
    names = ("energy", "theta", "is_em", "n_index", "R")
    ref = np.asarray(jax.vmap(lambda e, th, em, ni, r, kl: jaskaryan.get_frequency_spectrum(
        e, th, 1024, 0.5, em, ni, r, "Alvarez2009", k_L=kl))(
        *[jnp.asarray(p[k]) for k in names + ("k_L",)]))
    port = taskaryan.get_frequency_spectrum(t(p["energy"]), t(p["theta"]), 1024, 0.5,
                                            t(p["is_em"]), t(p["n_index"]), t(p["R"]),
                                            "Alvarez2009", k_L=t(p["k_L"]))
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    assert np.all(peak > 0)
    assert np.all(np.abs(port.numpy() - ref) <= 1e-10 * peak)
    # float32: ice density / radiation length are combined in float64 first
    # (units.g alone overflows float32); magnitudes within 1e-4 of the peak
    # (the float32 window-centring phase, up to ~1.6e3 rad, is not compared)
    p32 = taskaryan.get_frequency_spectrum(
        t(p["energy"], np.float32), t(p["theta"], np.float32), 1024, 0.5, t(p["is_em"]),
        t(p["n_index"], np.float32), t(p["R"], np.float32), "Alvarez2009",
        k_L=t(p["k_L"], np.float32))
    assert p32.dtype == torch.complex64 and bool(torch.isfinite(p32).all())
    assert np.all(np.abs(np.abs(p32.numpy()) - np.abs(ref)) <= 1e-4 * peak)
    with pytest.raises(ValueError):
        taskaryan.get_frequency_spectrum(t(p["energy"]), t(p["theta"]), 1024, 0.5,
                                         t(p["is_em"]), t(p["n_index"]), t(p["R"]),
                                         "Alvarez2009")


def test_alvarez2009_k_L_draws_match():
    rng = np.random.default_rng(4)
    energy = 10 ** rng.uniform(15, 20, (300, 2)) * units.eV
    is_em = rng.uniform(size=(300, 2)) < 0.4
    draws = [mod.draw_alvarez2009_k_L(energy, is_em,
                                      np.random.default_rng(np.random.Philox(1235)))
             for mod in (jaskaryan, taskaryan)]
    np.testing.assert_array_equal(draws[1], draws[0])
    np.testing.assert_array_equal(taskaryan.had_k_L_alvarez2009(energy),
                                  jaskaryan.had_k_L_alvarez2009(energy))


def test_focusing_dtheta_dz():
    rng = np.random.default_rng(11)
    N = 512
    r = rng.uniform(50.0, 3000.0, N)
    phi = rng.uniform(0, 2 * np.pi, N)
    x1 = np.stack([r * np.cos(phi), r * np.sin(phi), rng.uniform(-2700.0, -5.0, N)], -1)
    x2 = np.stack([np.zeros(N), np.zeros(N), rng.uniform(-200.0, -5.0, N)], -1)
    geom_j = jrt.to_2d(jnp.asarray(x1), jnp.asarray(x2))
    sols_j = jax.jit(jax.vmap(lambda a, b, c, d: jrt.find_solutions(
        a, b, c, d, jice.southpole_2015)))(geom_j.x1y, geom_j.x1z, geom_j.x2y, geom_j.x2z)
    ref = np.asarray(jrt.focusing_dtheta_dz(geom_j, sols_j, jice.southpole_2015))
    geom_t = trt.to_2d(t(x1), t(x2))
    sols_t = trt.RaySolutions(*[t(getattr(sols_j, k)) for k in trt.RaySolutions._fields])
    port = trt.focusing_dtheta_dz(geom_t, sols_t, tice.southpole_2015).numpy()
    mask = np.asarray(sols_j.mask)
    direct = mask & (np.asarray(sols_j.sol_type) == jrt.SOL_DIRECT)
    turning = mask & ~direct
    assert direct.sum() > 50 and turning.sum() > 50
    assert np.all(np.isfinite(port[mask]))
    reflected = mask & (np.asarray(sols_j.sol_type) == jrt.SOL_REFLECTED)
    refracted = mask & (np.asarray(sols_j.sol_type) == jrt.SOL_REFRACTED)
    np.testing.assert_allclose(port[direct | reflected], ref[direct | reflected], rtol=1e-8)
    rel = np.abs(port[refracted] / ref[refracted] - 1)
    assert refracted.sum() > 20 and np.median(rel) <= 1e-8 and rel.max() <= 1e-2, rel


NOISE_CASES = [("rayleigh", "phase"), ("rayleigh", "gaussian"), ("perfect_white", "phase")]


@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-12), (np.float32, 2e-6)])
@pytest.mark.parametrize("ntype, sampler", NOISE_CASES)
def test_noise_transform_of_jax_draws(ntype, sampler, dtype, rtol):
    n, fs, amp = 2048, 2.0, 3e-6
    F = n // 2 + 1
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jnoise.bandlimited_noise_spectrum(
            key, n, fs, amp, None, fs / 2, type=ntype, dtype=dtype, sampler=sampler))
        key_amp, key_phase = jax.random.split(key)
        if sampler == "gaussian":
            z = np.asarray(jax.random.normal(key_amp, (2, F), dtype=dtype))
            draws = (t(z[0]), t(z[1]))
        else:
            draws = (t(jax.random.uniform(key_amp, (F,), dtype=dtype,
                                          minval=jnp.finfo(dtype).tiny)),
                     t(jax.random.uniform(key_phase, (F,), dtype=dtype)))
        port = tnoise.noise_spectrum_from_draws(
            draws, n, fs, torch.tensor(amp, dtype=draws[0].dtype), None, fs / 2,
            type=ntype, sampler=sampler).numpy()
        assert port.dtype == ref.dtype
        assert np.all(np.abs(port - ref) <= rtol * np.abs(ref).max())


@pytest.mark.parametrize("ntype, sampler", NOISE_CASES)
def test_noise_statistics(ntype, sampler):
    n, fs, amp = 1024, 2.0, 1e-5
    gen = torch.Generator().manual_seed(7)
    spec = tnoise.bandlimited_noise_spectrum(gen, (4096,), n, fs, torch.tensor(amp), None,
                                             fs / 2, type=ntype, dtype=torch.float64,
                                             sampler=sampler)
    trace = torch.fft.irfft(spec, n=n) * fs / np.sqrt(2.0)       # fft.freq2time
    rms = float(trace.pow(2).mean().sqrt())
    assert abs(rms / amp - 1) < 0.02, rms / amp
    assert bool((spec[:, 0] == 0).all())                        # DC removed
    assert bool((spec[:, -1].imag == 0).all())                  # Nyquist stays real
    band = tnoise.bandlimited_noise_spectrum(gen, (64,), n, fs, torch.tensor(amp), 0.1, 0.4,
                                             type=ntype, dtype=torch.float64, sampler=sampler)
    ff = np.fft.rfftfreq(n, 1 / fs)
    out = (ff < 0.1) | (ff > 0.4)
    assert bool((band[:, out] == 0).all()) and bool((band[:, ~out] != 0).all())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_perfect_comparator_bit_exact(dtype):
    rng = np.random.default_rng(9)
    tr = (rng.normal(size=(16, 512)) * 0.02).astype(dtype)       # saturates both sides
    tr[0, :5] = [0.0, -0.02, 0.02, 1e-9, -1e-9]
    for n_bits, rng_v in ((8, (-0.03, 0.03)), (4, (-0.01, 0.02))):
        for fn in ("perfect_floor_comparator", "perfect_ceiling_comparator"):
            for output in ("voltage", "counts"):
                ref = np.asarray(getattr(jadc, fn)(jnp.asarray(tr), n_bits, rng_v, output))
                port = getattr(tadc, fn)(t(tr), n_bits, rng_v, output).numpy()
                assert port.dtype == ref.dtype, (fn, output)
                np.testing.assert_array_equal(port, ref, err_msg=f"{fn} {output}")
    assert tadc.symmetric_range(1e-5, 3, 8) == jadc.symmetric_range(1e-5, 3, 8)


def test_beam_rolls_equal():
    for z, cable, fs in (([-197.0, -198.0, -199.0, -200.0], [0.0] * 4, 1.0),
                         ([-100.0, -101.5, -103.0], [1.0, 0.0, 2.5], 2.0)):
        np.testing.assert_array_equal(
            tpa.beam_rolls(z, cable, tpa.default_angles, 1.75, fs),
            jpa.beam_rolls(z, cable, jpa.default_angles, 1.75, fs))
    np.testing.assert_array_equal(tpa.default_angles, jpa.default_angles)


@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_beams_and_power_trigger(dtype, rtol):
    rng = np.random.default_rng(10)
    tr = rng.normal(size=(40, 4, 1024)).astype(dtype)
    rolls = jpa.beam_rolls([-197.0 - i for i in range(4)], [0.0] * 4, jpa.default_angles,
                           1.75, 1.0)
    np.testing.assert_array_equal(tpa.phase_signals(t(tr), rolls).numpy(),
                                  np.asarray(jpa.phase_signals(jnp.asarray(tr), rolls)))
    beams = np.asarray(jpa.phase_signals(jnp.asarray(tr), rolls))
    ref_p, nf = jpa.power_sum(jnp.asarray(beams), 16, 8)
    port_p, nf_t = tpa.power_sum(t(beams), 16, 8)
    assert nf_t == nf
    ref_p = np.asarray(ref_p)
    assert np.all(np.abs(port_p.numpy() - ref_p) <= rtol * np.abs(ref_p).max())
    thr = float(np.quantile(ref_p.max(axis=(1, 2)), 0.5)) * 1.01
    ref = jpa.phased_power_trigger(jnp.asarray(tr), rolls, thr, 16, 8)
    port = tpa.phased_power_trigger(t(tr), rolls, thr, 16, 8)
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(port[2].numpy(), np.asarray(ref[2]), rtol=rtol)
    np.testing.assert_array_equal(port[3].numpy(), np.asarray(ref[3]))
    assert np.asarray(ref[0]).any() and not np.asarray(ref[0]).all()


def test_resampling_matrices_equal():
    for args in ((1024, 2560, 10), (2048, 5120, 10)):
        for port, ref in zip(fft_plan._decimating_irfft_matrices(*args),
                             jpipe._decimating_irfft_matrices(*args)):
            np.testing.assert_array_equal(port, ref)
    for args in ((512, 2), (256, 3)):
        np.testing.assert_array_equal(fft_plan._fft_upsample_matrix(*args),
                                      jpipe._fft_upsample_matrix(*args))
    Dd_r, Dd_i = fft_plan.decimate_dense(2048, 5120, 10, 512, torch.float32,
                                         torch.device("cpu"))
    assert Dd_r.shape == (512, 512) and Dd_r.is_contiguous()
    np.testing.assert_array_equal(Dd_i.numpy(),
                                  jpipe._decimating_irfft_matrices(2048, 5120, 10)[1][:512]
                                  .astype(np.float32))
    U = fft_plan.upsample_dense(512, 2, torch.float64, torch.device("cpu"))
    assert U.shape == (512, 1024) and U.is_contiguous()
    np.testing.assert_array_equal(U.numpy(), jpipe._fft_upsample_matrix(512, 2))


def test_fused_pa_plain_matches_pallas():
    """The inputs of tests/test_pa_pallas.py::test_fused_pa_matches_xla_chain."""
    rng = np.random.RandomState(11)
    G, C = 12, 4
    n_base, fs, fs_hi = 1024, 2.0, 5.0
    adc_fs, nbits, up = 0.5, 8, 2
    window, step, adc_range = 32, 16, 0.04
    F = n_base // 2 + 1
    spec = (rng.randn(G * C, F) + 1j * rng.randn(G * C, F)).astype(np.complex64) * 1e-3
    I_r, I_i = jpipe._irfft_matrices(n_base)
    Dd_r, Dd_i = jpipe._decimating_irfft_matrices(n_base, int(round(n_base * fs_hi / fs)),
                                                  int(round(fs_hi / adc_fs)))
    U = jpipe._fft_upsample_matrix(Dd_r.shape[1], up)
    rolls = jpa.beam_rolls([-197.0 - i for i in range(C)], [0.0] * C, jpa.default_angles,
                           1.73, adc_fs * up)
    kw = dict(scale_full=fs / np.sqrt(2.0), scale_dec=fs_hi / np.sqrt(2.0), rolls=rolls,
              window=window, step=step, v_min=-adc_range / 2,
              lsb=adc_range / (2 ** nbits - 1), n_counts=2 ** nbits, C=C)
    targs = [t(a, np.float32) for a in (spec.real, spec.imag)]
    lengths = dict(n_base=n_base, n_hi=int(round(n_base * fs_hi / fs)),
                   decim=int(round(fs_hi / adc_fs)), up=up)
    *_, max_power = pa_trigger.fused_pa_trigger_plain(*targs, threshold=1.0, **lengths, **kw)
    max_power = max_power.numpy()
    for q in (0.35, 0.75):
        thr = float(np.quantile(max_power, q)) * 1.001
        fired, frame, amp = (np.asarray(a) for a in jax_fused_pa_trigger(
            jnp.asarray(spec.real), jnp.asarray(spec.imag), I_r, I_i, Dd_r, Dd_i, U,
            threshold=thr, row_tile=4 * C, **kw))
        pf, pframe, pamp = (a.numpy() for a in pa_trigger.fused_pa_trigger(
            *targs, threshold=thr, **lengths, **kw))   # CPU tensors: the plain version
        solid = np.abs(max_power - thr) / thr > 1e-4
        assert solid.sum() >= G - 2
        np.testing.assert_array_equal(pf[solid], fired[solid])
        both = solid & pf & fired
        assert both.any() and not pf[solid].all()
        np.testing.assert_array_equal(pframe[both], frame[both])
        assert np.all(pframe[~pf] == 0)
        np.testing.assert_allclose(pamp, amp, rtol=1e-5)
