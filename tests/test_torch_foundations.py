"""The port's foundation modules held to the JAX package on the CPU.

Inputs come from a numpy seed and go through the JAX function and its
counterpart in nuradiomc_tpu_torch. Tolerances: float64 rtol 1e-12 for the
closed-form modules (fft, geometry, ice, SP1, trace) — both sides evaluate
the same formulas in double precision, so only the last bits may differ;
1e-9 relative to the peak for the Askaryan spectrum (a product of ~20
transcendental factors); triggers bit-exact.
"""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.models import ice as jice
from nuradiomc_tpu.ops import antenna as jantenna
from nuradiomc_tpu.ops import askaryan as jaskaryan
from nuradiomc_tpu.ops import attenuation as jatt
from nuradiomc_tpu.ops import trace as jtrace
from nuradiomc_tpu.ops import triggers as jtriggers
from nuradiomc_tpu.utils import fft as jfft
from nuradiomc_tpu.utils import geometry as jgeo
from nuradiomc_tpu.utils import units
from nuradiomc_tpu_torch.models import ice as tice
from nuradiomc_tpu_torch.ops import antenna as tantenna
from nuradiomc_tpu_torch.ops import askaryan as taskaryan
from nuradiomc_tpu_torch.ops import attenuation as tatt
from nuradiomc_tpu_torch.ops import trace as ttrace
from nuradiomc_tpu_torch.ops import triggers as ttriggers
from nuradiomc_tpu_torch.utils import fft as tfft
from nuradiomc_tpu_torch.utils import geometry as tgeo

torch.set_num_threads(1)
RTOL = 1e-12


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def test_fft_roundtrip_and_convention():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 256))
    close(tfft.time2freq(t(x), 2.0), jfft.time2freq(jnp.asarray(x), 2.0))
    spec = np.asarray(jfft.time2freq(jnp.asarray(x), 2.0))
    close(tfft.freq2time(t(spec), 2.0, n=256), jfft.freq2time(jnp.asarray(spec), 2.0, n=256),
          atol=1e-15)


def test_geometry_bases_and_projections():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(64, 3))
    zen, az = rng.uniform(0, np.pi, 64), rng.uniform(-np.pi, np.pi, 64)
    for p, r in zip(tgeo.cartesian_to_spherical(t(v)), jgeo.cartesian_to_spherical(jnp.asarray(v))):
        close(p, r)
    close(tgeo.spherical_to_cartesian(t(zen), t(az)),
          jgeo.spherical_to_cartesian(jnp.asarray(zen), jnp.asarray(az)), atol=1e-15)
    close(tgeo.onsky_basis(t(zen), t(az)), jgeo.onsky_basis(jnp.asarray(zen), jnp.asarray(az)),
          atol=1e-15)
    close(tgeo.ground_to_onsky(t(v), t(zen), t(az)),
          jgeo.ground_to_onsky(jnp.asarray(v), jnp.asarray(zen), jnp.asarray(az)), atol=1e-14)
    close(tgeo.onsky_to_ground(t(v), t(zen), t(az)),
          jgeo.onsky_to_ground(jnp.asarray(v), jnp.asarray(zen), jnp.asarray(az)), atol=1e-14)


@pytest.mark.parametrize("dtype, ctype", [(np.float32, torch.complex64),
                                          (np.float64, torch.complex128)])
def test_csqrt_follows_dtype(dtype, ctype):
    x = np.linspace(-2.0, 2.0, 41).astype(dtype)
    out = tgeo._csqrt(t(x))
    assert out.dtype == ctype
    ref = np.asarray(jgeo._csqrt(jnp.asarray(x)))
    close(out, ref, rtol=1e-6 if dtype == np.float32 else RTOL)


def test_fresnel_reflection_matches():
    zen = np.linspace(0.0, np.pi / 2 - 1e-3, 97)
    n1 = 1.35
    close(tgeo.fresnel_r_p(t(zen), n_2=1.0, n_1=t(np.float64(n1))),
          jgeo.fresnel_r_p(jnp.asarray(zen), n_2=1.0, n_1=n1), atol=1e-14)
    close(tgeo.fresnel_r_s(t(zen), n_2=1.0, n_1=t(np.float64(n1))),
          jgeo.fresnel_r_s(jnp.asarray(zen), n_2=1.0, n_1=n1), atol=1e-14)


def test_ice_model():
    z = np.linspace(-2800.0, 50.0, 301)
    assert tice.get_ice_model("southpole_2015") == tice.southpole_2015
    for name in ("southpole_2015", "southpole_simple", "greenland_simple",
                 "mooresbay_simple", "mooresbay_simple_2"):
        close(tice.get_ice_model(name).index_of_refraction(t(z)),
              jice.get_ice_model(name).index_of_refraction(jnp.asarray(z)))
    # the reflective-bottom sites carry their reflector
    mb, ref = tice.get_ice_model("mooresbay_simple"), jice.get_ice_model("mooresbay_simple")
    assert (mb.refl_z, mb.refl_coef, mb.refl_phase_shift) == (
        ref.refl_z, ref.refl_coef, ref.refl_phase_shift)
    with pytest.raises(NotImplementedError):
        tice.get_ice_model("no_such_site")


def test_sp1_coefficients_and_inverse_length():
    z = np.linspace(-2800.0, 20.0, 113)
    freqs = np.linspace(0.01, 2.5, 37)
    for p, r in zip(tatt.sp1_w_coeffs(t(z)), jatt.sp1_w_coeffs(jnp.asarray(z))):
        close(p, r)
    close(tatt.inv_length_factored(t(z), t(freqs), "SP1"),
          jatt.inv_length_factored(jnp.asarray(z), jnp.asarray(freqs), "SP1"))


def test_alvarez2000_spectrum():
    rng = np.random.default_rng(3)
    n = 48
    energy = 10 ** rng.uniform(15, 19.5, n) * units.eV
    theta = rng.uniform(0.6, 1.0, n)
    is_em = rng.uniform(size=n) < 0.5
    n_index = rng.uniform(1.35, 1.78, n)
    R = rng.uniform(100, 3000, n)
    port = taskaryan.get_frequency_spectrum(t(energy), t(theta), 512, 0.5, t(is_em),
                                            t(n_index), t(R), "Alvarez2000")
    ref = jax.vmap(lambda e, th, em, ni, r: jaskaryan.get_frequency_spectrum(
        e, th, 512, 0.5, em, ni, r, "Alvarez2000"))(
        jnp.asarray(energy), jnp.asarray(theta), jnp.asarray(is_em),
        jnp.asarray(n_index), jnp.asarray(R))
    ref = np.asarray(ref)
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    assert np.all(np.abs(port.numpy() - ref) <= 1e-9 * peak)
    with pytest.raises(NotImplementedError):
        taskaryan.get_frequency_spectrum(t(energy), t(theta), 512, 0.5, t(is_em),
                                         t(n_index), t(R), "ARZ2019")


def test_zhs1992_spectrum():
    """ZHS1992 with its 2 ns roll: the port's spectrum against the JAX
    function (1e-12 of each row's peak) and, transformed to the time domain,
    against the reference's traces in tests/golden/askaryan.npz (1e-9 of each
    trace's peak, the bound of tests/test_askaryan.py)."""
    import os

    from nuradiomc_tpu_torch.utils import fft as tfft
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", "askaryan.npz"),
                     allow_pickle=True)
    N, dt = int(golden["N"]), float(golden["dt"])
    R, n_index = float(golden["R"]), float(golden["n_index"])
    EE, SS, TT = np.meshgrid(golden["energies"], [0, 1], golden["thetas"], indexing="ij")
    energy, is_em, theta = EE.ravel(), SS.ravel() == 1, TT.ravel()
    full = np.full_like(energy, 1.0)
    port = taskaryan.get_frequency_spectrum(t(energy), t(theta), N, dt, t(is_em),
                                            t(n_index * full), t(R * full), "ZHS1992")
    ref = np.asarray(jax.vmap(lambda e, th, em: jaskaryan.get_frequency_spectrum(
        e, th, N, dt, em, n_index, R, "ZHS1992"))(
        jnp.asarray(energy), jnp.asarray(theta), jnp.asarray(is_em)))
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    assert peak.min() > 0 and np.all(np.abs(port.numpy() - ref) <= 1e-12 * peak)
    im = list(golden["models"]).index("ZHS1992")
    traces = golden["traces"][im].reshape(-1, N)
    got = tfft.freq2time(port, 1.0 / dt, n=N).numpy()
    scale = np.abs(traces).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(got / scale, traces / scale, atol=1e-9)
    # the roll is 2 ns, not the Alvarez models' half window
    assert np.all(np.abs(got).argmax(axis=-1) < N // 8)


def test_analytic_vel_mix():
    rng = np.random.default_rng(4)
    n = 64
    zen, az = rng.uniform(0.05, np.pi - 0.05, n), rng.uniform(-np.pi, np.pi, n)
    rot = np.stack([jantenna.antenna_rotation_matrix(*a) for a in
                    [(0.0, 0.0, np.pi / 2, 0.0), (np.pi / 2, 0.3, np.pi / 2, 0.3 + np.pi / 2)]
                    * (n // 2)])
    kind = np.tile([jantenna.KIND_VPOL, jantenna.KIND_LPDA], n // 2)
    port = tantenna.analytic_vel_mix(t(zen), t(az), t(rot), t(kind))
    ref = jax.vmap(jantenna.analytic_vel_mix)(jnp.asarray(zen), jnp.asarray(az),
                                              jnp.asarray(rot), jnp.asarray(kind))
    close(port[0], ref[0], atol=1e-14)
    close(port[1], ref[1], atol=1e-14)
    np.testing.assert_array_equal(port[2].numpy(), np.asarray(ref[2]))


def test_host_helpers_are_verbatim():
    ff = np.fft.rfftfreq(512, 0.5)
    for model in jantenna.ANALYTIC_MODELS:
        np.testing.assert_array_equal(tantenna.build_analytic_template(model, ff),
                                      jantenna.build_analytic_template(model, ff))
    np.testing.assert_array_equal(tantenna.antenna_rotation_matrix(0.1, 0.2, 1.4, 0.2),
                                  jantenna.antenna_rotation_matrix(0.1, 0.2, 1.4, 0.2))


def test_hilbert_envelope_and_phase_ramp():
    rng = np.random.default_rng(5)
    spec = rng.normal(size=(6, 129)) + 1j * rng.normal(size=(6, 129))
    close(ttrace.hilbert_envelope_from_rfft(t(spec), 256, 2.0),
          jtrace.hilbert_envelope_from_rfft(jnp.asarray(spec), 256, 2.0), atol=1e-14)
    offsets = rng.uniform(0, 768.0, (5, 3))
    close(ttrace.time_shift_phase_uniform(1025, 2.0 / 2048, t(offsets)),
          jtrace.time_shift_phase_uniform(1025, 2.0 / 2048, jnp.asarray(offsets)),
          atol=1e-13)


def test_triggers_bit_exact():
    rng = np.random.default_rng(6)
    tr = rng.normal(size=(40, 3, 512))
    hi = np.asarray(jtriggers.get_high_low_triggers(jnp.asarray(tr), 2.2, -2.2, 5.0, 0.5))
    port_hi = ttriggers.get_high_low_triggers(t(tr), 2.2, -2.2, 5.0, 0.5).numpy()
    np.testing.assert_array_equal(port_hi, hi)
    th = np.asarray(jtriggers.get_threshold_triggers(jnp.asarray(tr), 2.5))
    np.testing.assert_array_equal(ttriggers.get_threshold_triggers(t(tr), 2.5).numpy(), th)
    for tts in (hi, th):
        for n_coinc in (1, 2):
            ref = jtriggers.majority_logic(jnp.asarray(tts), n_coinc, 200.0, 0.5)
            port = ttriggers.majority_logic(t(tts), n_coinc, 200.0, 0.5)
            for p, r in zip(port, ref):
                np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def test_port_imports_without_jax(tmp_path):
    """The package, its modules and chip_smoke.py import with jax blocked."""
    code = textwrap.dedent("""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("jax", "jaxlib"):
                    raise ImportError("jax is blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import nuradiomc_tpu_torch.sim.simulation
        import nuradiomc_tpu_torch.sim.pipeline
        import nuradiomc_tpu_torch.convert
        import nuradiomc_tpu_torch.ops.placement
        import nuradiomc_tpu_torch.ops.trigger_fused
        import nuradiomc_tpu_torch.ops.pa_trigger
        import nuradiomc_tpu_torch.ops.noise
        import nuradiomc_tpu_torch.sim.io_input
        import chip_smoke
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
        print("ok")
    """)
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
