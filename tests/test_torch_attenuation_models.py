"""The port's attenuation models GL1, GL2, GL3, MB1 (and SP1 through the
generic entry points) held to the JAX package, float64, rtol 1e-12 for the
lengths and 1e-9 for the path integrals: the same depths, frequencies and
ray roots from a numpy seed go through both. ``Simulation`` with GL1 on the
first 600 events of the 1e18 eV input equals the JAX ``Simulation``.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_attenuation_models.py``
writes ``nuradiomc_tpu_torch/data/gl1_jax_sets.npz``: the JAX package's
triggered set of the dipole station with GL1 attenuation on the whole
3000-event input (a pin of ``chip_smoke.py`` phase 9)."""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.models import ice as jice
from nuradiomc_tpu.ops import attenuation as jatt
from nuradiomc_tpu.ops import raytrace as jrt
from nuradiomc_tpu_torch.models import ice as tice
from nuradiomc_tpu_torch.ops import attenuation as tatt
from nuradiomc_tpu_torch.ops import raytrace as trt

torch.set_num_threads(1)
MODELS = ("SP1", "GL1", "GL2", "GL3", "MB1")


def test_model_list():
    assert tatt.MODELS == jatt.MODELS == MODELS
    with pytest.raises(NotImplementedError):
        tatt.get_attenuation_length(torch.tensor(-10.0), torch.tensor(0.2), "XX9")


@pytest.mark.parametrize("model", MODELS)
def test_attenuation_length(model):
    rng = np.random.default_rng(5)
    z = np.append(rng.uniform(-2900.0, 0.0, 200), [0.0, 5.0, -3200.0, -0.001])
    if model == "MB1":
        z = np.clip(z, -576.0, None)
    f = rng.uniform(0.01, 1.5, len(z))
    ref = np.asarray(jatt.get_attenuation_length(jnp.asarray(z), jnp.asarray(f), model))
    got = tatt.get_attenuation_length(torch.as_tensor(z), torch.as_tensor(f), model).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert np.all(got >= 1.0) and np.isinf(got[z > 0]).all()
    # the outer-product form
    ff = np.linspace(0.05, 1.2, 7)
    ref = np.asarray(jatt.inv_length_factored(jnp.asarray(z), jnp.asarray(ff), model))
    got = tatt.inv_length_factored(torch.as_tensor(z), torch.as_tensor(ff), model).numpy()
    assert got.shape == (len(z), 7)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert np.all(got[z > 0] == 0)


def test_interp_is_numpy_interp():
    rng = np.random.default_rng(6)
    xp = np.sort(rng.uniform(0, 10, 12))
    fp = rng.normal(size=12)
    x = np.append(rng.uniform(-2, 12, 50), xp[[0, 3, -1]])
    np.testing.assert_allclose(
        tatt.interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp)).numpy(),
        np.interp(x, xp, fp), rtol=1e-13, atol=1e-15)
    # a table per row
    fp2 = rng.normal(size=(4, 1, 12))
    x2 = rng.uniform(-2, 12, (4, 3, 9))
    got = tatt.interp(torch.as_tensor(x2), torch.as_tensor(xp), torch.as_tensor(fp2)).numpy()
    for i in range(4):
        np.testing.assert_allclose(got[i], np.interp(x2[i], xp, fp2[i, 0]), rtol=1e-13,
                                   atol=1e-15)


def test_gl3_table_copy():
    np.testing.assert_array_equal(tatt._GL3, jatt._GL3)


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(8)
    n = 128
    r = rng.uniform(50.0, 2000.0, n)
    x1 = np.stack([r, np.zeros(n), rng.uniform(-2500.0, -5.0, n)], -1)
    x2 = np.stack([np.zeros(n), np.zeros(n), rng.uniform(-150.0, -2.0, n)], -1)
    geom_j = jrt.to_2d(jnp.asarray(x1), jnp.asarray(x2))
    geom_t = trt.to_2d(torch.as_tensor(x1), torch.as_tensor(x2))
    sols = jax.jit(jax.vmap(lambda a, b, c, d: jrt.find_solutions(
        a, b, c, d, jice.greenland_simple)))(geom_j.x1y, geom_j.x1z, geom_j.x2y, geom_j.x2z)
    return geom_j, geom_t, sols


@pytest.mark.parametrize("model", ["GL1", "GL2", "GL3", "MB1"])
@pytest.mark.parametrize("quadrature,n_steps", [("gauss", 8), ("midpoint", 16)])
def test_attenuation_factor_generic_branch(rays, model, quadrature, n_steps):
    """``raytrace.attenuation_factor`` beside the SP1 moments: the
    t-substituted integral per branch, on the JAX roots."""
    geom_j, geom_t, sols = rays
    freqs = np.append(np.linspace(0.0039, 0.5, 8), np.linspace(0.504, 1.0, 4))
    c0 = np.asarray(sols.c0)
    n = c0.shape[0]
    ref = jax.jit(jax.vmap(lambda c, a, b, cc, d: jrt.attenuation_factor(
        c, a, b, cc, d, jice.greenland_simple, jnp.asarray(freqs), model,
        n_steps=n_steps, quadrature=quadrature)))(
        jnp.asarray(c0.reshape(-1)),
        *[jnp.repeat(getattr(geom_j, k), 2) for k in ("x1y", "x1z", "x2y", "x2z")])
    got = trt.attenuation_factor(
        torch.as_tensor(c0), geom_t.x1y[:, None], geom_t.x1z[:, None],
        geom_t.x2y[:, None], geom_t.x2z[:, None], tice.greenland_simple,
        torch.as_tensor(freqs), model, n_steps=n_steps, quadrature=quadrature)
    mask = np.asarray(sols.mask)
    assert mask.sum() > n // 2
    ref = np.asarray(ref).reshape(n, 2, -1)
    np.testing.assert_allclose(got.numpy()[mask], ref[mask], rtol=1e-9)
    # MB1's depth scaling takes the log of a negative number below ~1164 m
    # (both packages give NaN there: it is a model of a 576 m ice shelf)
    fin = np.isfinite(ref[mask])
    assert fin.mean() > (0.3 if model == "MB1" else 0.999)
    assert np.all((got.numpy()[mask][fin] > 0) & (got.numpy()[mask][fin] <= 1))


# ---- Simulation with another attenuation model ---------------------------------

from nuradiomc_tpu.sim import simulation as jsim
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim import io_input

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_inputs import write_input_hdf5  # noqa: E402

PIN = io_input.DATA_DIR / "gl1_jax_sets.npz"
INPUT_HDF5 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "1e18_n3000.hdf5")
GL1 = {"propagation": {"attenuation_model": "GL1"}}


def _jax_simulation(port, inputfile):
    return jsim.Simulation(
        inputfile, convert.DIPOLE_DETECTOR, config=port.config,
        filter_chain=[jsim.FilterStage(f.passband, f.filter_type, f.kwargs)
                      for f in port.filter_chain],
        trigger=jsim.TriggerSpec(**dataclasses.asdict(port.trigger)),
        antenna_replacements=port.antenna_replacements, chunk_size=512, dtype=jnp.float64)


def test_simulation_gl1_matches_jax(tmp_path):
    inp = io_input.head(io_input.read_input(io_input.INPUT_1E18_N3000), 600)
    h5 = str(tmp_path / "in.hdf5")
    write_input_hdf5(inp, h5)
    port = convert.dipole_simulation(inp, GL1, chunk_size=512, device="cpu", dtype=torch.float64)
    assert port.settings.attenuation_model == "GL1"
    res = port.run()
    ref = _jax_simulation(port, h5).run()
    np.testing.assert_array_equal(res["triggered"], ref["triggered"])
    np.testing.assert_allclose(res["max_amplitude"], ref["max_amplitude"], rtol=2e-4, atol=1e-15)
    np.testing.assert_allclose(res["veff"], ref["veff"], rtol=1e-12)
    # another model, another result
    sp1 = convert.dipole_simulation(inp, chunk_size=512, device="cpu", dtype=torch.float64).run()
    assert not np.allclose(sp1["max_amplitude"], res["max_amplitude"], rtol=1e-3)
    pin = np.load(PIN)
    np.testing.assert_array_equal(pin["triggered"][:len(ref["triggered"])], ref["triggered"])


if __name__ == "__main__":
    port = convert.dipole_simulation(str(io_input.INPUT_1E18_N3000), GL1, device="cpu")
    ref = _jax_simulation(port, INPUT_HDF5).run()
    np.savez_compressed(PIN, triggered=ref["triggered"], veff=ref["veff"])
    print(f"wrote {PIN}: {int(ref['triggered'].sum())} groups, veff {ref['veff']}")
