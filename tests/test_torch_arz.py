"""The port's ARZ2019/ARZ2020 model held to the JAX package and to the
reference golden.

The same viewing angles go through the JAX ``arz.get_time_trace`` (vmapped)
and the port's batched one on the committed mini shower library
(``tests/golden/arz_minilib.pkl``) in float64: traces within 1e-9 of the
peak (the two sum the same integrand in a different order). Against the
reference's own traces (``tests/golden/arz.npz``) the port gets the
tolerances of ``tests/test_arz.py``: 2e-3 of the peak, the on-cone peak to
1e-2. The chunked walk over pairs gives the same traces as one chunk.
``Simulation`` with ARZ2020 is held to the JAX ``Simulation`` on event groups
of the 1e18 eV input.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_arz.py`` writes
``nuradiomc_tpu_torch/data/arz_jax_sets.npz``: 160 event groups of that
input (those the Alvarez2000 dipole run triggers among the first 1500
events, then the first others) and the JAX package's ARZ2020 triggered set
on them (a pin of ``chip_smoke.py`` phase 9).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.ops import arz as jarz
from nuradiomc_tpu_torch.ops import arz as tarz

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
MINILIB = os.path.join(HERE, "golden", "arz_minilib.pkl")


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(HERE, "golden", "arz.npz"))


@pytest.fixture(scope="module")
def libs():
    return jarz.load_library_pickle(MINILIB), \
        tarz.load_library_pickle(MINILIB).to("cpu", torch.float64)


def _port_traces(golden, lib_t, version):
    N, dt = int(golden["N"]), float(golden["dt"])
    R, n_index, E = float(golden["R"]), float(golden["n_index"]), float(golden["energy"])
    thetas = torch.as_tensor(golden["thetas"])
    T = len(thetas)
    is_em = torch.tensor([False] * T + [True] * T)
    theta = thetas.repeat(2)
    energy = torch.full((2 * T,), E, dtype=torch.float64)
    ce = tarz.select_profile(lib_t, energy, is_em, torch.zeros(2 * T, dtype=torch.int64))
    got = tarz.get_time_trace(energy, theta, N, dt, lib_t.depth, ce, is_em, n_index, R,
                              version=version)
    return got.numpy().reshape(2, T, 3, N)


@pytest.mark.parametrize("version", ["ARZ2019", "ARZ2020"])
def test_traces_match_jax_and_reference(golden, libs, version):
    lib_j, lib_t = libs
    N, dt = int(golden["N"]), float(golden["dt"])
    R, n_index, E = float(golden["R"]), float(golden["n_index"]), float(golden["energy"])

    def one(theta, is_em):
        ce = jarz.select_profile(lib_j, E, is_em, 0)
        return jarz.get_time_trace(E, theta, N, dt, lib_j.depth, ce, is_em, n_index, R,
                                   version=version)

    f = jax.jit(jax.vmap(jax.vmap(one, in_axes=(0, None)), in_axes=(None, 0)))
    ref_j = np.asarray(f(jnp.asarray(golden["thetas"]), jnp.asarray([False, True])))
    got = _port_traces(golden, lib_t, version)
    scale = np.max(np.abs(ref_j))
    np.testing.assert_allclose(got / scale, ref_j / scale, atol=1e-9, err_msg=version)
    ref = golden[version]
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-3, err_msg=version)
    if version == "ARZ2020":
        np.testing.assert_allclose(np.max(np.abs(got[0, 3])), np.max(np.abs(ref[0, 3])),
                                   rtol=1e-2)


def test_library_and_helpers(libs):
    lib_j, lib_t = libs
    for name in lib_j._fields:
        np.testing.assert_allclose(getattr(lib_t, name).numpy(),
                                   np.asarray(getattr(lib_j, name)), rtol=1e-15)
    e = np.array([1e15, 1e17, 3e18, 1e19])
    np.testing.assert_allclose(tarz.em_fraction(torch.as_tensor(e)).numpy(),
                               np.asarray(jarz.em_fraction(jnp.asarray(e))), rtol=1e-12)
    th = np.linspace(0.3, 1.4, 4)
    np.testing.assert_allclose(
        tarz.theta_to_thetaprime(torch.as_tensor(th), 4.0, 900.0).numpy(),
        np.asarray(jarz.theta_to_thetaprime(jnp.asarray(th), 4.0, 900.0)), rtol=1e-12)
    tt = np.linspace(-3, 3, 13)
    prm = tarz.PARAMS["ARZ2020"]["HAD"][1:7]
    np.testing.assert_allclose(tarz._form_factor(torch.as_tensor(tt), *prm).numpy(),
                               np.asarray(jarz._form_factor(jnp.asarray(tt), *prm)), rtol=1e-12)
    assert tarz.PARAMS == jarz.PARAMS
    # the energy rescaling of the picked profile
    ce_j = np.asarray(jarz.select_profile(lib_j, 3e18, True, 0))
    ce_t = tarz.select_profile(lib_t, torch.tensor([3e18], dtype=torch.float64),
                               torch.tensor([True]), torch.tensor([0]))
    np.testing.assert_allclose(ce_t.numpy()[0], ce_j, rtol=1e-13)


def test_vector_potential_matches_jax(golden, libs):
    lib_j, lib_t = libs
    N, dt = 128, 0.5
    th = float(golden["thetas"][2])
    ce_j = jarz.select_profile(lib_j, 1e18, False, 0)
    vp_j = np.asarray(jarz.vector_potential(1e18, jnp.asarray(th), N, dt, lib_j.depth, ce_j,
                                            False, 1.78, 1000.0, "ARZ2019"))
    one = torch.ones(1, dtype=torch.float64)
    vp_t = tarz.vector_potential(1e18 * one, th * one, N, dt, lib_t.depth,
                                 torch.as_tensor(np.asarray(ce_j))[None], torch.tensor([False]),
                                 1.78, 1000.0 * one, "ARZ2019")
    assert vp_t.shape == (1, N + 1, 3)
    np.testing.assert_allclose(vp_t.numpy()[0], vp_j, atol=1e-9 * np.abs(vp_j).max())


def test_chunked_walk_equals_one_chunk(golden, libs, monkeypatch):
    _, lib_t = libs
    whole = _port_traces(golden, lib_t, "ARZ2020")
    monkeypatch.setattr(tarz, "_pairs_per_chunk", lambda *a: 3)
    np.testing.assert_array_equal(_port_traces(golden, lib_t, "ARZ2020"), whole)
    assert tarz._pairs_per_chunk.__name__ == "<lambda>"


def test_float32_traces_are_finite_and_close(golden, libs):
    """The depth grid in metres keeps float32 finite (column depths would
    overflow); float32 traces stay within 2e-3 of the peak of float64."""
    lib32 = tarz.load_library_pickle(MINILIB).to("cpu", torch.float32)
    N, dt = int(golden["N"]), float(golden["dt"])
    th = torch.as_tensor(golden["thetas"], dtype=torch.float32)
    n = len(th)
    e = torch.full((n,), float(golden["energy"]), dtype=torch.float32)
    em = torch.zeros(n, dtype=torch.bool)
    ce = tarz.select_profile(lib32, e, em, torch.zeros(n, dtype=torch.int64))
    got = tarz.get_time_trace(e, th, N, dt, lib32.depth, ce, em, float(golden["n_index"]),
                              float(golden["R"])).numpy()
    assert np.all(np.isfinite(got))
    ref = _port_traces(golden, libs[1], "ARZ2020")[0]
    np.testing.assert_allclose(got / np.abs(ref).max(), ref / np.abs(ref).max(), atol=2e-3)


# ---- the ARZ branch of simulate_batch through Simulation -------------------------

import dataclasses

from nuradiomc_tpu.sim import simulation as jsim
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim import io_input

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_inputs import write_input_hdf5  # noqa: E402

PIN = io_input.DATA_DIR / "arz_jax_sets.npz"
PIN_GROUPS = 160


def _jax_simulation(port, inputfile):
    return jsim.Simulation(
        inputfile, convert.DIPOLE_DETECTOR, config=port.config,
        filter_chain=[jsim.FilterStage(f.passband, f.filter_type, f.kwargs)
                      for f in port.filter_chain],
        trigger=jsim.TriggerSpec(**dataclasses.asdict(port.trigger)),
        antenna_replacements=port.antenna_replacements, arz_library_path=MINILIB,
        chunk_size=32, dtype=jnp.float64)


def _selected_hdf5(group_ids, path):
    inp = io_input.select(io_input.read_input(io_input.INPUT_1E18_N3000), group_ids)
    write_input_hdf5(inp, path)
    return inp


def test_minilib_copy():
    with open(MINILIB, "rb") as a, open(io_input.DATA_DIR / "arz_minilib.pkl", "rb") as b:
        assert a.read() == b.read()


def test_simulation_arz_matches_jax(tmp_path):
    """``Simulation`` with ARZ2020 on 48 of the pin's event groups against
    the JAX ``Simulation``: triggered set and the persisted library picks
    equal, amplitudes rtol 2e-4, and the set the committed pin holds."""
    pin = np.load(PIN)
    assert pin["triggered"].shape == pin["group_ids"].shape == (PIN_GROUPS,)
    # the groups Alvarez2000 triggers and the first others, 48 in all
    alv = pin["alvarez2000"]
    sub = np.sort(np.concatenate([np.flatnonzero(alv),
                                  np.flatnonzero(~alv)[:48 - alv.sum()]]))
    h5 = str(tmp_path / "in.hdf5")
    inp = _selected_hdf5(pin["group_ids"][sub], h5)
    port = convert.arz_simulation(inp, chunk_size=32, device="cpu", dtype=torch.float64)
    assert port.settings.askaryan_model == "ARZ2020" and port.arz_library is not None
    res = port.run()
    twin = _jax_simulation(port, h5)
    ref = twin.run()
    np.testing.assert_array_equal(res["triggered"], ref["triggered"])
    assert 3 < res["triggered"].sum() < 48
    np.testing.assert_array_equal(res["shower_realization_ARZ"],
                                  twin._realizations["shower_realization_ARZ"])
    np.testing.assert_allclose(res["max_amplitude"], ref["max_amplitude"], rtol=2e-4, atol=1e-15)
    np.testing.assert_array_equal(res["group_ids"], pin["group_ids"][sub])
    np.testing.assert_array_equal(pin["triggered"][sub], ref["triggered"])


def test_arz_needs_a_library():
    inp = io_input.head(io_input.read_input(io_input.INPUT_1E18_N3000), 2)
    with pytest.raises(ValueError, match="arz_library_path"):
        convert.dipole_simulation(inp, {"signal": {"model": "ARZ2019"}}, device="cpu")
    from nuradiomc_tpu_torch.sim import pipeline as tpipe
    sim = convert.arz_simulation(inp, device="cpu")
    batch = tpipe.ShowerBatch(*[None if a is None else torch.as_tensor(a)
                                for a in sim._build_batches()[-1]])
    with pytest.raises(ValueError, match="arz_library"):
        tpipe.simulate_batch(batch, sim.channel_params, sim.settings)


if __name__ == "__main__":
    import tempfile
    first = io_input.head(io_input.read_input(io_input.INPUT_1E18_N3000), 1500)
    dip = convert.dipole_simulation(first, chunk_size=512, device="cpu").run()
    trig = dip["group_ids"][dip["triggered"]]
    others = np.setdiff1d(dip["group_ids"], trig)[:PIN_GROUPS - len(trig)]
    ids = np.sort(np.concatenate([trig, others]))
    with tempfile.TemporaryDirectory() as tmp:
        h5 = os.path.join(tmp, "in.hdf5")
        inp = _selected_hdf5(ids, h5)
        port = convert.arz_simulation(inp, device="cpu")
        ref = _jax_simulation(port, h5).run()
    assert np.array_equal(ref["group_ids"], ids)
    np.savez_compressed(PIN, group_ids=ids, triggered=ref["triggered"], veff=ref["veff"],
                        alvarez2000=np.isin(ids, trig))
    print(f"wrote {PIN}: {int(ref['triggered'].sum())} of {len(ids)} groups "
          f"({len(trig)} trigger with Alvarez2000)")
