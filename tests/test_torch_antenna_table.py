"""The port's tabulated antennas and ``analytic_vel`` held to the JAX package,
float64.

* ``table_vel_raw`` / ``table_vel`` / ``_grid_weights`` on 200 random
  directions and a synthetic pattern written as
  ``tests/test_antenna_table.py::_make_synthetic_pickle`` writes it (the
  port's copy, ``convert.write_synthetic_antenna_pickle``, gives the same
  file): rtol 1e-12, including rotated antennas, out-of-band frequencies
  and the wrap of phi into the grid's window.
* ``analytic_vel`` for the three analytic kinds: rtol 1e-12.
* ``Simulation`` of the dipole golden's station with the synthetic table on
  the first 600 events of the 1e18 eV input against the JAX ``Simulation``:
  triggered set equal, amplitudes rtol 2e-4 (turning-point tolerance of the
  two-ray sum), the table entering the non-factored chain through kernel 4's
  wrapper. A fine tabulation of the analytic VPol reproduces the analytic
  run (tests/test_antenna_table.py:212's contract).

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_antenna_table.py``
writes ``nuradiomc_tpu_torch/data/antenna_table_jax_sets.npz``: the JAX
package's triggered set with the synthetic table on the whole 3000-event
input (a pin of ``chip_smoke.py`` phase 9).
"""

import dataclasses
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.ops import antenna as jant
from nuradiomc_tpu.sim import simulation as jsim
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.ops import antenna as tant
from nuradiomc_tpu_torch.ops import placement
from nuradiomc_tpu_torch.sim import io_input

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_antenna_table import _make_synthetic_pickle  # noqa: E402
from torch_port_inputs import write_input_hdf5  # noqa: E402

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
INPUT_HDF5 = os.path.join(HERE, "data", "1e18_n3000.hdf5")
PIN = io_input.DATA_DIR / "antenna_table_jax_sets.npz"


def _tables(tmp_path, ori=(0.0, 0.0)):
    path = str(tmp_path / "t.pkl")
    _make_synthetic_pickle(path, ori=ori)
    tj = jant.load_antenna_table(path)
    tn = tant.load_antenna_table(path)
    tt = tant.AntennaTable(*(torch.as_tensor(np.asarray(getattr(tn, k)))
                             for k in ("freqs", "thetas", "phis", "h_theta", "h_phi")),
                           orientation=tn.orientation)
    return tj, tn, tt


def test_synthetic_pickle_copy(tmp_path):
    a, b = str(tmp_path / "a.pkl"), str(tmp_path / "b.pkl")
    for ori in ((0.0, 0.0), (0.7, 1.1)):
        _make_synthetic_pickle(a, ori=ori)
        convert.write_synthetic_antenna_pickle(b, ori=ori)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            for x, y in zip(pickle.load(fa), pickle.load(fb)):
                np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=1e-15)


def test_load_antenna_table(tmp_path):
    tj, tn, _ = _tables(tmp_path, ori=(0.7, 1.1))
    for k in ("freqs", "thetas", "phis", "h_theta", "h_phi"):
        np.testing.assert_array_equal(getattr(tn, k), np.asarray(getattr(tj, k)))
    assert tn.orientation == tj.orientation and tn.h_theta.shape == (24, 25, 37)
    bad = tmp_path / "bad.pkl"
    with open(bad, "wb") as f:
        pickle.dump([1, 2, 3], f)
    with pytest.raises(ValueError, match="9"):
        tant.load_antenna_table(str(bad))


@pytest.mark.parametrize("ori", [(0.0, 0.0), (0.7, 1.1)])
def test_table_vel_matches_jax(tmp_path, ori):
    tj, tn, tt = _tables(tmp_path, ori)
    rng = np.random.default_rng(3)
    zen = np.append(rng.uniform(0, np.pi, 198), [0.0, np.pi])
    az = rng.uniform(-np.pi, 3 * np.pi, 200)
    freqs = np.append(np.fft.rfftfreq(64, 0.4), [0.01, 0.05, 1.2])   # with out-of-band bins
    # a detector antenna turned by 0.3 rad about the vertical
    rot = jant.antenna_rotation_matrix(0.0, 0.0, np.pi / 2, 0.3,
                                       model_orientation=tn.orientation)
    np.testing.assert_array_equal(
        rot, tant.antenna_rotation_matrix(0.0, 0.0, np.pi / 2, 0.3,
                                          model_orientation=tn.orientation))
    ref_t, ref_p = jax.vmap(lambda z, a: jant.table_vel(z, a, jnp.asarray(rot), tj,
                                                        jnp.asarray(freqs)))(
        jnp.asarray(zen), jnp.asarray(az))
    got_t, got_p = tant.table_vel(torch.as_tensor(zen), torch.as_tensor(az),
                                  torch.as_tensor(rot), tt, torch.as_tensor(freqs))
    scale = np.abs(np.asarray(ref_t)).max()
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-12, atol=1e-13 * scale)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=1e-12, atol=1e-13 * scale)
    assert np.all(got_t.numpy()[:, freqs < 0.05] == 0) and np.abs(got_t.numpy()).max() > 0.1
    # the raw gather, batched over a [5, 40] block of directions
    th = rng.uniform(-0.1, np.pi + 0.1, 200)
    ph = rng.uniform(-0.2, 2 * np.pi + 0.2, 200)
    raw_j = jax.vmap(lambda a, b: jant.table_vel_raw(tj, jnp.asarray(freqs), a, b))(
        jnp.asarray(th), jnp.asarray(ph))
    raw_t = tant.table_vel_raw(tt, torch.as_tensor(freqs), torch.as_tensor(th).reshape(5, 40),
                               torch.as_tensor(ph).reshape(5, 40))
    for g, r in zip(raw_t, raw_j):
        np.testing.assert_allclose(g.numpy().reshape(200, -1), np.asarray(r), rtol=1e-12,
                                   atol=1e-15)
    out = (th < 0) | (th > np.pi) | (ph < 0) | (ph > 2 * np.pi)
    assert out.any() and np.all(raw_t[0].numpy().reshape(200, -1)[out] == 0)
    i_j, w_j = jant._grid_weights(jnp.asarray(th), tj.thetas)
    i_t, w_t = tant._grid_weights(torch.as_tensor(th), tt.thetas)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-13)


@pytest.mark.parametrize("model", ["analytic_LPDA", "analytic_VPol", "analytic_HPol"])
def test_analytic_vel_matches_jax(model):
    rng = np.random.default_rng(7)
    zen, az = rng.uniform(0, np.pi, 64), rng.uniform(0, 2 * np.pi, 64)
    freqs = np.fft.rfftfreq(128, 0.5)
    kind = tant.ANALYTIC_MODELS[model][0]
    tpl = np.zeros((3, len(freqs)), dtype=complex)
    t = tant.build_analytic_template(model, freqs)
    tpl[:t.shape[0]] = t
    if t.shape[0] == 1:
        tpl[1:] = t[0]
    rot = tant.antenna_rotation_matrix(np.pi, 0.0, np.pi / 2, 0.5)
    ref_t, ref_p = jax.vmap(lambda z, a: jant.analytic_vel(
        z, a, jnp.asarray(rot), jnp.asarray(tpl), kind))(jnp.asarray(zen), jnp.asarray(az))
    got_t, got_p = tant.analytic_vel(torch.as_tensor(zen).reshape(8, 8),
                                     torch.as_tensor(az).reshape(8, 8), torch.as_tensor(rot),
                                     torch.as_tensor(tpl), kind)
    assert got_t.shape == (8, 8, len(freqs))
    np.testing.assert_allclose(got_t.numpy().reshape(64, -1), np.asarray(ref_t), rtol=1e-12,
                               atol=1e-16)
    np.testing.assert_allclose(got_p.numpy().reshape(64, -1), np.asarray(ref_p), rtol=1e-12,
                               atol=1e-16)


# ---- Simulation with a tabulated antenna ---------------------------------------

def _jax_simulation(port, inputfile, models_path):
    return jsim.Simulation(
        inputfile, port.det_dict, config=port.config,
        filter_chain=[jsim.FilterStage(f.passband, f.filter_type, f.kwargs)
                      for f in port.filter_chain],
        trigger=jsim.TriggerSpec(**dataclasses.asdict(port.trigger)),
        antenna_models_path=str(models_path), chunk_size=512, dtype=jnp.float64)


def _port_simulation(inp, models_path, **kw):
    sim = convert.table_simulation(inp, str(models_path), chunk_size=512, device="cpu",
                                   dtype=torch.float64, **kw)
    import copy
    sim.det_dict = copy.deepcopy(convert.DIPOLE_DETECTOR)
    sim.det_dict["channels"]["1"]["ant_type"] = convert.SYNTHETIC_TABLE
    return sim


def test_simulation_matches_jax(tmp_path, monkeypatch):
    inp = io_input.head(io_input.read_input(io_input.INPUT_1E18_N3000), 600)
    h5 = str(tmp_path / "in.hdf5")
    write_input_hdf5(inp, h5)
    port = _port_simulation(inp, tmp_path)
    assert port.channel_params.antenna_table is not None
    assert port.channel_params.antenna_table.h_theta.shape == (1, 24, 25, 37)
    seen = []
    fn = placement.placement_reduce
    monkeypatch.setattr(placement, "placement_reduce",
                        lambda *a, **k: seen.append(k["s2"]) or fn(*a, **k))
    res = port.run()
    assert seen and set(seen) == {4}      # up to 2 showers x 2 rays a group, kernel 4's wrapper
    ref = _jax_simulation(port, h5, tmp_path).run()
    np.testing.assert_array_equal(res["triggered"], ref["triggered"])
    assert 8 < res["triggered"].sum() < 600
    np.testing.assert_allclose(res["max_amplitude"], ref["max_amplitude"], rtol=2e-4, atol=1e-15)
    np.testing.assert_allclose(res["veff"], ref["veff"], rtol=1e-12)
    pin = np.load(PIN)
    np.testing.assert_array_equal(pin["triggered"][:len(ref["triggered"])], ref["triggered"])


def test_fine_tabulation_of_the_vpol_reproduces_the_analytic_run(tmp_path):
    freqs = np.fft.rfftfreq(512, 0.5)[1:]
    thetas = np.linspace(0.0, np.pi, 181)
    phis = np.linspace(0.0, 2 * np.pi, 13)
    tpl = tant.build_analytic_template("analytic_VPol", np.fft.rfftfreq(512, 0.5))[0][1:]
    iF, iP, iT = np.meshgrid(np.arange(len(freqs)), np.arange(len(phis)),
                             np.arange(len(thetas)), indexing="ij")
    h_t = (tpl[iF] * np.sin(thetas[iT])).ravel()
    (tmp_path / "tab_vpol").mkdir()
    with open(tmp_path / "tab_vpol" / "tab_vpol.pkl", "wb") as f:
        pickle.dump([0.0, 0.0, np.pi / 2, np.pi / 2, freqs[iF].ravel(), thetas[iT].ravel(),
                     phis[iP].ravel(), np.zeros_like(h_t), h_t], f, protocol=4)
    inp = io_input.head(io_input.read_input(io_input.INPUT_1E18_N3000), 400)
    import copy
    det = copy.deepcopy(convert.DIPOLE_DETECTOR)
    det["channels"]["1"]["ant_type"] = "tab_vpol"
    common = dict(chunk_size=512, device="cpu", dtype=torch.float64)
    res_tab = convert.dipole_simulation(inp, detector=det, antenna_models_path=str(tmp_path),
                                        **common).run()
    res_ana = convert.dipole_simulation(inp, **common).run()
    assert res_ana["triggered"].sum() > 0
    np.testing.assert_array_equal(res_tab["triggered"], res_ana["triggered"])
    both = res_tab["triggered"]
    np.testing.assert_allclose(res_tab["max_amplitude"][both], res_ana["max_amplitude"][both],
                               rtol=1e-4)


def test_missing_table_and_mixed_station_raise(tmp_path):
    import copy
    inp = io_input.head(io_input.read_input(io_input.INPUT_1E18_N3000), 4)
    det = copy.deepcopy(convert.DIPOLE_DETECTOR)
    det["channels"]["1"]["ant_type"] = "no_such_table"
    with pytest.raises(NotImplementedError, match="no tabulated data"):
        convert.dipole_simulation(inp, detector=det, device="cpu")
    convert.table_simulation(inp, str(tmp_path), device="cpu")     # writes the pickle
    det["channels"]["1"]["ant_type"] = convert.SYNTHETIC_TABLE
    det["channels"]["2"] = dict(convert.DIPOLE_DETECTOR["channels"]["1"], channel_id=1,
                                ant_type="analytic_VPol")
    with pytest.raises(NotImplementedError, match="mixing tabulated and analytic"):
        convert.dipole_simulation(inp, detector=det, antenna_models_path=str(tmp_path),
                                  device="cpu")


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        port = _port_simulation(str(io_input.INPUT_1E18_N3000), tmp)
        ref = _jax_simulation(port, INPUT_HDF5, tmp).run()
    np.savez_compressed(PIN, triggered=ref["triggered"], veff=ref["veff"])
    print(f"wrote {PIN}: {int(ref['triggered'].sum())} groups, veff {ref['veff']}")
