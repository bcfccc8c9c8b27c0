"""The port's ``Simulation`` on the phased-array workload and on the ``.npz``
input export, on the CPU, float64.

* the noisy phased-array golden (tests/data/1e18_n3000.hdf5 against
  e2e_pa_reference.npz), with the rules of tests/test_e2e_phased_array.py:
  the noise streams differ between the frameworks, so the triggered count
  lies within 3 sqrt(n) of NuRadioMC's, the overlap is >= 60%, and Veff is
  within 2 * (2 / sqrt(n)) (the noiseless golden is in
  tests/test_torch_pa_golden.py);
* the Alvarez2009 k_L draw equal to the JAX package's for the same seed, and
  carried into the results;
* the ``.npz`` export of tests/data/1e18_n3000.hdf5 equal, column by column
  and attribute by attribute, to what the JAX package's HDF5 reader returns;
* ``Simulation`` imported and run from the export in a process where h5py
  and jax cannot be imported (as on the card): the dipole 3000-event golden
  (tests/golden/e2e_reference.npz) with its triggered set and Veff.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from nuradiomc_tpu.sim import evtgen, io_hdf5
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim import io_input
from nuradiomc_tpu_torch.sim.evtgen import group_into_events

torch.set_num_threads(1)
HERE = os.path.dirname(__file__)
ROOT = os.path.dirname(HERE)
NOISY_INPUT = os.path.join(HERE, "data", "1e18_n3000.hdf5")
MIN_W = 1e-5


def _triggered(res):
    return set(int(g) for g in res["group_ids"][res["triggered"] & (res["weights"] >= MIN_W)])


def _golden_set(name):
    g = np.load(os.path.join(HERE, "golden", name))
    return g, set(int(x) for x in np.unique(g["group_ids"][g["triggered"]]))


def test_noisy_pa_golden():
    sim = convert.pa_simulation(NOISY_INPUT, chunk_size=1024, device="cpu",
                                dtype=torch.float64)
    res = sim.run()
    golden, ref = _golden_set("e2e_pa_reference.npz")
    mine = _triggered(res)
    n_ref = len(ref)
    assert abs(len(mine) - n_ref) <= 3 * np.sqrt(n_ref), (len(mine), n_ref)
    assert len(mine & ref) >= 0.6 * n_ref, (sorted(mine), sorted(ref))
    rel_err = 2.0 / np.sqrt(int(golden["n_triggered"]))
    assert abs(res["veff"] / float(golden["veff"]) - 1) < 2 * rel_err
    assert res["shower_realization_Alvarez2009"].shape == (sim.input.n_showers,)


def test_k_L_draw_matches_jax_simulation():
    import jax.numpy as jnp

    from nuradiomc_tpu.sim import simulation as jsim
    port = convert.pa_simulation(io_input.INPUT_1E18_N3000, device="cpu", dtype=torch.float64)
    ref = jsim.Simulation(NOISY_INPUT, convert.PA_DETECTOR, config=port.config,
                          filter_chain=[jsim.FilterStage(f.passband, f.filter_type, f.kwargs)
                                        for f in port.filter_chain],
                          trigger=jsim.TriggerSpec(trigger_type="phased_array"),
                          antenna_replacements={"RNOG_vpol_v1_n1.73": "analytic_VPol"},
                          dtype=jnp.float64)
    b_port, b_ref = port._build_batches()[-1], ref._build_batches()[-1]
    np.testing.assert_array_equal(b_port.k_L, np.asarray(b_ref.k_L))
    assert b_port.k_L.std() > 0
    np.testing.assert_array_equal(port._realizations["shower_realization_Alvarez2009"],
                                  ref._realizations["shower_realization_Alvarez2009"])
    # the phased-array trigger settings (rolls, window, step, threshold, ADC)
    assert port.settings.triggers[0] == convert.settings_from_jax(ref.settings).triggers[0]


def test_npz_export_matches_hdf5_reader():
    ref = io_hdf5.read_input_hdf5(NOISY_INPUT)
    exp = io_input.read_input(io_input.INPUT_1E18_N3000)
    for name in io_input._ARRAYS:
        a, b = getattr(exp, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert exp.emitter is None and ref.emitter is None
    assert sorted(exp.attrs) == sorted(ref.attrs)
    for key, value in ref.attrs.items():
        np.testing.assert_array_equal(exp.attrs[key], value, err_msg=key)
        assert type(exp.attrs[key]) is type(value) or isinstance(value, str), key


def test_group_into_events_is_a_copy():
    rng = np.random.default_rng(12)
    for gap in (1e6, 50.0):
        for n in (1, 2, 5, 9):
            times = rng.choice([0.0, 10.0, 1e3, 3e6, 3e6 + 20.0], n) + rng.uniform(0, 5, n)
            np.testing.assert_array_equal(group_into_events(times, gap),
                                          evtgen.group_into_events(times, gap))


def test_simulation_runs_without_h5py_and_jax(tmp_path):
    """What the card's Python has: no h5py, and the port imports no jax."""
    code = textwrap.dedent("""
        import sys
        sys.modules["h5py"] = None          # import h5py raises ImportError
        for name in ("jax", "jaxlib"):
            sys.modules[name] = None
        import numpy as np, torch
        torch.set_num_threads(1)
        from nuradiomc_tpu_torch.convert import dipole_simulation
        from nuradiomc_tpu_torch.sim.io_input import INPUT_1E18_N3000
        from nuradiomc_tpu.utils import units
        sim = dipole_simulation(str(INPUT_1E18_N3000), chunk_size=1024, device="cpu",
                                dtype=torch.float64)
        res = sim.run()
        sel = res["triggered"] & (res["weights"] >= 1e-5)
        assert "h5py" not in [m for m in sys.modules if sys.modules[m] is not None]
        print(res["veff"] / units.km ** 3, *sorted(int(g) for g in res["group_ids"][sel]))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    veff, *groups = proc.stdout.split()
    golden = np.load(os.path.join(HERE, "golden", "e2e_reference.npz"))
    assert round(float(veff), 5) == 0.22978
    assert set(int(g) for g in groups) == set(int(g) for g in np.unique(golden["group_ids"]))
