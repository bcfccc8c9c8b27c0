"""The port's ``Simulation`` with several named triggers, a separate trigger
chain, sub-event windows, numeric focusing and ZHS1992, held to the JAX
package's ``Simulation`` on the CPU, float64.

Input: the 400-event 1e18 eV list of tests/test_trigger_channels.py
(``evtgen.generate_eventlist_cylinder(..., seed=21)``), one dipole at 100 m,
the butterworth readout chain and an 8-rung high/low threshold ladder (2 to
5.5 sigma, the reference workflow's, pipeline.py:200-203). Each case runs
both packages on the same file:

* ``multiple_triggers`` and ``triggered`` equal, ``veff_per_trigger`` and
  ``Vrms_trigger`` / ``bandwidth_trigger`` rtol 1e-12, ``trigger_times`` of
  the fired columns rtol 1e-8 (the earliest arrival carries a refracted ray's
  travel time: turning-point tolerance) and ``max_amplitude`` rtol 2e-4 (a
  refracted ray's pulse moves by that tolerance against the other ray's in
  the channel's sum; tests/test_torch_multitrigger.py holds the groups
  without such a ray to 1e-9; 5e-3 with numeric focusing, whose factor for a
  refracted ray is a difference quotient at the turning point);
* cases: the ladder alone, a distinct (narrower) trigger chain,
  ``n_windows: 2``, ``focusing_mode: "numeric"`` and ``ZHS1992``.

And with the port alone: an identical trigger chain is a no-op
(tests/test_trigger_channels.py:70-86's contract); the 3000-event input with
the two chains of that file finds the triggered set and the trigger-chain
Vrms of tests/golden/e2e_trigger_channels_reference.npz (NuRadioMC's own run
with extra trigger channels).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.sim import evtgen
from nuradiomc_tpu.sim import simulation as jsim
from nuradiomc_tpu.utils import units
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim.io_input import INPUT_1E18_N3000
from nuradiomc_tpu_torch.sim.simulation import FilterStage, TriggerSpec

torch.set_num_threads(1)
HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden", "e2e_trigger_channels_reference.npz")
REPLACE = {"XFDTD_Vpol_CrossFeed_150mmHole_n1.78": "analytic_VPol"}
SIGMAS = np.arange(2.0, 6.0, 0.5)

CASES = {
    "ladder": ({}, False),
    "distinct_chain": ({}, True),
    "n_windows_2": ({"propagation": {"n_windows": 2}}, False),
    "numeric_focusing": ({"propagation": {"focusing": True, "focusing_mode": "numeric"}}, False),
    "ZHS1992": ({"signal": {"model": "ZHS1992"}}, False),
}


@pytest.fixture(scope="module")
def small_input(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tc") / "in.hdf5")
    evtgen.generate_eventlist_cylinder(
        path, 400, 1e18, 1e18,
        {"fiducial_rmin": 0, "fiducial_rmax": 3 * units.km,
         "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0}, seed=21)
    return path


def _ladder(spec_cls):
    return [spec_cls(name=f"hilo_{s:g}sig", threshold_high_sigma=s, threshold_low_sigma=-s)
            for s in SIGMAS]


def _port(path, config=None, **kwargs):
    return convert.dipole_simulation(path, config, chunk_size=512, device="cpu",
                                     dtype=torch.float64, **kwargs)


def _jax(path, port, trigger_chain):
    def stages(chain):
        return [jsim.FilterStage(f.passband, f.filter_type, f.kwargs) for f in chain]
    return jsim.Simulation(
        path, convert.DIPOLE_DETECTOR, config=port.config,
        filter_chain=stages(port.filter_chain), triggers=_ladder(jsim.TriggerSpec),
        trigger_filter_chain=stages(trigger_chain) if trigger_chain else None,
        antenna_replacements=REPLACE, chunk_size=512, dtype=jnp.float64)


@pytest.mark.parametrize("case", list(CASES))
def test_simulation_matches_jax(small_input, case):
    config, separate = CASES[case]
    chain = convert.narrow_trigger_chain() if separate else None
    port = _port(small_input, config, triggers=_ladder(TriggerSpec),
                 trigger_filter_chain=chain)
    ref = _jax(small_input, port, chain)
    assert port.settings.n_windows == ref.settings.n_windows == (2 if case == "n_windows_2" else 1)
    assert port.settings.focusing_mode == ref.settings.focusing_mode
    assert port.settings.askaryan_model == ref.settings.askaryan_model
    np.testing.assert_allclose(port.Vrms_trigger, ref.Vrms_trigger, rtol=1e-12)
    np.testing.assert_allclose(port.bandwidth_trigger, ref.bandwidth_trigger, rtol=1e-12)
    assert (port.Vrms_trigger < port.Vrms) == separate
    res, res_ref = port.run(), ref.run()
    assert res["trigger_names"] == res_ref["trigger_names"]
    mt = res_ref["multiple_triggers"]
    assert mt.shape == (400, 8) and mt[:, 0].sum() > mt[:, -1].sum() > 0
    np.testing.assert_array_equal(res["multiple_triggers"], mt)
    np.testing.assert_array_equal(res["triggered"], res_ref["triggered"])
    for name, veff in res_ref["veff_per_trigger"].items():
        np.testing.assert_allclose(res["veff_per_trigger"][name], veff, rtol=1e-12)
    np.testing.assert_allclose(res["trigger_times_per_trigger"][mt],
                               res_ref["trigger_times_per_trigger"][mt], rtol=1e-8)
    # a refracted ray's numeric focusing factor is a difference quotient at
    # its turning point (5e-3, tests/test_torch_pa_ops.py states why)
    np.testing.assert_allclose(res["max_amplitude"], res_ref["max_amplitude"],
                               rtol=5e-3 if case == "numeric_focusing" else 2e-4)


def test_identical_trigger_chain_is_noop(small_input):
    trig = TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0)
    sim0 = _port(small_input, trigger=trig)
    sim1 = _port(small_input, trigger=trig, trigger_filter_chain=sim0.filter_chain)
    assert sim1.Vrms_trigger == sim1.Vrms
    assert sim1.channel_params.trigger_filter_response is not None
    res0, res1 = sim0.run(), sim1.run()
    assert res0["triggered"].sum() > 0
    np.testing.assert_array_equal(res0["triggered"], res1["triggered"])
    np.testing.assert_allclose(res0["trigger_times"], res1["trigger_times"], rtol=0, atol=0)
    np.testing.assert_allclose(res0["max_amplitude"], res1["max_amplitude"], rtol=0, atol=0)


def test_distinct_trigger_chain_matches_reference():
    golden = np.load(GOLDEN)
    sim = _port(str(INPUT_1E18_N3000), trigger_filter_chain=convert.narrow_trigger_chain(),
                trigger=TriggerSpec(name="highlow_trigchain", threshold_high_sigma=2.0,
                                    threshold_low_sigma=-2.0))
    res = sim.run()
    np.testing.assert_allclose(sim.Vrms_trigger, float(golden["vrms_trigger"]), rtol=1e-9)
    assert sim.bandwidth_trigger < sim.bandwidth
    mine = set(res["group_ids"][res["triggered"] & (res["weights"] >= 1e-5)])
    ref = set(np.unique(golden["group_ids"]))
    assert mine == ref, (sorted(mine - ref), sorted(ref - mine))


def test_filter_stage_is_the_ports_own():
    chain = convert.narrow_trigger_chain()
    assert all(isinstance(f, FilterStage) for f in chain)
    assert [f.passband for f in chain] == [(120 * units.MHz, 1000 * units.GHz),
                                           (0, 300 * units.MHz)]
