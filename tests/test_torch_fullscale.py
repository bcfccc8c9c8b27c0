"""NuRadioMC's production-scale campaign (test/Veff/1e18eV, T01 -> T02 ->
T03) through the port on the CPU, cut to the groups that decide it.

The port generates the seed-10 50,000-event list itself (its digest is the
golden's ``input_sha1``, tests/test_torch_evtgen.py). The golden's 203
triggered groups plus 300 untriggered groups drawn with a fixed seed run
through ``convert.fullscale_simulation`` in float64: the triggered set must
equal the golden's and the golden's per-group weights must match at rtol
1e-6. Then the campaign's last step: the port's ``veff.get_Veff_Aeff`` on the
port's output HDF5 equals the JAX package's ``veff`` on the output of the JAX
``Simulation`` of the same groups. The whole 50,000-event campaign on the
card is ``chip_smoke.py`` phase 10.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.sim import veff as jveff
from nuradiomc_tpu.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu.utils import units
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim import io_input
from nuradiomc_tpu_torch.sim import veff as tveff
from torch_port_inputs import write_input_hdf5

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "veff_fullscale_reference.npz")
MIN_W = 1e-5
N_UNTRIGGERED = 300


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def campaign(golden, tmp_path_factory):
    """The cut campaign: its input, the port's results and output file."""
    data, attrs = convert.fullscale_event_list()
    full = io_input.from_generated(data, attrs)
    triggered = np.unique(golden["group_ids"][golden["triggered"]])
    rest = np.setdiff1d(np.unique(full.event_group_ids), golden["group_ids"])
    drawn = np.random.default_rng(2026).choice(rest, N_UNTRIGGERED, replace=False)
    inp = io_input.select(full, np.concatenate([triggered, drawn]))
    out = str(tmp_path_factory.mktemp("fullscale") / "port.hdf5")
    res = convert.fullscale_simulation(inp, device="cpu", dtype=torch.float64,
                                       outputfilename=out).run()
    return inp, res, out


def test_cut_holds_the_golden_groups(golden, campaign):
    inp, _, _ = campaign
    triggered = np.unique(golden["group_ids"][golden["triggered"]])
    assert len(triggered) == int(golden["n_triggered"]) == 203
    rows = np.isin(inp.event_group_ids, triggered)
    assert len(np.unique(inp.event_group_ids)) == 203 + N_UNTRIGGERED
    assert rows.sum() >= 203


def test_triggered_set_equals_the_golden(golden, campaign):
    _, res, _ = campaign
    mine = set(res["group_ids"][res["triggered"] & (res["weights"] >= MIN_W)].tolist())
    ref = set(np.unique(golden["group_ids"][golden["triggered"]]).tolist())
    assert mine == ref, (len(mine), len(ref), sorted(mine ^ ref)[:20])


def test_weights_equal_the_golden(golden, campaign):
    _, res, _ = campaign
    gid = golden["group_ids"]
    _, first = np.unique(gid, return_index=True)
    ref_w = dict(zip(gid[first].tolist(), golden["weights"][first]))
    mine = dict(zip(res["group_ids"].tolist(), res["weights"]))
    ids = sorted(set(ref_w) & set(mine))
    assert len(ids) >= 203
    np.testing.assert_allclose([mine[g] for g in ids], [ref_w[g] for g in ids], rtol=1e-6)
    # Veff of the whole campaign from the triggered groups' weights
    sel = res["triggered"] & (res["weights"] >= MIN_W)
    veff = (float(golden["volume"]) * 4 * np.pi * res["weights"][sel].sum()
            / int(golden["n_events"]))
    np.testing.assert_allclose(veff, float(golden["veff"]), rtol=1e-6)


def _jax_campaign(inp, path_in, path_out):
    write_input_hdf5(inp, path_in)
    return Simulation(
        path_in, convert.DIPOLE_DETECTOR,
        config={"sampling_rate": 2.0, "propagation": {"ice_model": "southpole_2015"},
                "signal": {"model": "Alvarez2000"},
                "weights": {"weight_mode": "core_mantle_crust_simple",
                            "cross_section_type": "ctw"}},
        filter_chain=[FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
                      FilterStage((0, 500 * units.MHz), "butter", {"order": 10})],
        trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
        antenna_replacements={"XFDTD_Vpol_CrossFeed_150mmHole_n1.78": "analytic_VPol"},
        chunk_size=512, dtype=jnp.float64, outputfilename=path_out).run()


def _assert_close(a, b, where="veff"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_close(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{where}[{i}]")
    elif isinstance(a, (str, bytes)) or a is None or np.asarray(a).dtype.kind in "OSUb":
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        np.testing.assert_allclose(np.asarray(a, dtype=float), np.asarray(b, dtype=float),
                                   rtol=1e-9, err_msg=where)


def test_veff_tables_equal_the_jax_package(campaign, tmp_path):
    inp, res, port_out = campaign
    jax_out = str(tmp_path / "jax.hdf5")
    jres = _jax_campaign(inp, str(tmp_path / "in.hdf5"), jax_out)
    np.testing.assert_array_equal(jres["triggered"], res["triggered"])
    mine = tveff.get_Veff_Aeff([port_out])
    theirs = jveff.get_Veff_Aeff([jax_out])
    _assert_close(mine, theirs)
    assert mine[0]["n_triggered"] == 203
    arr, *_ = tveff.get_Veff_Aeff_array(mine)
    jarr, *_ = jveff.get_Veff_Aeff_array(theirs)
    np.testing.assert_allclose(arr, jarr, rtol=1e-9)
