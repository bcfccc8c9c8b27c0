"""The port's batch builder on the CPU: the split of groups into sub-events
by vertex time, and ``Simulation._build_batches`` held to the JAX package's.

* ``_split_sub_events`` (every group at once) against
  ``evtgen.group_into_events`` applied one group at a time, as the batch
  builder of the JAX package does: random lists with single-shower groups,
  multi-time groups, equal and NaN times and steps of 0.5, 1e6 and 1e7 ns
  about the gaps 0.5 / 1e6 / 1e7; a list with no group of more than one
  shower; a one-row list. ``order``, ``start``, ``count`` and ``group_ids``
  equal, with the same dtypes.
* ``_build_batches`` of the port against the JAX package's on the tau list
  (secondaries; at ``split_event_time_diff`` 1e3 ns groups really split),
  Alvarez2009 and Alvarez2000, and on the phased-array list (Alvarez2009):
  the grouping, every padded ``ShowerBatch`` array (``k_L`` where the
  model is Alvarez2009: the port draws it only there) and the Alvarez2009
  realizations bit for bit; the counter ``batch.sub_events`` reads the
  sub-events the split adds (0 on a list without secondaries).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.sim import simulation as jsim
from nuradiomc_tpu.utils import units
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.sim import io_input
from nuradiomc_tpu_torch.sim.evtgen import group_into_events
from nuradiomc_tpu_torch.sim.simulation import _group_showers, _split_sub_events
from nuradiomc_tpu_torch.utils import timing

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAPS = (0.5, 1e6, 1e7)


def _split_per_group(group_ids, start, count, order, times, gap):
    """The JAX package's loop over groups (nuradiomc_tpu/sim/simulation.py
    _build_batches), with the port's ``group_into_events``."""
    if not np.any(count > 1):
        return group_ids, start, count, order
    new_order, new_start, new_count, new_gids = [], [], [], []
    pos = 0
    for g in range(len(group_ids)):
        rows = order[start[g]:start[g] + count[g]]
        sub = group_into_events(times[rows], gap)
        for s_idx in np.unique(sub):
            sel = rows[sub == s_idx]
            new_order.append(sel)
            new_start.append(pos)
            new_count.append(len(sel))
            new_gids.append(group_ids[g])
            pos += len(sel)
    return (np.asarray(new_gids, dtype=group_ids.dtype),
            np.asarray(new_start, dtype=start.dtype),
            np.asarray(new_count, dtype=count.dtype), np.concatenate(new_order))


def _random_list(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(200, 400))
    gids = rng.integers(0, n // 2, n) * 7 - 11     # most groups hold several showers
    base = rng.choice([0.0, 0.0, 3.0, 1e6, 2e6, 1.2e7, np.nan, -0.0], n)
    times = base + rng.choice([0.0, 0.0, 0.5, 0.25, 1e6, 1e7], n)
    return gids, times


CASES = {f"random_{seed}": (lambda seed=seed: _random_list(seed)) for seed in range(4)}
CASES["single_shower_groups"] = lambda: (np.random.default_rng(5).permutation(300) + 1,
                                         np.random.default_rng(6).uniform(0, 1e8, 300))
CASES["one_row"] = lambda: (np.array([42]), np.array([7.0]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_matches_per_group_loop(case):
    gids, times = CASES[case]()
    grouped = _group_showers(gids)
    split_somewhere = False
    for gap in GAPS:
        want = _split_per_group(*grouped, times, gap)
        got = _split_sub_events(*grouped, times, gap)
        for name, a, b in zip(("group_ids", "start", "count", "order"), want, got):
            assert a.dtype == b.dtype, (name, gap)
            np.testing.assert_array_equal(b, a, err_msg=f"{name} gap {gap}")
        split_somewhere |= len(want[0]) > len(grouped[0])
    assert split_somewhere == case.startswith("random")


def _gen2(signal_model, split_gap):
    cfg = {**convert.GEN2_CONFIG, "split_event_time_diff": split_gap,
           "signal": {"model": signal_model}}
    ref = jsim.Simulation(
        os.path.join(ROOT, ".bench_cache", "gen2_taus_2048_seed21.hdf5"), convert.GEN2_DETECTOR,
        config=cfg,
        filter_chain=[jsim.FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
                      jsim.FilterStage((0, 500 * units.MHz), "butter", {"order": 10})],
        trigger=jsim.TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
        dtype=jnp.float64)
    return ref, convert.gen2_simulation(io_input.INPUT_GEN2, cfg, device="cpu",
                                        dtype=torch.float64)


def _pa():
    port = convert.pa_simulation(io_input.INPUT_1E18_N3000, device="cpu", dtype=torch.float64)
    ref = jsim.Simulation(os.path.join(ROOT, "tests", "data", "1e18_n3000.hdf5"),
                          convert.PA_DETECTOR, config=port.config,
                          filter_chain=[jsim.FilterStage(f.passband, f.filter_type, f.kwargs)
                                        for f in port.filter_chain],
                          trigger=jsim.TriggerSpec(trigger_type="phased_array"),
                          antenna_replacements={"RNOG_vpol_v1_n1.73": "analytic_VPol"},
                          dtype=jnp.float64)
    return ref, port


SIMULATIONS = {
    "gen2_split_alvarez2009": lambda: _gen2("Alvarez2009", 1e3),
    "gen2_split_alvarez2000": lambda: _gen2("Alvarez2000", 1e3),
    "gen2_default_gap_alvarez2000": lambda: _gen2("Alvarez2000", 1e6),
    "pa_alvarez2009": _pa,
}


@pytest.mark.parametrize("name", sorted(SIMULATIONS))
def test_build_batches_match_jax(name):
    ref, port = SIMULATIONS[name]()
    timing.enable(False)
    timing.take()
    try:
        timing.enable()
        got = port._build_batches()
        counters = timing.take()["counters"]
    finally:
        timing.enable(False)
        timing.take()
    want = ref._build_batches()
    for label, a, b in zip(("group_ids", "start", "count", "order"), want[:4], got[:4]):
        a = np.asarray(a)
        assert a.dtype == b.dtype, label
        np.testing.assert_array_equal(b, a, err_msg=label)
    jb, tb = want[-1], got[-1]
    for field in jb._fields:
        a, b = getattr(jb, field), getattr(tb, field)
        if a is None:                   # profile_idx (ARZ), emitter_polarization
            assert b is None, field
            continue
        if field == "k_L" and "alvarez2009" not in name:
            continue                        # drawn by the JAX package alone
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(b, a, err_msg=field)
    assert port._realizations.keys() == ref._realizations.keys()
    for key, a in ref._realizations.items():
        assert port._realizations[key].dtype == a.dtype, key
        np.testing.assert_array_equal(port._realizations[key], a, err_msg=key)
    if "alvarez2009" in name:
        assert "shower_realization_Alvarez2009" in port._realizations

    # the sub-events the split adds, counted one group at a time
    inp = port.input
    gids, start, count, order = _group_showers(inp.event_group_ids)
    gap = float(port.config["split_event_time_diff"])
    extra = sum(int(group_into_events(inp.vertex_times[order[s:s + c]], gap).max())
                for s, c in zip(start, count))
    assert extra == len(got[0]) - len(gids)
    assert [c["batch.sub_events"] for c in counters.values()] == [extra]
    assert (extra > 0) == ("split" in name)
