"""The port's example studies (examples 03, 04, 06, 07, 08, 12 and 14), each
held to its JAX example on the CPU.

Each port module (``nuradiomc_tpu_torch.examples``) runs with
``device="cpu"`` at ``tests/test_examples.py``'s small argv or smaller. The
JAX side runs in this process: the JAX example script itself with ``runpy``
in a temporary directory (03, 08, 12, 14), or a copy of the script in one
where the script writes beside itself (06 its event list, 07 its curve).
Example 04's JAX chain (half a minute even at a coarse search) is computed once, in
tests/test_torch_reco_chain.py, which holds the example module to it.
Tolerances:

* deterministic outputs (03, 04, 08's round trip, 12, the set-ups of 07
  and 14, 06's readout event): equal, or at rtol 1e-9 (of each trace's
  peak for traces);
* noisy runs: triggered counts (06) and each per-SNR efficiency (07, 14)
  within 4 binomial standard deviations of the JAX example's (the
  difference of two independent fractions, sigma = sqrt(2 p (1 - p) / n)
  at the pooled p, at least 1 / n; 14's port trials at the JAX run's
  threshold);
* 14's SNR50: within 0.3 of the JAX transform's on the same noise draws (the
  port's, handed to the JAX function), where the two agree exactly. Two
  independent runs differ by more (0.52 in zone 2 at 120 trials, measured):
  the example sets its threshold at the 0.999 quantile of 256 noise-only
  traces, whose spread alone moves SNR50 by 0.2-0.25 from run to run.
"""

import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.reco import rnog_data as jrnog_data
from nuradiomc_tpu_torch.examples.e06_rno_g_station import run_rnog_station as e06
from nuradiomc_tpu_torch.examples.e07_snr_curves import run_snr_curves as e07
from nuradiomc_tpu_torch.examples.e14_alias_phased_array import run_alias_snr as e14
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.reco import rnog_data as trnog_data

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_example_runs import EX, run_jax, run_port  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")


def of_peak(a, b):
    """Largest |a - b| over the peak of |b|."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def assert_fractions(p_mine, p_ref, n):
    """Each pair of fractions of ``n`` trials within 4 binomial sigma."""
    p = (np.asarray(p_mine) + np.asarray(p_ref)) / 2
    sigma = np.maximum(np.sqrt(2 * p * (1 - p) / n), 1.0 / n)
    assert np.all(np.abs(np.asarray(p_mine) - np.asarray(p_ref)) <= 4 * sigma), (p_mine, p_ref)


# ---- 03: the simple reconstruction chain -------------------------------------

def test_reconstruction_example(tmp_path):
    mine, text = run_port("e03", [], tmp_path)
    g, jtext = run_jax("03_reconstruction/simple_reconstruction.py", [], tmp_path)
    assert "reconstructed efield" in text and "reconstructed efield" in jtext
    for cid, (amp, snr) in mine["channels"].items():
        ch = g["station"].get_channel(cid)
        np.testing.assert_allclose(amp, ch[g["par"].channelParameters.maximum_amplitude],
                                   rtol=1e-9)
        np.testing.assert_allclose(snr, ch[g["par"].channelParameters.SNR]["peak_amplitude"],
                                   rtol=1e-9)
        assert of_peak(mine["traces"][cid], ch.get_trace()) <= 1e-9
    ref = np.asarray(g["rec_ef"].get_frequency_spectrum())
    for row, ref_row in zip(mine["spectrum"], ref):
        if np.any(ref_row != 0):
            assert of_peak(row, ref_row) <= 1e-9


# ---- 04: vertex, direction and energy ---------------------------------------

def test_vertex_direction_example(tmp_path):
    """Example 04 at the registry's quick search (20 m tables, tests/
    test_torch_reco_chain.py's settings): the lines the JAX script prints and
    finite fits. The JAX package's chain at these settings on the same event
    is computed once, in tests/test_torch_reco_chain.py, which holds this
    module's fits to it (``test_example_module_equals_the_jax_chain``)."""
    from nuradiomc_tpu_torch.examples import EXAMPLES

    mine, text = run_port("e04", EXAMPLES["e04"][1], tmp_path)
    assert "vertex:" in text and "log10 shower energy" in text
    assert np.all(np.isfinite(mine["vertex"])) and np.all(np.isfinite(mine["direction"]))


# ---- 06: the RNO-G station -----------------------------------------------------

N06 = 120             # tests/test_examples.py's count


@pytest.fixture(scope="module")
def rnog(tmp_path_factory):
    """The port's example and a copy of the JAX script, run in a temporary
    directory (the script writes its event list beside itself)."""
    jdir = tmp_path_factory.mktemp("rnog_jax")
    script = shutil.copy(os.path.join(EX, "06_rno_g_station", "run_rnog_station.py"), jdir)
    return (run_port("e06", [str(N06)], tmp_path_factory.mktemp("rnog")),
            run_jax(script, [str(N06)], jdir))


def test_rnog_station_example(rnog):
    (mine, text), (g, jtext) = rnog
    for line in ("deep PA:", "FLOWER board", "surface trigger fired: True",
                 "hit filter -> True"):
        assert line in text and line in jtext
    ref = g["results"]
    n = len(ref["group_ids"])
    assert len(mine["results"]["group_ids"]) == n
    p = (mine["n_triggered"] + ref["n_triggered"]) / (2 * n)
    sigma = max(np.sqrt(2 * n * p * (1 - p)), 1.0)
    assert abs(mine["n_triggered"] - ref["n_triggered"]) <= 4 * sigma


def test_rnog_readout_chain_equals_jax(rnog):
    (mine, _), (g, _) = rnog
    np.testing.assert_allclose(mine["eq_vrms"], np.asarray(g["eq_vrms"]), rtol=1e-9)
    assert mine["surface_fired"] == g["fired"]
    assert mine["hit_filter"] == g["passed"]
    for c, a in enumerate(mine["traces"]):
        assert of_peak(a, np.asarray(g["st"].get_channel(c).get_trace())) <= 1e-9


def test_hit_filter_on_the_phased_array_channels_alone():
    """A station holding only channels 0-3 (the example's readout event):
    the reference reads the other groups' channels only for an event with a
    single coincident PA pair, so the filter runs on it; the port's batched
    filter indexed them for every event and raised IndexError."""
    evt_j, st_j = e06.readout_event(jev)
    evt_t, st_t = e06.readout_event(tev)
    ref = jrnog_data.stationHitFilter()
    mine = trnog_data.stationHitFilter(device="cpu")
    assert mine.run(evt_t, st_t) == ref.run(evt_j, st_j)
    assert mine.passed_time_checker == ref.passed_time_checker
    assert mine.passed_hit_checker == ref.passed_hit_checker


# ---- 07: SNR curves ---------------------------------------------------------

N07 = 60              # tests/test_examples.py's count


def test_snr_curves_example(tmp_path):
    mine, text = run_port("e07", [str(N07)], tmp_path / "port")
    assert "threshold tuned" in text and "saved snr_curve.npz" in text
    assert (tmp_path / "port" / "snr_curve.npz").exists()
    # a copy of the JAX script: it writes its curve beside itself
    script = shutil.copy(os.path.join(EX, "07_snr_curves", "run_snr_curves.py"), tmp_path)
    g, jtext = run_jax(script, [str(N07)], tmp_path)
    assert "threshold tuned" in jtext
    t_signal, t_band, t_amp, t_rolls, _ = e07.study_setup()
    assert of_peak(t_signal, g["signal"]) <= 1e-9
    np.testing.assert_allclose(t_band, g["band"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(t_amp, g["amp"], rtol=1e-9)
    np.testing.assert_array_equal(t_rolls, g["rolls"])
    assert_fractions(mine["efficiency"], g["eff"], N07)


# ---- 08: the .nur round trip ----------------------------------------------------

def test_interop_example(tmp_path):
    mine, text = run_port("e08", ["100"], tmp_path)
    g, jtext = run_jax("08_interop/run_interop.py", ["100"], tmp_path)
    assert "interop roundtrip OK" in text and "interop roundtrip OK" in jtext
    ref = g["res"]
    res = mine["results"]
    np.testing.assert_array_equal(res["triggered"], ref["triggered"])
    np.testing.assert_allclose(res["veff"], ref["veff"], rtol=1e-6)
    assert mine["n_exported"] == len(g["events"]) and mine["n_refired"] == g["n_trig"]
    # the round trip: the events read back from NuRadioReco's format equal
    # the port's own file's
    from nuradiomc_tpu_torch.sim import io_nur

    back = list(io_nur.EventReader(str(tmp_path / "events_reference_format.nur")).run())
    assert [e.get_id() for e in back] == [e.get_id() for e in mine["events"]]
    for a, b in zip(back, mine["events"]):
        sa, sb = a.get_station(101), b.get_station(101)
        for ca, cb in zip(sa.iter_channels(), sb.iter_channels()):
            assert ca.get_id() == cb.get_id()
            np.testing.assert_array_equal(ca.get_trace(), cb.get_trace())
    # and the JAX example's events' traces, within 5e-4 of each trace's
    # peak: the two packages' closed-form ray solutions differ near a
    # refracted ray's turning point (ROADMAP.md, properties of the reference;
    # tests/test_torch_nur_output.py's rule)
    for a, b in zip(mine["events"], g["events"]):
        assert a.get_id() == b.get_id()
        for ca, cb in zip(a.get_station(101).iter_channels(),
                          b.get_station(101).iter_channels()):
            assert of_peak(ca.get_trace(), cb.get_trace()) <= 5e-4


# ---- 12: sensitivities ----------------------------------------------------------

def test_sensitivities_example(tmp_path):
    mine, text = run_port("e12", [], tmp_path)
    g, jtext = run_jax("12_sensitivities/E2_fluxes.py", [], tmp_path)
    assert "expected TA-GZK (ICRC2021) events:" in text
    assert mine["figure"] and (tmp_path / "sensitivity.png").exists()
    assert 0.01 < mine["n_gzk"] < 100
    np.testing.assert_allclose(mine["n_gzk"], float(np.sum(g["n_gzk"])), rtol=1e-9)
    np.testing.assert_allclose(mine["limit"], g["limit"], rtol=1e-9)


# ---- 14: the aliased phased array ---------------------------------------------

N14 = 40              # tests/test_examples.py's count


@pytest.fixture(scope="module")
def alias(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("alias")
    port = run_port("e14", [str(N14)], tmp)
    g, jtext = run_jax("14_alias_phased_array/run_alias_snr.py", [str(N14)], tmp)
    # the JAX example's chain, one compile for every zone: the zone mask is
    # an argument
    power = jax.jit(jax.vmap(g["_max_beam_power"], in_axes=(0, None)))
    return port, (g, jtext), power


def test_alias_example(alias):
    """The port's study against the JAX example's run: each zone's
    efficiencies within 4 binomial sigma, the port's trials taken at the
    JAX run's threshold (as printed), which keeps the threshold's own spread
    out of the band."""
    (mine, text), (g, jtext), _ = alias
    assert "alias phased-array study done" in text and "alias phased-array study done" in jtext
    assert mine["snr50"][2] < 4.5 and mine["snr50"][3] < 4.5
    thresholds = {int(z): float(t) for z, t in
                  re.findall(r"Nyquist zone (\d): threshold=([0-9.e+-]+) V\^2", jtext)}
    assert sorted(thresholds) == [1, 2, 3]
    for z in (1, 2, 3):
        assert_fractions((mine["max_power"][z] > thresholds[z]).mean(axis=0), g["results"][z],
                         N14)


@pytest.mark.parametrize("z", [1, 2, 3])
def test_alias_zone_on_the_same_noise(alias, z):
    """The port's zone chain against the JAX example's ``_max_beam_power``
    on the port's noise draws: the same maxima, threshold and SNR50."""
    _, (g, _), power = alias
    signal, analog, _, rolls, base_factor = e14.study_setup()
    assert of_peak(signal, np.asarray(g["signal"])) <= 1e-9
    np.testing.assert_array_equal(rolls, np.asarray(g["rolls"]))
    trials, noise = e14.draws(z, N14, CPU, torch.float64)
    max_power, noise_powers = e14.zone_powers(z, trials, noise)
    ff = np.asarray(g["ff"])
    lo = (z - 1) * g["fs_adc"] / 2 + g["bandwidth_edge"]
    hi = z * g["fs_adc"] / 2 - g["bandwidth_edge"]
    mask = jnp.asarray(((ff >= lo) & (ff <= hi)) * np.asarray(g["analog"]))
    sig = np.asarray(g["signal"])
    batch = np.concatenate([sig * (s * base_factor) + trials.numpy() for s in e14.SNRS]
                           + [noise.numpy()])
    ref_all = np.asarray(power(jnp.asarray(batch), mask))
    n = N14 * len(e14.SNRS)
    ref = ref_all[:n].reshape(len(e14.SNRS), N14).T
    ref_noise = ref_all[n:]
    np.testing.assert_allclose(max_power.numpy(), ref, rtol=1e-9)
    np.testing.assert_allclose(noise_powers.numpy(), ref_noise, rtol=1e-9)
    eff, thr = e14.efficiency(max_power.numpy(), noise_powers.numpy())
    ref_eff = (ref > np.quantile(ref_noise, 0.999)).mean(axis=0)
    np.testing.assert_array_equal(eff, ref_eff)
    s_mine, s_ref = e14.snr50(eff), e14.snr50(ref_eff)
    assert s_mine == s_ref or abs(s_mine - s_ref) <= 0.3
