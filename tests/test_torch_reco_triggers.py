"""The port's trigger ops, trigger modules and RNO-G modules against the
JAX package's, on the CPU in float64. Decisions, trigger bins, trigger times
and triggered channels are exactly equal; continuous outputs (the tunnel
diode's power trace, per-beam maximum powers) agree at rtol 1e-10.

* ops: envelope, multi high/low, tunnel diode and ARA diode,
  power integration and the phased envelope trigger on the traces of
  tests/golden/triggers2.npz and on seeded noise with a coherent pulse;
* modules: the simple, high/low, multi high/low and beamformed
  power-integration triggers on the ten events of
  tests/golden/trigger_test_input.nur (read by each package's own reader)
  with its detector, at thresholds that leave the decisions mixed;
* RNO-G: the Schottky diode, the surface trigger bins and
  module, the noise estimate, the gain choice and the trigger board.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.detector.detector import Detector as JDetector
from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.ops import phased_array as jpa
from nuradiomc_tpu.ops import triggers as jtrig
from nuradiomc_tpu.reco import rnog as jrnog
from nuradiomc_tpu.reco import trigger_modules as jtm
from nuradiomc_tpu.sim import io_nur as jnur
from nuradiomc_tpu_torch.detector.detector import Detector as TDetector
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.ops import phased_array as tpa
from nuradiomc_tpu_torch.ops import triggers as ttrig
from nuradiomc_tpu_torch.reco import rnog as trnog
from nuradiomc_tpu_torch.reco import trigger_modules as ttm
from nuradiomc_tpu_torch.sim import io_nur as tnur
from nuradiomc_tpu_torch.utils import units

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TRACES = np.load(os.path.join(GOLDEN, "triggers2.npz"))["traces"]


def _eq(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("op", ["envelope", "multi_high_low", "power_integration",
                                "ara_diode", "shift"])
def test_trigger_ops_match(op):
    t, j = torch.as_tensor(TRACES), jnp.asarray(TRACES)
    if op == "envelope":
        _eq(ttrig.get_envelope_triggers(t, 2.5), jtrig.get_envelope_triggers(j, 2.5))
    elif op == "multi_high_low":
        for nc, n in ((20.0, 3), (5.0, 2), (40.0, 4)):
            _eq(ttrig.get_multiple_high_low_triggers(t, 2.0, -2.0, n, nc, 1.0),
                jtrig.get_multiple_high_low_triggers(j, 2.0, -2.0, n, nc, 1.0))
    elif op == "power_integration":
        for window in (3.0, 10.0):
            _eq(ttrig.power_integration_triggers(t, window, 15.0, 1.0),
                jtrig.power_integration_triggers(j, window, 15.0, 1.0))
    elif op == "ara_diode":
        got = ttrig.tunnel_diode(t * 1e-4, 1.0).numpy()
        ref = np.asarray(jtrig.tunnel_diode(j * 1e-4, 1.0))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10 * np.max(np.abs(ref)))
        mean, std = float(np.mean(ref)), float(np.std(ref))
        _eq(ttrig.ara_diode_trigger(t * 1e-4, 1.0, mean, std, 1.5),
            jtrig.ara_diode_trigger(j * 1e-4, 1.0, mean, std, 1.5))
        np.testing.assert_allclose(ttrig.tunnel_diode_response(torch.linspace(0, 100, 101,
                                                                              dtype=torch.float64)),
                                   jtrig.tunnel_diode_response(jnp.linspace(0, 100, 101)),
                                   rtol=1e-12, atol=1e-15)
    else:
        for s in (1, 7):
            _eq(ttrig._shift_right_zero(t, s), jtrig._shift_right_zero(j, s))


def test_phased_envelope_trigger_matches():
    rng = np.random.default_rng(2)
    C, N = 4, 1024
    t = np.arange(N)
    pulse = 0.2 * np.exp(-0.5 * ((t - 500) / 4.0) ** 2) * np.sin(0.4 * t)
    batch = np.stack([rng.normal(0, 0.01, (C, N)) + pulse * (k % 2) for k in range(6)])
    rolls = np.array([[0, 0, 0, 0], [0, 3, 6, 9], [0, -3, -6, -9]])
    for thr in (0.3, 0.5):
        for n_trig in (False, True):
            got = tpa.phased_envelope_trigger(torch.as_tensor(batch), rolls, thr, n_trig)
            ref = jpa.phased_envelope_trigger(jnp.asarray(batch), rolls, thr, n_trig)
            for a, b in zip(got, ref):
                _eq(a, b)
    assert bool(got[0].any()) and not bool(got[0].all())


# ---- the trigger modules on NuRadioReco's trigger_test_input.nur ------------

DET_FILE = os.path.join(GOLDEN, "trigger_test_detector.json")


def _events(nur):
    return list(nur.EventReader(os.path.join(GOLDEN, "trigger_test_input.nur")).run())


def _run_modules(tm, events, det, kw):
    simple = tm.triggerSimulatorSimple(**kw)
    high_low = tm.triggerSimulatorHighLow(**kw)
    multi = tm.triggerSimulatorMultiHighLow(**kw)
    phased = tm.BeamformedPowerIntegrationTrigger(**kw)
    phased.begin()
    out = []
    for event in events:
        station = event.get_station(1)
        simple.run(event, station, det, threshold=0.15 * units.mV, number_concidences=2)
        high_low.run(event, station, det, threshold_high=0.12 * units.mV,
                     threshold_low=-0.12 * units.mV)
        multi.run(event, station, det, trigger_name="default_multi_high_low",
                  threshold_high=0.1 * units.mV, threshold_low=-0.1 * units.mV,
                  n_high_lows=2)
        phased.run(event, station, det, Vrms=0.02 * units.mV, threshold=1.5e-8)
        phased.run(event, station, det, trigger_name="phased_upsampled",
                   threshold=3e-8, apply_digitization=False, upsampling_factor=2)
        row = {}
        for name, trig in station.get_triggers().items():
            tt = trig.get_trigger_time()
            times = getattr(trig, "_trigger_times", None)
            row[name] = (bool(trig.has_triggered()), tt,
                         None if times is None else np.asarray(times),
                         list(trig.get_triggered_channels() or []),
                         getattr(trig, "_maximum_amps", None))
        out.append((row, {k.name: v for k, v in station.get_parameters().items()}))
    return out


def test_trigger_modules_match_on_reference_events():
    ref = _run_modules(jtm, _events(jnur), JDetector(DET_FILE), {})
    got = _run_modules(ttm, _events(tnur), TDetector(DET_FILE), {"device": "cpu"})
    n_fired = {}
    for (a, pa), (b, pb) in zip(got, ref):
        assert sorted(a) == sorted(b) and sorted(pa) == sorted(pb)
        for key in pb:
            np.testing.assert_allclose(pa[key], pb[key], rtol=1e-12)
        for name in b:
            (fa, ta, tsa, ca, ma), (fb, tb, tsb, cb, mb) = a[name], b[name]
            assert (fa, ta, ca) == (fb, tb, cb), name
            if tsb is not None:
                _eq(tsa, tsb)
            if mb is not None:
                np.testing.assert_allclose(ma, mb, rtol=1e-10)
            n_fired[name] = n_fired.get(name, 0) + fb
    # the thresholds leave the decisions of every trigger run here mixed over
    # the ten events (the file's own "simple_threshold" fired in all ten)
    assert n_fired.pop("simple_threshold") == 10
    assert len(n_fired) == 5 and all(0 < n < 10 for n in n_fired.values()), n_fired


# ---- RNO-G ------------------------------------------------------------------

def _rnog_det_dict():
    chans = {}
    for cid in (13, 16, 19):
        chans[str(cid)] = {
            "adc_n_samples": 1024, "adc_sampling_frequency": 2.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": 180.0,
            "ant_position_x": float(cid), "ant_position_y": 0.0,
            "ant_position_z": -2.0, "ant_rotation_phi": 90.0,
            "ant_rotation_theta": 90.0, "ant_type": "analytic_LPDA",
            "amp_type": "", "cab_time_delay": 0.0, "adc_nbits": None,
            "channel_id": cid, "station_id": 11,
            "trigger_adc_noise_count": 2, "trigger_adc_nbits": 8,
            "trigger_adc_max_voltage": 1.0 * units.volt,
            "trigger_adc_min_voltage": -1.0 * units.volt}
    return {"channels": chans, "stations": {"1": {"station_id": 11, "pos_altitude": 0,
                                                  "pos_easting": 0, "pos_northing": 0}}}


def _rnog_station(ev, n_pulsed, seed):
    fs, n = 2.0, 1024
    rng = np.random.default_rng(seed)
    st = ev.Station(11)
    for k, cid in enumerate((13, 16, 19)):
        tr = rng.normal(0, 1e-4, n)
        if k < n_pulsed:
            t = np.arange(n) / fs
            tr = tr + 0.3 * np.exp(-0.5 * ((t - 250 - 5 * k) / 4) ** 2) * np.sin(0.8 * t)
        ch = ev.Channel(cid)
        ch.set_trace(tr, fs, trace_start_time=7.0)
        st.add_channel(ch)
    evt = ev.Event(0, n_pulsed)
    evt.set_station(st)
    return evt, st


def test_rnog_surface_trigger_matches():
    rng = np.random.default_rng(0)
    tr = rng.normal(0, 1e-3, (3, 1024))
    tr[:, 400:410] += 0.2
    _eq(trnog.surface_trigger_bins(torch.as_tensor(tr), 2.0, 1e-3).numpy(),
        jrnog.surface_trigger_bins(tr, 2.0, 1e-3))
    for T in (250, 273, 300):
        for Vb in (0.5, 1.0, 1.5, 2.0):
            _eq(trnog.schottky_diode(torch.as_tensor(tr), 1e-3, T * units.kelvin,
                                     Vb * units.volt).numpy(),
                jrnog.schottky_diode(tr, 1e-3, T * units.kelvin, Vb * units.volt))
    results = []
    for ev, mod, det, kw in ((jev, jrnog, JDetector(_rnog_det_dict()), {}),
                             (tev, trnog, TDetector(_rnog_det_dict()), {"device": "cpu"})):
        trig = mod.rnogSurfaceTrigger(**kw)
        trig.begin()
        row = []
        for n_pulsed in (0, 1, 2, 3):
            evt, st = _rnog_station(ev, n_pulsed, 1)
            trig.run(evt, st, det, threshold=5e-3, number_coincidences=2)
            t = st.get_trigger("rnog_surface_trigger")
            row.append((t.has_triggered(), t.get_trigger_time(), t.get_triggered_channels()))
        results.append(row)
    assert results[1] == results[0]
    assert [r[0] for r in results[0]] == [False, False, True, True]


def test_rnog_board_matches():
    sig = np.random.default_rng(2).normal(0, 0.8e-3, 2048)
    assert trnog.estimate_noise_vrms(sig) == jrnog.estimate_noise_vrms(sig)
    for v in (1e-9, 1e-4, 1e-3, 0.02):
        assert trnog.select_adc_gain(v, 2 * 2.0 / 255) == jrnog.select_adc_gain(v, 2 * 2.0 / 255)
    results = []
    for ev, mod, det, kw in ((jev, jrnog, JDetector(_rnog_det_dict()), {}),
                             (tev, trnog, TDetector(_rnog_det_dict()), {"device": "cpu"})):
        for output in ("voltage", "counts"):
            evt, st = _rnog_station(ev, 1, 5)
            board = mod.triggerBoardResponse(**kw)
            board.begin(adc_output=output)
            eq = board.run(evt, st, det, trigger_channels=[13, 16, 19])
            results.append((np.asarray(eq),
                            [np.asarray(st.get_channel(c).get_trace()) for c in (13, 16, 19)]))
    for (ea, ta), (eb, tb) in zip(results[2:], results[:2]):
        np.testing.assert_allclose(ea, eb, rtol=1e-12)
        for a, b in zip(ta, tb):
            _eq(a, b)


def test_cr_template_creator_names_its_roadmap_item():
    """The creator is ported (its templates against the JAX package's in
    tests/test_torch_hardware.py): it begins on the CPU when asked for and
    takes the card by default."""
    import inspect
    creator = trnog.crRNOGTemplateCreator(device="cpu")
    creator.begin("det.json", ".")
    creator.set_template_parameter()
    assert creator._params["n_samples"] == 2048
    assert inspect.signature(trnog.crRNOGTemplateCreator).parameters["device"].default == "cuda"
