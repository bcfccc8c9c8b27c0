"""Waveform output of the port: ``simulate_batch(keep_traces=True)``, the
``.nur`` writer and reader, and ``Simulation(nur_outputfilename=)``.

* ``io_nur`` round trip, and files written by either package read by the
  other with equal content (the container holds plain values only).
* ``keep_traces`` in float64 on the 7 groups of NuRadioMC's own waveform
  output (``tests/golden/e2e_reference_waveforms.nur``): traces and
  ``base_t0`` against the JAX package's, decisions as without the option.
  The limit is 1e-6 of a trace's peak where every valid ray is direct or
  reflected; where a refracted ray is valid, its arrival moves by up to
  ~1e-4 ns between two correct solvers (ROADMAP "The turning point"), which
  moves a 500 MHz band-limited pulse by up to 2 pi 0.5 GHz 1e-4 ns ~ 3e-4 of
  its peak, so the limit there is 5e-4.
* The same in float32 with the bench settings (band limit 1e-2): the traces
  carry the full base grid (K widened as the JAX package widens it).
* The traces against the reference's waveforms at 2% of peak on its readout
  grid, trigger times to 1 ns (tests/test_e2e_waveforms.py:62-105).
* ``Simulation(nur_outputfilename=)`` on the 3000-event input: the same event
  ids, trigger times (1e-3 ns) and traces as the JAX ``Simulation``'s file.

Run as a script, the file writes
``nuradiomc_tpu_torch/data/e2e_waveforms_reference.npz``: the reference's 7
traces with their start times, rate and trigger times, and the JAX package's
float64 ``keep_traces`` traces of the same groups with their limits, for
``chip_smoke.py`` phase 10, which reads no ``.nur`` file of the reference.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.framework import parameters as jpar
from nuradiomc_tpu.framework import event as jevent
from nuradiomc_tpu.sim import io_nur as jnur
from nuradiomc_tpu.sim import io_nur_reference as rio
from nuradiomc_tpu.sim import pipeline as jpipeline
from nuradiomc_tpu.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu.utils import units
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.framework import event as tevent
from nuradiomc_tpu_torch.framework import parameters as tpar
from nuradiomc_tpu_torch.framework.base_trace import BaseTrace
from nuradiomc_tpu_torch.sim import io_input
from nuradiomc_tpu_torch.sim import io_nur as tnur
from nuradiomc_tpu_torch.sim import pipeline as tpipeline

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_NUR = os.path.join(HERE, "golden", "e2e_reference_waveforms.nur")
INPUT_HDF5 = os.path.join(HERE, "data", "1e18_n3000.hdf5")
PIN = io_input.DATA_DIR / "e2e_waveforms_reference.npz"
STATION = 101
REF_TRIGGER = "highlow_2sigma"
BENCH = {"propagation": {"n_freq": 16, "attenuation_steps": 8, "n_bisect": 28},
         "perf": {"band_limit_eps": 1e-2}}
EXACT, TURNING_POINT = 1e-6, 5e-4


# ---- the .nur container ---------------------------------------------------

def _build_event(ev, par):
    """A station with two channels, a sim station, triggers, showers and
    parameters of several enums, built with package ``ev`` / ``par``."""
    rng = np.random.default_rng(5)
    event = ev.Event(3, 42)
    st = ev.Station(101)
    st[par.stationParameters.nu_energy] = 1e18
    for cid in (0, 1):
        ch = ev.Channel(cid)
        ch.set_trace(rng.normal(size=256), 1.0, trace_start_time=100.0 + cid)
        ch[par.channelParameters.maximum_amplitude] = float(cid) + 0.5
        st.add_channel(ch)
    ef = ev.ElectricField([0, 1], np.array([1.0, 2.0, -3.0]), shower_id=7, ray_tracing_id=1)
    ef.set_trace(rng.normal(size=(3, 128)), 2.0, trace_start_time=5.0)
    st.add_electric_field(ef)
    trig = ev.Trigger("highlow", [0, 1], "high_low")
    trig.set_triggered(True)
    trig.set_trigger_time(123.25)
    st.set_trigger(trig)
    ss = ev.SimStation(101)
    sc = ev.SimChannel(0, 7, 1)
    sc.set_trace(rng.normal(size=64), 2.0, trace_start_time=1.0)
    ss.add_channel(sc)
    st.set_sim_station(ss)
    event.set_station(st)
    for sid in (7, 8):
        sh = ev.Shower(sid)
        sh[par.showerParameters.energy] = 1e17 * sid
        sh[par.showerParameters.vertex] = np.array([1.0, 2.0, -100.0 * sid])
        sh[par.showerParameters.type] = "had"
        event.add_sim_shower(sh)
    return event


def _assert_same(a, b, where="event"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"),
                                           ("jax", "port"), ("jax", "jax")])
def test_nur_files_are_interchangeable(writer, reader, tmp_path):
    pkgs = {"port": (tevent, tpar, tnur), "jax": (jevent, jpar, jnur)}
    ev, par, nur = pkgs[writer]
    event = _build_event(ev, par)
    path = str(tmp_path / "events.nur")
    w = nur.EventWriter(path)
    w.run(event)
    w.run(_build_event(ev, par))
    assert w.end() == 2
    read = list(pkgs[reader][2].EventReader(path).run())
    assert len(read) == 2
    for got in read:
        _assert_same(pkgs[reader][2].event_to_dict(got), nur.event_to_dict(event))
    st = read[0].get_station(101)
    assert st.get_trigger("highlow").get_trigger_time() == 123.25
    np.testing.assert_array_equal(st.get_channel(1).get_trace(),
                                  event.get_station(101).get_channel(1).get_trace())


def test_reference_nur_raises_in_the_port():
    """The port's reader once raised on a file NuRadioReco wrote; it now
    dispatches to its ``io_nur_reference``, and reads the golden's traces bit
    for bit as the JAX package's reader does."""
    got = list(tnur.EventReader(GOLDEN_NUR).run())
    ref = list(rio.NuRadioRecoio(GOLDEN_NUR).get_events())
    assert [e.get_id() for e in got] == [e.get_id() for e in ref] and len(got) == 7
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.get_station(STATION).get_channel(0).get_trace(),
                                      b.get_station(STATION).get_channel(0).get_trace())


# ---- keep_traces on the waveform golden's groups -----------------------------

def _reference_waveforms():
    io = rio.NuRadioRecoio(GOLDEN_NUR)
    events = {int(rid): io.get_event_i(i) for i, (rid, _) in enumerate(io.get_event_ids())}
    gids = np.array(sorted(events))
    chans = [events[g].get_station(STATION).get_channel(0) for g in gids]
    fs = {float(c.get_sampling_rate()) for c in chans}
    assert len(fs) == 1
    return dict(
        group_ids=gids,
        ref_traces=np.stack([np.asarray(c.get_trace()) for c in chans]),
        ref_t0=np.array([c.get_trace_start_time() for c in chans]),
        ref_fs=fs.pop(),
        ref_trigger_times=np.array([events[g].get_station(STATION).get_trigger(REF_TRIGGER)
                                    .get_trigger_time() for g in gids]))


def _jax_simulation(dtype, config=None, **kw):
    cfg = {"sampling_rate": 2.0, "propagation": {"ice_model": "southpole_2015"},
           "signal": {"model": "Alvarez2000"},
           "weights": {"weight_mode": "core_mantle_crust_simple", "cross_section_type": "ctw"}}
    for k, v in (config or {}).items():
        cfg[k] = {**cfg.get(k, {}), **v}
    return Simulation(
        INPUT_HDF5, convert.DIPOLE_DETECTOR, config=cfg,
        filter_chain=[FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
                      FilterStage((0, 500 * units.MHz), "butter", {"order": 10})],
        trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
        antenna_replacements={"XFDTD_Vpol_CrossFeed_150mmHole_n1.78": "analytic_VPol"},
        chunk_size=512, dtype=dtype, **kw)


def _jax_keep_traces(group_ids, dtype, config=None):
    sim = _jax_simulation(dtype, config)
    gids, _, _, _, batch = sim._build_batches()
    sel = np.array([int(np.where(gids == g)[0][0]) for g in group_ids])
    sub = jax.tree.map(lambda a: a[sel] if a is not None else None, batch)
    out = jax.jit(lambda b: jpipeline.simulate_batch(
        b, sim.channel_params, sim.settings, keep_traces=True))(sub)
    return {k: np.asarray(getattr(out, k)) for k in
            ("traces", "base_t0", "triggered", "trigger_time", "max_amplitude", "sol_type",
             "sol_mask")}


def _port_keep_traces(group_ids, dtype, config=None, keep_traces=True):
    sim = convert.dipole_simulation(str(io_input.INPUT_1E18_N3000), config, chunk_size=1024,
                                    device="cpu", dtype=dtype)
    gids, _, _, _, batch = sim._build_batches()
    sel = np.array([int(np.where(gids == g)[0][0]) for g in group_ids])
    sub = tpipeline.ShowerBatch(*[None if a is None else torch.as_tensor(a[sel])
                                  for a in batch])
    out = tpipeline.simulate_batch(sub, sim.channel_params, sim.settings,
                                   keep_traces=keep_traces)
    return sim, out


def _limits(sol_type, sol_mask):
    """Per group: EXACT where every valid ray is direct or reflected, else the
    turning-point bound."""
    refracted = ((sol_type == 2) & sol_mask).reshape(len(sol_mask), -1).any(axis=1)
    return np.where(refracted, TURNING_POINT, EXACT)


@pytest.fixture(scope="module")
def reference():
    return _reference_waveforms()


@pytest.fixture(scope="module")
def jax64(reference):
    return _jax_keep_traces(reference["group_ids"], jnp.float64)


@pytest.fixture(scope="module")
def port64(reference):
    return _port_keep_traces(reference["group_ids"], torch.float64)


def test_keep_traces_float64_matches_the_jax_package(reference, jax64, port64):
    sim, out = port64
    G = len(reference["group_ids"])
    assert out.traces.shape == (G, 1, sim.n_base)
    tr, ref = out.traces.numpy(), jax64["traces"]
    limits = _limits(jax64["sol_type"], jax64["sol_mask"])
    for j in range(G):
        peak = np.abs(ref[j]).max()
        err = np.abs(tr[j] - ref[j]).max() / peak
        assert err <= limits[j], (reference["group_ids"][j], err, limits[j])
    assert (limits == EXACT).sum() >= 3        # groups held at 1e-6 of peak
    np.testing.assert_allclose(out.base_t0.numpy(), jax64["base_t0"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(out.triggered.numpy(), jax64["triggered"])
    np.testing.assert_allclose(out.trigger_time.numpy(), jax64["trigger_time"], atol=1e-3)


def test_keep_traces_leaves_the_decisions(reference, port64):
    _, out = port64
    _, plain = _port_keep_traces(reference["group_ids"], torch.float64, keep_traces=False)
    assert plain.traces is None
    for name in ("triggered", "trigger_time", "max_amplitude", "base_t0"):
        np.testing.assert_array_equal(getattr(plain, name).numpy(),
                                      getattr(out, name).numpy(), err_msg=name)


def test_keep_traces_float32_band_limit_widens_k(reference):
    """In float32 the arrival times move by up to ~0.2 ns against float64 in
    either package, so the f32 traces are not compared sample by sample;
    what is held is that both packages widen K: the traces carry the whole
    base grid, and the trigger's max amplitude is the traces' own maximum."""
    gids = reference["group_ids"]
    ref = _jax_keep_traces(gids, jnp.float32, BENCH)
    sim, out = _port_keep_traces(gids, torch.float32, BENCH)
    _, plain = _port_keep_traces(gids, torch.float32, BENCH, keep_traces=False)
    np.testing.assert_array_equal(plain.triggered.numpy(), out.triggered.numpy())
    np.testing.assert_array_equal(plain.trigger_time.numpy(), out.trigger_time.numpy())
    np.testing.assert_array_equal(out.triggered.numpy(), ref["triggered"])
    tr = out.traces.numpy()
    assert tr.shape == (len(gids), 1, sim.n_base)
    # bins past the band-limited support (816 of 1025 at eps 1e-2) are kept
    k_base = tpipeline._band_support((sim.channel_params.filter_response.numpy(),), 1e-2,
                                     sim.n_base // 2 + 1)
    assert k_base < sim.n_base // 2 + 1
    assert (np.abs(np.fft.rfft(tr, axis=-1))[..., k_base:].max(axis=-1) > 0).all()
    for traces, amp in ((tr, out.max_amplitude.numpy()), (ref["traces"], ref["max_amplitude"])):
        np.testing.assert_allclose(np.abs(traces).max(axis=-1), amp, rtol=1e-5)
    assert not np.array_equal(plain.max_amplitude.numpy(), out.max_amplitude.numpy())


def _on_reference_grid(trace, rate, t0, ref_t0, ref_fs, n_ref):
    """A trace resampled to ``ref_fs`` and cut onto the reference's readout
    grid: integer-bin cut plus a sub-bin shift of the remainder
    (tests/test_e2e_waveforms.py:89-105)."""
    bt = BaseTrace()
    bt.set_trace(trace, rate)
    bt.resample(ref_fs)
    offset = (ref_t0 - t0) * ref_fs
    start_bin = int(np.floor(offset))
    frac = offset - start_bin
    if abs(frac) > 1e-9:
        bt.apply_time_shift(-frac / ref_fs)
    return np.asarray(bt.get_trace())[start_bin:start_bin + n_ref]


def test_keep_traces_match_the_reference_waveforms(reference, port64):
    sim, out = port64
    for j, g in enumerate(reference["group_ids"]):
        ref_tr = reference["ref_traces"][j]
        mine = _on_reference_grid(out.traces[j, 0].numpy(), sim.internal_rate,
                                  float(out.base_t0[j]), reference["ref_t0"][j],
                                  reference["ref_fs"], len(ref_tr))
        scale = np.abs(ref_tr).max()
        np.testing.assert_allclose(mine / scale, ref_tr / scale, atol=0.02, err_msg=str(g))
        assert abs(float(out.trigger_time[j]) - reference["ref_trigger_times"][j]) <= 1.0


# ---- Simulation(nur_outputfilename=) against the JAX package's file ----------

def test_simulation_nur_output_matches_the_jax_package(tmp_path):
    port_path, jax_path = str(tmp_path / "port.nur"), str(tmp_path / "jax.nur")
    res = convert.dipole_simulation(str(io_input.INPUT_1E18_N3000), chunk_size=1024,
                                    device="cpu", dtype=torch.float64,
                                    nur_outputfilename=port_path).run()
    _jax_simulation(jnp.float64, nur_outputfilename=jax_path).run()
    mine = list(tnur.EventReader(port_path).run())
    # the JAX package's file through the port's reader, and the port's
    # through the JAX package's
    theirs = list(tnur.EventReader(jax_path).run())
    assert len(list(jnur.EventReader(port_path).run())) == len(mine)
    ids = [e.get_id() for e in mine]
    assert ids == [e.get_id() for e in theirs]
    assert ids == sorted(int(g) for g in res["group_ids"][res["triggered"]])
    _, out = _port_keep_traces(np.array(ids), torch.float64)
    limits = _limits(out.sol_type.numpy(), out.sol_mask.numpy())
    for j, (a, b) in enumerate(zip(mine, theirs)):
        sa, sb = a.get_station(STATION), b.get_station(STATION)
        ta, tb = sa.get_trigger("default_high_low"), sb.get_trigger("default_high_low")
        assert ta.has_triggered() and tb.has_triggered()
        assert abs(ta.get_trigger_time() - tb.get_trigger_time()) <= 1e-3
        ca, cb = sa.get_channel(0), sb.get_channel(0)
        assert ca.get_sampling_rate() == cb.get_sampling_rate() == 1.0
        assert abs(ca.get_trace_start_time() - cb.get_trace_start_time()) <= 1e-3
        tr_a, tr_b = np.asarray(ca.get_trace()), np.asarray(cb.get_trace())
        assert tr_a.shape == tr_b.shape
        assert np.abs(tr_a - tr_b).max() <= limits[j] * np.abs(tr_b).max(), ids[j]
        assert [s.get_id() for s in a.get_sim_showers()] == \
            [s.get_id() for s in b.get_sim_showers()]


def test_committed_waveform_reference_is_current(reference, jax64):
    pin = np.load(PIN)
    fresh = {**reference, **_jax_fields(jax64)}
    assert sorted(pin.files) == sorted(fresh)
    for k in fresh:
        np.testing.assert_allclose(pin[k], fresh[k], rtol=1e-12, atol=0, err_msg=k)


def _jax_fields(jax64):
    return dict(jax_traces=jax64["traces"][:, 0], jax_base_t0=jax64["base_t0"],
                jax_trigger_times=jax64["trigger_time"],
                jax_limits=_limits(jax64["sol_type"], jax64["sol_mask"]),
                jax_rate=np.float64(2.0))


if __name__ == "__main__":
    import conftest  # noqa: F401  (pins jax to the CPU in float64)
    ref = _reference_waveforms()
    fields = {**ref, **_jax_fields(_jax_keep_traces(ref["group_ids"], jnp.float64))}
    np.savez_compressed(PIN, **fields)
    print(f"wrote {PIN}: groups {ref['group_ids'].tolist()}, limits "
          f"{fields['jax_limits'].tolist()}")
