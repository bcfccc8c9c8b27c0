"""The port's RNO-G reader and data provider (reco/rnog_io.py) and the
measured-noise importers (reco/measured_noise.py) against the JAX package's,
on the CPU in float64.

* Reader: the same selections, event order, station times, triggers and
  trace start times, exactly; traces bit for bit without a baseline
  correction and within 1e-12 of each channel's peak with one (block
  offsets as tests/test_torch_rnog_data.py holds them); lookups and the run
  table equal. The runs are ``convert.make_rnog_runs``'s and
  tests/test_rnog_io.py's fixture runs, written by the port's writer (the
  same ``.npz`` as the JAX package's writer).
* Data provider: tests/test_rnog_io.py:170-192's sequence, and every event
  against the JAX provider's (traces within 1e-12 of peak, glitch flags
  equal, start times after the cable delays equal).
* Noise importers: the drawn noise events (RNO-G) and CalibTree entries
  (ARIANNA) equal; the noisy traces bit for bit where the noise trace is
  the stored one (ARIANNA, RNO-G without a baseline correction), within
  1e-12 of peak behind the reader's default ``auto`` baseline correction.

The chunked paths run at chunks of 3 events (``rows_per_chunk`` patched).
"""

import math

import numpy as np
import pytest

from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.framework import parameters as jpar
from nuradiomc_tpu.reco import measured_noise as jmn
from nuradiomc_tpu.reco import rnog_io as jio
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.framework import parameters as tpar
from nuradiomc_tpu_torch.reco import measured_noise as tmn
from nuradiomc_tpu_torch.reco import rnog_io as tio
from nuradiomc_tpu_torch.utils import units

FS, N_CH, N_SAMP = 3.2, 24, 2048


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(tio, "rows_per_chunk", lambda nbytes, device, n_rows: min(3, n_rows))
    monkeypatch.setattr(tmn, "rows_per_chunk", lambda nbytes, device, n_rows: min(3, n_rows))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two runs of eight events of ``convert.make_rnog_runs`` (FORCE, LT,
    RADIANT0; scrambles; block offsets; the first event of each with an
    infinite trigger time) and tests/test_rnog_io.py's two runs."""
    tmp = tmp_path_factory.mktemp("rnog_io")
    paths, truth = convert.make_rnog_runs(str(tmp / "made"), n_runs=2, n_events=8, seed=5,
                                          glitch_fraction=0.3)
    rng = np.random.default_rng(5)
    wfs0 = rng.integers(-40, 40, (3, N_CH, N_SAMP))
    delays0 = rng.uniform(0, 10, (3, N_CH))
    fixture = [str(tmp / "fixture" / "run100"), str(tmp / "fixture" / "run101")]
    tio.write_numpy_dataset(fixture[0], 11, 100, wfs0, event_numbers=[0, 1, 2],
                            trigger_types=["FORCE", "RADIANT0", "LT"],
                            trigger_times=[1.7e9, 1.7e9 + 1, 1.7e9 + 2],
                            readout_times=[1.7e9, 1.7e9 + 1, 1.7e9 + 2],
                            sample_rate=FS, readout_delays=delays0)
    wfs1 = rng.integers(-40, 40, (2, N_CH, N_SAMP))
    tio.write_numpy_dataset(fixture[1], 11, 101, wfs1, event_numbers=[0, 1],
                            trigger_types=["FORCE", "FORCE"],
                            trigger_times=[1.8e9, math.inf],
                            readout_times=[1.8e9, 1.8e9 + 5], sample_rate=FS)
    return paths, truth, fixture, delays0


def _of_peak(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.max(np.abs(want)))


def _same_events(port, ref, exact_traces, tol=1e-12):
    assert [(e.get_run_number(), e.get_id()) for e in port] == \
        [(e.get_run_number(), e.get_id()) for e in ref]
    for a, b in zip(port, ref):
        sa, sb = a.get_station(), b.get_station()
        assert sa.get_id() == sb.get_id()
        assert sa.get_station_time() == sb.get_station_time()
        assert sa.get_first_trigger().get_name() == sb.get_first_trigger().get_name()
        assert sa.get_channel_ids() == sb.get_channel_ids()
        for ca, cb in zip(sa.iter_channels(), sb.iter_channels()):
            assert ca.get_trace_start_time() == cb.get_trace_start_time()
            assert ca.get_sampling_rate() == cb.get_sampling_rate()
            if exact_traces:
                np.testing.assert_array_equal(ca.get_trace(), cb.get_trace())
            else:
                _of_peak(ca.get_trace(), cb.get_trace(), tol)
            for pa, pb in ((tpar.channelParameters.block_offsets,
                            jpar.channelParameters.block_offsets),
                           (tpar.channelParameters.glitch, jpar.channelParameters.glitch)):
                assert ca.has_parameter(pa) == cb.has_parameter(pb)
                if cb.has_parameter(pb) and pb.name == "glitch":
                    assert ca[pa] == cb[pb]
                elif cb.has_parameter(pb):
                    np.testing.assert_allclose(np.asarray(ca[pa]), np.asarray(cb[pb]), rtol=0,
                                               atol=1e-9 * np.std(cb.get_trace()) + 1e-12)


def test_writer_equals_the_original(tmp_path):
    rng = np.random.default_rng(2)
    kw = dict(event_numbers=[4, 5], trigger_types=["LT", "FORCE"],
              trigger_times=[1.0, math.inf], readout_times=[1.0, 2.0],
              readout_delays=rng.uniform(0, 1, (2, 3)))
    wfs = rng.integers(-9, 9, (2, 3, 16)).astype(np.int16)
    a = tio.write_numpy_dataset(str(tmp_path / "a"), 11, 7, wfs, **kw)
    b = jio.write_numpy_dataset(str(tmp_path / "b"), 11, 7, wfs, **kw)
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in zb.files:
        np.testing.assert_array_equal(za[k], zb[k])
        assert za[k].dtype == zb[k].dtype
    for t in ("FORCE", "LT", "RADIANT0", "RADIANT1", "UNKNOWN"):
        assert tio.get_time_offset(t) == jio.get_time_offset(t)
    assert tio.ADC_TO_VOLT == jio.ADC_REF_VOLTAGE_RANGE / (2 ** jio.ADC_N_BITS - 1)


@pytest.mark.parametrize("mode", ["none", "auto", "median", "fit", "approximate"])
def test_reader_events(runs, mode):
    paths = runs[0]
    t = tio.readRNOGData(device="cpu")
    t.begin(paths, apply_baseline_correction=mode)
    j = jio.readRNOGData()
    j.begin(paths, apply_baseline_correction=mode)
    port, ref = list(t.run()), list(j.run())
    assert len(ref) == 16
    _same_events(port, ref, exact_traces=mode == "none")


@pytest.mark.parametrize("kw", [dict(convert_to_voltage=False), dict(select_triggers="RADIANT"),
                                dict(select_triggers=["LT", "FORCE"]),
                                dict(selectors=[lambda info: info.run == 101]),
                                dict(use_fallback_time=False), dict(read_calibrated_data=True)],
                         ids=["adc", "radiant", "lt_force", "selector", "no_fallback",
                              "calibrated"])
def test_reader_selections(runs, kw):
    fixture = runs[2]
    port, ref = tio.readRNOGData(device="cpu"), jio.readRNOGData()
    for r in (port, ref):
        r.begin(fixture, apply_baseline_correction="none", **kw)
    _same_events(list(port.run()), list(ref.run()), exact_traces=True)


def test_reader_lookups_and_run_table(runs, tmp_path):
    fixture = runs[2]
    port, ref = tio.readRNOGData(device="cpu"), jio.readRNOGData()
    for r in (port, ref):
        r.begin(fixture + runs[0], apply_baseline_correction="auto")
    assert port.get_n_events() == ref.get_n_events() == 21
    np.testing.assert_array_equal(port.get_run_numbers(), ref.get_run_numbers())
    assert port.get_station_id() == ref.get_station_id()
    keys = ("run", "eventNumber", "triggerType", "triggerTime")
    assert port.get_events_information(keys) == ref.get_events_information(keys)
    for idx in (0, 3, 4, 7, 20):
        a, b = port.get_event_by_index(idx), ref.get_event_by_index(idx)
        _same_events([a], [b], exact_traces=False)
    _same_events([port.get_event(1001, 5)], [ref.get_event(1001, 5)], exact_traces=False)
    assert port.get_event(100, 99) is None and ref.get_event(100, 99) is None
    table = tmp_path / "runtable.csv"
    table.write_text("station,run,run_type,time_start,time_end,trigger_rate\n"
                     "11,100,physics,1.6e9,1.9e9,0.5\n"
                     "11,101,calibration,1.6e9,1.9e9,0.5\n"
                     "11,1000,physics,1.6e9,1.9e9,3.0\n")
    for kw in (dict(select_runs=True), dict(select_runs=True, max_trigger_rate=2 * units.Hz),
               dict(select_runs=True, run_time_range=(1.95e9, None))):
        a = tio.readRNOGData(run_table_path=str(table), load_run_table=True, device="cpu")
        b = jio.readRNOGData(run_table_path=str(table), load_run_table=True)
        for r in (a, b):
            try:
                r.begin(fixture + runs[0], apply_baseline_correction="none", **kw)
            except FileNotFoundError:
                r._datasets = []
        np.testing.assert_array_equal([d.run for d in a._datasets],
                                      [d.run for d in b._datasets])


class FakeDet:
    def __init__(self):
        self.updated_to = None
        self.seen = []

    def update(self, time):
        self.updated_to = time
        self.seen.append(time)

    def get_cable_delay(self, station_id, channel_id):
        return 10.0 + channel_id


def test_data_provider_sequence(runs):
    """tests/test_rnog_io.py:170-192 on the port."""
    fixture, delays0 = runs[2], runs[3]
    det = FakeDet()
    provider = tio.dataProviderRNOG(device="cpu")
    provider.begin([fixture[0]], det)
    events = list(provider.run())
    assert len(events) == 3
    assert det.updated_to == pytest.approx(1.7e9 + 2)
    ch = events[0].get_station(11).get_channel(2)
    assert ch.has_parameter(tpar.channelParameters.glitch)
    assert ch.has_parameter(tpar.channelParameters.block_offsets)
    assert ch.get_trace_start_time() == pytest.approx(-delays0[0, 2] - (10.0 + 2))
    provider.end()


def test_data_provider_against_the_jax_provider(runs):
    paths, truth = runs[0], runs[1]
    dets = FakeDet(), FakeDet()
    port, ref = tio.dataProviderRNOG(device="cpu"), jio.dataProviderRNOG()
    port.begin(paths, dets[0], reader_kwargs={"apply_baseline_correction": "auto"})
    ref.begin(paths, dets[1])
    a = []
    for evt in port.run():
        # the detector follows each event before it is yielded
        assert dets[0].updated_to == evt.get_station().get_station_time()
        a.append(evt)
    b = list(ref.run())
    _same_events(a, b, exact_traces=False)
    assert dets[0].seen == dets[1].seen
    flags = np.array([[c[tpar.channelParameters.glitch] for c in e.get_station().iter_channels()]
                      for e in a])
    np.testing.assert_array_equal(flags, np.concatenate([t["scrambled"] for t in truth]))
    assert port.n_glitch == flags.sum() > 0 and 0 < port.n_fitted < flags.size
    assert [m[0] for m in a[0].iter_modules()] == [m[0] for m in b[0].iter_modules()]


def _sim_pairs(ev, n_events, station_id=11, n_channels=3, n_samples=N_SAMP, fs=FS, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for e in range(n_events):
        evt = ev.Event(0, e)
        st = ev.Station(station_id)
        for c in range(n_channels):
            ch = ev.Channel(c)
            ch.set_trace(rng.standard_normal(n_samples) * 1e-5, fs)
            st.add_channel(ch)
        evt.set_station(st)
        out.append((evt, st))
    return out


def _jax_rnog_draws(imp, pairs):
    """The JAX importer per event, recording its draws."""
    draws = []
    real = imp._draw_noise_event

    def spy(mask):
        noise_event, i_noise = real(mask)
        draws.append(i_noise)
        return noise_event, i_noise

    imp._draw_noise_event = spy
    for evt, st in pairs:
        imp.run(evt, st, None)
    return draws


def _traces(pairs):
    return np.array([[c.get_trace() for c in st.iter_channels()] for _, st in pairs])


@pytest.mark.parametrize("kw, exact", [
    (dict(reader_kwargs={"apply_baseline_correction": "none"}), True),
    (dict(), False),
    (dict(channel_mapping={0: 5, 1: 6, 2: 23}, reader_kwargs={"select_runs": False}), False),
    (dict(match_station_id=True, scramble_noise_file_order=False), False)],
    ids=["no_baseline", "auto_baseline", "mapping", "match_station"])
def test_rnog_noise_importer(runs, kw, exact):
    folders = [runs[2][0], runs[0][0], runs[0][1]]
    j, t = jmn.RNOGNoiseImporter(), tmn.RNOGNoiseImporter(device="cpu")
    j.begin(folders, random_seed=3, **kw)
    t.begin(folders, random_seed=3, **kw)
    jp, tp = _sim_pairs(jev, 7), _sim_pairs(tev, 7)
    want = _jax_rnog_draws(j, jp)
    got = t.run_events(tp[:6]) + t.run_events(tp[6:])
    assert got == want and len(set(want)) > 1
    if exact:
        np.testing.assert_array_equal(_traces(tp), _traces(jp))
    else:
        for a, b in zip(_traces(tp).reshape(-1, N_SAMP), _traces(jp).reshape(-1, N_SAMP)):
            _of_peak(a, b)
    assert dict(t._n_use_event) == dict(j._n_use_event)
    j.end()
    t.end()


def test_rnog_noise_importer_errors(runs):
    folders = [runs[2][0]]
    t = tmn.RNOGNoiseImporter(device="cpu")
    t.begin(folders, match_station_id=True, random_seed=7,
            reader_kwargs={"apply_baseline_correction": "none"})
    evt, st = _sim_pairs(tev, 1, station_id=99)[0]
    with pytest.raises(ValueError, match="No station with id 99"):
        t.run(evt, st, None)
    evt, st = _sim_pairs(tev, 1, n_samples=512)[0]
    with pytest.raises(ValueError, match="Mismatch in trace length"):
        t.run(evt, st, None)
    evt, st = _sim_pairs(tev, 1, fs=2.0)[0]
    with pytest.raises(ValueError, match="Mismatch in sampling rate"):
        t.run(evt, st, None)
    t2 = tmn.RNOGNoiseImporter(device="cpu")
    t2.begin(folders, station_ids=[12], random_seed=7)
    evt, st = _sim_pairs(tev, 1)[0]
    with pytest.raises(ValueError, match="not in list of allowed ids"):
        t2.run(evt, st, None)
    # traces longer than 2048 samples are trimmed before the sum, as in the JAX package
    j = jmn.RNOGNoiseImporter()
    j.begin(folders, random_seed=1, reader_kwargs={"apply_baseline_correction": "none"})
    t3 = tmn.RNOGNoiseImporter(device="cpu")
    t3.begin(folders, random_seed=1, reader_kwargs={"apply_baseline_correction": "none"})
    jp, tp = _sim_pairs(jev, 2, n_samples=2100), _sim_pairs(tev, 2, n_samples=2100)
    _jax_rnog_draws(j, jp)
    t3.run_events(tp)
    np.testing.assert_array_equal(_traces(tp), _traces(jp))


def test_arianna_noise_importer(tmp_path):
    rng = np.random.default_rng(2)
    np.savez(tmp_path / "caltree_export.npz", amp_out=rng.standard_normal((5, 4, 256)))
    j, t = jmn.ARIANNANoiseImporter(), tmn.ARIANNANoiseImporter(device="cpu")
    j.begin([str(tmp_path / "caltree_export.npz")], random_seed=11)
    t.begin([str(tmp_path / "caltree_export.npz")], random_seed=11)
    jp = _sim_pairs(jev, 6, n_channels=4, n_samples=256, fs=1.0)
    tp = _sim_pairs(tev, 6, n_channels=4, n_samples=256, fs=1.0)
    for evt, st in jp:
        j.run(evt, st, None)
    got = t.run_events(tp[:4])
    for evt, st in tp[4:]:
        t.run(evt, st, None)
    np.testing.assert_array_equal(_traces(tp), _traces(jp))
    stream = np.random.Generator(np.random.Philox(11))
    assert got == [min(int(stream.integers(0, 6)), 4) for _ in range(16)]
    # a sample-count mismatch leaves the trace as it was (the draw is still made)
    jp2 = _sim_pairs(jev, 1, n_channels=4, n_samples=128, fs=1.0)
    tp2 = _sim_pairs(tev, 1, n_channels=4, n_samples=128, fs=1.0)
    j.run(*jp2[0], None)
    assert len(t.run_events(tp2)) == 4
    np.testing.assert_array_equal(_traces(tp2), _traces(jp2))
    np.testing.assert_array_equal(_traces(tp2), _traces(_sim_pairs(tev, 1, n_channels=4,
                                                                   n_samples=128, fs=1.0)))
    evt, st = _sim_pairs(tev, 1, n_channels=4, n_samples=256, fs=1.0)[0]
    j.run(*_sim_pairs(jev, 1, n_channels=4, n_samples=256, fs=1.0)[0], None)
    t.run(evt, st, None)
    assert tmn.noiseImporter is tmn.RNOGNoiseImporter
    assert tmn.noiseImporterARIANNA is tmn.ARIANNANoiseImporter


def test_root_backends_are_import_gated():
    with pytest.raises(ImportError, match="mattak"):
        tio.MattakDataset("/nonexistent/run")
