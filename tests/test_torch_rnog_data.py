"""The port's RNO-G data-quality modules (reco/rnog_data.py) against the JAX
package's, on the CPU in float64.

The traces are the ADC waveforms (in volts) of two runs of
``convert.make_rnog_runs`` (band-limited noise, block offsets of varying
spread, LAB4D scrambles, PA pulses on the LT events), and tests/
test_rnog_data.py's stations for the hit filter. Tolerances:

* block offsets: ``fit`` within 1e-9 of each trace's standard deviation,
  ``approximate`` and ``median`` within 1e-12 (absolute, volts); the
  ``auto`` branch equal in every channel (a channel within 1e-12 of the
  decision's edge is printed); corrected traces within 1e-12 of each
  channel's peak;
* the glitch statistic within 1e-12 relative, its flags equal; ``unscramble``
  and ``seam_diff_sq`` exactly, also at lengths that are not a multiple of
  2 x 64 (and raising where the JAX function raises);
* hit times, both checkers and the decision equal;
* the coherently summed waveform bit for bit (the same lags, the reference's
  order of additions), so the entropy's amplitude histogram is the same; its
  value within 1e-14 (the sum of p log2 p in another order); SNR,
  impulsivity and kurtosis rtol 1e-10.

The batched paths run at chunks smaller than the event count
(``rows_per_chunk`` patched), so that chunk seams are covered.
"""

import numpy as np
import pytest
import torch
from scipy import signal

from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.framework import parameters as jpar
from nuradiomc_tpu.reco import rnog_data as jrd
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.framework import parameters as tpar
from nuradiomc_tpu_torch.reco import rnog_data as trd

FS, N = 3.2, 2048
ADC = 2.5 / 4095
MAXF = 51e-3


@pytest.fixture(scope="module")
def volts(tmp_path_factory):
    """[12, 24, 2048] traces in volts of two runs of six events, and the
    injected scrambles."""
    tmp = tmp_path_factory.mktemp("rnog_data")
    paths, truth = convert.make_rnog_runs(str(tmp), n_runs=2, n_events=6, seed=3,
                                          glitch_fraction=0.4)
    w = np.concatenate([np.load(p + "/mattak_export.npz")["waveforms"] for p in paths])
    return w.astype(float) * ADC, np.concatenate([t["scrambled"] for t in truth])


def _station(ev, traces, fs=FS, ids=None):
    st = ev.Station(11)
    for cid, tr in zip(ids if ids is not None else range(len(traces)), traces):
        ch = ev.Channel(cid)
        ch.set_trace(np.array(tr), fs)
        st.add_channel(ch)
    evt = ev.Event(0, 0)
    evt.set_station(st)
    return evt, st


@pytest.mark.parametrize("mode", ["fit", "approximate", "auto"])
def test_fit_block_offsets(volts, mode):
    w = volts[0].reshape(-1, N)
    got, fitted, margin = trd.block_offset_fit(torch.as_tensor(w), 128, FS, MAXF, mode)
    want = np.array([jrd.fit_block_offsets(t, 128, FS, MAXF, mode) for t in w])
    err = np.abs(got.numpy() - want).max(-1)
    if mode == "fit":
        assert np.all(err <= 1e-9 * w.std(-1)), err.max()
    else:
        assert err.max() <= 1e-12, err.max()
    if mode == "auto":
        edge = np.abs(margin.numpy()) < 1e-12
        for row in np.flatnonzero(edge):
            print(f"channel row {row} within 1e-12 of the auto edge: {margin[row]:.3e}")
        # the JAX package's branch: its auto result is its fit result
        jax_fit = np.array([np.array_equal(a, jrd.fit_block_offsets(t, 128, FS, MAXF, "fit"))
                            for a, t in zip(want, w)])
        np.testing.assert_array_equal(fitted.numpy(), jax_fit)
        assert 0 < jax_fit.sum() < len(jax_fit)     # both branches are taken


def test_fit_block_offsets_partial_blocks_and_leading_axes(volts):
    w = volts[0][:3, :4, :2000]                      # 15 whole blocks + 80 samples
    off, out = trd.fit_block_offsets(torch.as_tensor(w), 128, FS, MAXF, "auto",
                                     return_trace=True)
    for e in range(3):
        for c in range(4):
            o, t = jrd.fit_block_offsets(w[e, c], 128, FS, MAXF, "auto", return_trace=True)
            np.testing.assert_allclose(off[e, c].numpy(), o, rtol=0, atol=1e-9 * w[e, c].std())
            np.testing.assert_allclose(out[e, c].numpy(), t, rtol=0,
                                       atol=1e-12 * np.abs(t).max())
            np.testing.assert_array_equal(out[e, c, 1920:].numpy(), w[e, c, 1920:])


@pytest.mark.parametrize("mode", ["auto", "fit", "approximate", "median"])
def test_block_offsets_module(volts, mode):
    traces = volts[0][1]
    jevt, jst = _station(jev, traces)
    tevt, tst = _station(tev, traces)
    jrd.channelBlockOffsets().run(jevt, jst, mode=mode)
    trd.channelBlockOffsets(device="cpu").run(tevt, tst, mode=mode)
    jchp, tchp = jpar.channelParameters, tpar.channelParameters
    for jc, tc in zip(jst.iter_channels(), tst.iter_channels()):
        a, b = np.asarray(tc.get_trace()), np.asarray(jc.get_trace())
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max())
        ref = np.asarray(jc[jchp.block_offsets])
        tol = 1e-9 * np.std(traces[tc.get_id()]) if mode in ("auto", "fit") else 1e-12
        np.testing.assert_allclose(np.asarray(tc[tchp.block_offsets]), ref, rtol=0, atol=tol)
        if mode == "median":
            np.testing.assert_array_equal(np.asarray(tc[tchp.block_offsets]), ref)


def test_add_offsets_same_draws():
    tr = np.random.default_rng(1).normal(0, 0.01, N)
    jevt, jst = _station(jev, [tr])
    tevt, tst = _station(tev, [tr])
    jrd.channelBlockOffsets().add_offsets(jevt, jst, offsets=0.08,
                                          rng=np.random.default_rng(2))
    trd.channelBlockOffsets(device="cpu").add_offsets(tevt, tst, offsets=0.08,
                                                      rng=np.random.default_rng(2))
    np.testing.assert_array_equal(tst.get_channel(0).get_trace(),
                                  jst.get_channel(0).get_trace())


@pytest.mark.parametrize("n", [2048, 2000, 1984, 2112, 2100, 1000])
def test_unscramble_and_seams(n):
    tr = np.random.default_rng(n).normal(size=(3, n))
    try:
        want = np.array([jrd.unscramble(t) for t in tr])
    except ValueError:
        with pytest.raises(ValueError):
            trd.unscramble(torch.as_tensor(tr))
        return
    got = trd.unscramble(torch.as_tensor(tr)).numpy()
    np.testing.assert_array_equal(got, want)
    seams = trd.seam_diff_sq(torch.as_tensor(tr)).numpy()
    np.testing.assert_allclose(seams, [jrd.seam_diff_sq(t) for t in tr], rtol=1e-14)


def test_glitch_statistic_and_detector(volts):
    w, scrambled = volts
    flat = w.reshape(-1, N)
    got = trd.glitch_statistic(torch.as_tensor(flat)).numpy()
    want = np.array([(jrd.seam_diff_sq(t) - jrd.seam_diff_sq(jrd.unscramble(t))) / np.var(t)
                     for t in flat])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    for e in (0, int(np.flatnonzero(scrambled.any(-1))[0])):
        jevt, jst = _station(jev, w[e])
        tevt, tst = _station(tev, w[e])
        jrd.channelGlitchDetector().run(jevt, jst)
        trd.channelGlitchDetector(device="cpu").run(tevt, tst)
        jflags = [c[jpar.channelParameters.glitch] for c in jst.iter_channels()]
        tflags = [c[tpar.channelParameters.glitch] for c in tst.iter_channels()]
        assert tflags == jflags


def _hit_stations(ev):
    """tests/test_rnog_data.py's pulsed (PA 0-3), high-hit (channel 0) and
    pure-noise stations."""
    out = []
    for pulsed in ([0, 1, 2, 3], [0], None):
        rng = np.random.default_rng(4 if pulsed is not None else 5)
        t = np.arange(N) / FS
        traces = []
        for cid in jrd.stationHitFilter.IN_ICE_CHANNELS:
            tr = rng.normal(0, 0.01, N)
            if pulsed is not None and cid in pulsed:
                k = pulsed.index(cid)
                tr += 0.5 * np.exp(-0.5 * ((t - 300 - 1.0 * k) / 3.0) ** 2)
            traces.append(tr)
        out.append(_station(ev, traces, ids=jrd.stationHitFilter.IN_ICE_CHANNELS))
    return out


def _lt_stations(ev, w):
    out = []
    for traces in w:
        evt, st = _station(ev, traces)
        for c in st.iter_channels():
            c.set_trace_start_time(-250.0 - 0.1 * c.get_id())
        out.append((evt, st))
    return out


def test_hit_filter(volts, monkeypatch):
    monkeypatch.setattr(trd, "rows_per_chunk", lambda nbytes, device, n_rows: min(4, n_rows))
    j_st = _hit_stations(jev) + _lt_stations(jev, volts[0])
    t_st = _hit_stations(tev) + _lt_stations(tev, volts[0])
    jhf, thf = jrd.stationHitFilter(), trd.stationHitFilter(device="cpu")
    want = []
    for (evt, st) in j_st:
        passed = jhf.run(evt, st)
        want.append((passed, jhf.passed_time_checker, jhf.passed_hit_checker))
    for (evt, st), w in zip(t_st, want):
        assert (thf.run(evt, st), thf.passed_time_checker, thf.passed_hit_checker) == w
    assert [w[:2] for w in want[:3]] == [(True, True), (True, False), (False, False)]
    passed, time_ok, hit, t_hit = thf.run_events([evt for evt, _ in t_st])
    np.testing.assert_array_equal(np.c_[passed, time_ok, hit], np.array(want))
    # the hit times: the JAX package's envelope argmax on each channel's times
    for (evt, st), th in zip(j_st, t_hit):
        chans = sorted((c for c in st.iter_channels()
                        if c.get_id() in jrd.stationHitFilter.IN_ICE_CHANNELS),
                       key=lambda c: c.get_id())
        for c, t in zip(chans, th):
            env = np.abs(signal.hilbert(c.get_trace()))
            assert c.get_times()[np.argmax(env)] == t
    # a trigger selection passes other triggers unchecked, in both packages
    sel = trd.stationHitFilter(select_trigger="LT", device="cpu")
    evt, st = t_st[0]
    trig = tev.Trigger("FORCE")
    st.set_trigger(trig)
    assert sel.run(evt, st) is True
    assert sel.run_events([evt])[0][0]


def test_coherent_sums(volts, monkeypatch):
    monkeypatch.setattr(trd, "rows_per_chunk", lambda nbytes, device, n_rows: min(5, n_rows))
    w = volts[0]
    jmod, tmod = jrd.stationCoherentlySummedWaveforms(), \
        trd.stationCoherentlySummedWaveforms(device="cpu")
    jmod.begin()
    tmod.begin()
    rnog_j, rnog_t = jpar.stationParametersRNOG, tpar.stationParametersRNOG
    keys = ("coherent_snr", "coherent_impulsivity", "coherent_entropy", "coherent_kurtosis")
    want = {k: [] for k in keys}
    t_events = []
    for traces in w:
        evt, st = _station(jev, traces)
        csw_j = jmod.run(evt, st)
        for k in keys:
            want[k].append(st[getattr(rnog_j, k)])
        tevt, tst = _station(tev, traces)
        csw_t = tmod.run(tevt, tst)
        # the same lags and the reference's order of additions: the summed
        # waveform bit for bit, so the entropy's histogram is the same
        np.testing.assert_array_equal(csw_t, csw_j)
        np.testing.assert_allclose(tst[rnog_t.coherent_entropy], st[rnog_j.coherent_entropy],
                                   rtol=1e-14)
        t_events.append(_station(tev, traces)[0])
    got = tmod.run_events(t_events)
    for k in ("coherent_snr", "coherent_impulsivity", "coherent_kurtosis"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10)
    np.testing.assert_allclose(got["coherent_entropy"], want["coherent_entropy"], rtol=1e-14)
    for evt, snr in zip(t_events, got["coherent_snr"]):
        assert evt.get_station()[rnog_t.coherent_snr] == snr


def test_median_of_an_even_count():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(5, 20)))
    np.testing.assert_array_equal(trd.median_last(x).numpy(), np.median(x.numpy(), -1))
    np.testing.assert_array_equal(trd.median_last(x[:, :19]).numpy(),
                                  np.median(x.numpy()[:, :19], -1))
