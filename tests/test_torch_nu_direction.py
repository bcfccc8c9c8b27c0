"""The port's neutrino direction + energy fit against the JAX package's, on
the CPU in float64, on tests/test_nu_direction.py's station (four VPols on a
string), vertex and truth (zenith 115 deg, azimuth 20 deg, log10 E 17.3,
greenland_simple, GL1):

* the forward-model traces at the truth agree within 1e-9 of their peak;
* the chi2 of 16 random grid points of each stage agrees with the JAX
  package's formula (``nu_direction.py:169-184``, evaluated on the JAX
  forward model) at rtol 1e-8;
* the fit is the same grid point in both packages.
"""

import numpy as np
import pytest

from nuradiomc_tpu.detector.detector import Detector as JDetector
from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.models import ice as jice
from nuradiomc_tpu.reco import nu_direction as jnd
from nuradiomc_tpu_torch.detector.detector import Detector as TDetector
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.models import ice as tice
from nuradiomc_tpu_torch.reco import nu_direction as tnd

from test_torch_vertex import _detector_dict
from test_vertex import DEPTHS

VERTEX = np.array([420.0, 0.0, -520.0])
TRUTH = (np.deg2rad(115.0), np.deg2rad(20.0), 17.3)
FIT_KW = dict(zenith_range=(TRUTH[0] - np.deg2rad(10), TRUTH[0] + np.deg2rad(10)),
              azimuth_range=(TRUTH[1] - np.deg2rad(10), TRUTH[1] + np.deg2rad(10)),
              energy_range=(TRUTH[2] - 1.0, TRUTH[2] + 1.0),
              coarse_steps=(7, 7, 6), n_zoom=1)


def _station(ev, traces=None, noise=0.0):
    st = ev.Station(21)
    rng = np.random.default_rng(0)
    for cid in range(4):
        ch = ev.Channel(cid)
        ch.set_trace(np.zeros(1024) if traces is None
                     else traces[cid] + rng.normal(0, noise, 1024), 2.0)
        st.add_channel(ch)
    evt = ev.Event(0, 0)
    evt.set_station(st)
    return evt, st


def _dry(reco, ev, det):
    evt, st = _station(ev)
    reco.run(evt, st, det, vertex=VERTEX, use_channels=[0, 1, 2, 3],
             zenith_range=(TRUTH[0] - .01, TRUTH[0] + .01),
             azimuth_range=(TRUTH[1] - .01, TRUTH[1] + .01),
             energy_range=(TRUTH[2] - .01, TRUTH[2] + .01), coarse_steps=(2, 2, 2), n_zoom=0)


@pytest.fixture(scope="module")
def fits():
    det_dict = _detector_dict([(0.0, 0.0, z) for z in DEPTHS], 21)
    jdet, tdet = JDetector(det_dict), TDetector(det_dict)
    jreco = jnd.neutrinoDirectionReconstructor()
    jreco.begin(jice.get_ice_model("greenland_simple"), attenuation_model="GL1")
    treco = tnd.neutrinoDirectionReconstructor(device="cpu")
    treco.begin(tice.get_ice_model("greenland_simple"), attenuation_model="GL1")
    _dry(treco, tev, tdet)
    truth_t = treco.forward(*TRUTH).numpy()
    noise = 0.02 * np.max(np.abs(truth_t))
    out = []
    for reco, ev, det in ((jreco, jev, jdet), (treco, tev, tdet)):
        evt, st = _station(ev, truth_t, noise)
        out.append(reco.run(evt, st, det, vertex=VERTEX, use_channels=[0, 1, 2, 3],
                            noise_RMS=noise, **FIT_KW))
    measured = _station(jev, truth_t, noise)[1]
    return dict(jreco=jreco, treco=treco, truth_j=np.asarray(jreco.forward(*TRUTH)),
                truth_t=truth_t, noise=noise, fit_j=out[0], fit_t=out[1],
                measured=np.array([measured.get_channel(c).get_trace() for c in range(4)]))


def test_forward_model_matches(fits):
    a, b = fits["truth_t"], fits["truth_j"]
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.max(np.abs(b)))


def _jax_chi2(forward, measured, noise, pts):
    """nu_direction.py:169-184 on the JAX package's forward model."""
    best = int(np.argmax(np.max(np.abs(measured), axis=-1)))
    n_t = measured.shape[-1]
    out = []
    for zen, az, logE in pts:
        traces = np.asarray(forward(zen, az, logE))
        corr = np.fft.irfft(np.fft.rfft(measured[best], 2 * n_t)
                            * np.conj(np.fft.rfft(traces[best], 2 * n_t)), 2 * n_t)
        rolled = np.roll(traces, int(np.argmax(np.abs(corr))), axis=-1)
        out.append(np.sum(np.abs(measured - rolled) ** 2) / (2 * noise ** 2))
    return np.array(out)


def test_chi2_grid_matches(fits):
    stages = fits["treco"].grids
    assert len(stages) == 2 and len(stages[0][0]) == 7 * 7 * 6
    rng = np.random.default_rng(1)
    for pts, chi2 in stages:
        pick = rng.choice(len(pts), 16, replace=False)
        ref = _jax_chi2(fits["jreco"].forward, fits["measured"], fits["noise"], pts[pick])
        np.testing.assert_allclose(chi2[pick], ref, rtol=1e-8)


def test_same_fit(fits):
    assert fits["fit_t"] == fits["fit_j"]
    np.testing.assert_allclose(fits["treco"].chi2_min, fits["jreco"].chi2_min, rtol=1e-8)
    zen, az, logE = fits["fit_t"]
    assert abs(zen - TRUTH[0]) < np.deg2rad(3.0) and abs(logE - TRUTH[2]) < 0.4
