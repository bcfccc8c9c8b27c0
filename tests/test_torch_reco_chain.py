"""``examples/04_vertex_direction_reco/run_reco_chain.py`` through the port and
the JAX package on the CPU in float64, at a coarse grid: the eight channels
on three strings, the synthetic event (the port's forward model at the
truth plus 3% noise, numpy seed 0; the same traces in both packages),
the 3D vertex from travel-time tables at 20 m steps (12 steps a side, three
zooms), then the neutrino direction and energy at the reconstructed vertex
(+-10 deg, +-1 dex, 5 steps a side, one zoom). The vertex and the (zenith,
azimuth, log10 E) fit are the same in both packages.
"""

import numpy as np
import pytest

from nuradiomc_tpu.detector.detector import Detector as JDetector
from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.models import ice as jice
from nuradiomc_tpu.reco import nu_direction as jnd
from nuradiomc_tpu.reco import vertex as jvertex
from nuradiomc_tpu_torch.detector.detector import Detector as TDetector
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.models import ice as tice
from nuradiomc_tpu_torch.reco import examples
from nuradiomc_tpu_torch.reco import nu_direction as tnd
from nuradiomc_tpu_torch.reco import vertex as tvertex

TAB_KW = dict(x_min=20.0, x_max=1200.0, d_x=20.0, z_min=-1100.0, z_max=-30.0, d_z=20.0)
TRUTH = examples.RECO_CHAIN_TRUTH
N_CH = len(examples.RECO_CHAIN_POSITIONS)


def _chain(ev, nd, vx, ice, det, traces, kw):
    dir_reco = nd.neutrinoDirectionReconstructor(**kw)
    dir_reco.begin(ice, attenuation_model="GL1")
    evt, st, noise = examples.reco_chain_event(ev, dir_reco, det, traces=traces)
    v_reco = vx.neutrino3DVertexReconstructor(ice, table_kwargs=TAB_KW, **kw)
    v_reco.begin(1, list(range(N_CH)), det)
    vertex = v_reco.run(evt, st, max_distance=1000.0, z_range=(-1000.0, -50.0),
                        coarse_steps=12, n_zoom=3)
    fit = dir_reco.run(
        evt, st, det, vertex=np.asarray(vertex), noise_RMS=noise,
        use_channels=list(range(N_CH)),
        zenith_range=(TRUTH["zenith"] - np.deg2rad(10), TRUTH["zenith"] + np.deg2rad(10)),
        azimuth_range=(TRUTH["azimuth"] - np.deg2rad(10), TRUTH["azimuth"] + np.deg2rad(10)),
        energy_range=(TRUTH["log10_energy"] - 1, TRUTH["log10_energy"] + 1),
        coarse_steps=(5, 5, 5), n_zoom=1)
    return np.asarray(vertex), fit


@pytest.fixture(scope="module")
def chains():
    tdet = TDetector(examples.RECO_CHAIN_DETECTOR)
    tice_ = tice.get_ice_model(examples.GREENLAND)
    forward = tnd.neutrinoDirectionReconstructor(device="cpu")
    forward.begin(tice_, attenuation_model="GL1")
    examples.reco_chain_event(tev, forward, tdet)
    traces = forward.forward(TRUTH["zenith"], TRUTH["azimuth"], TRUTH["log10_energy"]).numpy()
    return (_chain(jev, jnd, jvertex, jice.get_ice_model(examples.GREENLAND),
                   JDetector(examples.RECO_CHAIN_DETECTOR), traces, {}),
            _chain(tev, tnd, tvertex, tice_, tdet, traces, {"device": "cpu"}))


def test_same_vertex(chains):
    (vj, _), (vt, _) = chains
    np.testing.assert_array_equal(vt, vj)


def test_same_direction_and_energy(chains):
    (_, fj), (_, ft) = chains
    assert ft == fj
