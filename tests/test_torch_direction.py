"""The port's direction fitters against the JAX package's, on the CPU in
float64: ``beamforming_score`` on a batch of directions at rtol 1e-10, and
the correlation, beam-forming and template fitters give the same direction
(equal to 1e-12 rad) on tests/test_direction.py's station and plane waves,
the same inputs (numpy) through both packages."""

import jax.numpy as jnp
import numpy as np
import torch

from nuradiomc_tpu.detector.detector import Detector as JDetector
from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.framework import parameters as jpar
from nuradiomc_tpu.ops import antenna as jantenna
from nuradiomc_tpu.ops import filters as jfilters
from nuradiomc_tpu.reco import direction as jdir
from nuradiomc_tpu_torch.detector.detector import Detector as TDetector
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.framework import parameters as tpar
from nuradiomc_tpu_torch.reco import direction as tdir
from nuradiomc_tpu_torch.reco import examples
from nuradiomc_tpu_torch.utils import units

JDET = JDetector(examples.SQUARE_DETECTOR)
TDET = TDetector(examples.SQUARE_DETECTOR)
ANGLE_TOL = 1e-12


def _vel_theta(cid, freqs, zenith, azimuth):
    rot = jantenna.antenna_rotation_matrix(*JDET.get_antenna_orientation(7, cid))
    tpl = jantenna.build_analytic_template("analytic_LPDA", freqs)
    return np.asarray(jantenna.analytic_vel(zenith, azimuth, rot, tpl, 0)[0])


def _fit(cls_name, event_fn, **kw):
    out = []
    for ev, par, mod, det, extra in ((jev, jpar, jdir, JDET, {}),
                                     (tev, tpar, tdir, TDET, {"device": "cpu"})):
        evt, st = event_fn(ev)
        fitter = getattr(mod, cls_name)(**extra)
        fitter.begin()
        fitter.run(evt, st, det, **kw)
        stnp = par.stationParameters
        out.append((st[stnp.zenith], st[stnp.azimuth]))
    return out


def test_correlation_fitter_same_direction():
    (zj, aj), (zt, at) = _fit("correlationDirectionFitter", examples.plane_wave_event,
                              n_index=1.0, channel_pairs=((0, 2), (1, 3)))
    assert abs(zt - zj) < ANGLE_TOL and abs(at - aj) < ANGLE_TOL
    assert abs(zt - np.deg2rad(55.0)) < 2.5 * units.deg


def test_beamforming_fitter_same_direction():
    (zj, aj), (zt, at) = _fit(
        "beamFormingDirectionFitter",
        lambda ev: examples.beamforming_event(ev, _vel_theta),
        polarization=0, n_index=1.0, channels=[0, 1, 2, 3],
        passband=(120 * units.MHz, 300 * units.MHz))
    assert abs(zt - zj) < ANGLE_TOL and abs(at - aj) < ANGLE_TOL
    assert abs(zt - np.deg2rad(122.0)) < 2.5 * units.deg


def test_beamforming_score_matches():
    """The batched score at 64 random directions, rtol 1e-10."""
    evt, st = examples.beamforming_event(jev, _vel_theta)
    rng = np.random.default_rng(4)
    zen = rng.uniform(np.pi / 2, np.pi, 64)
    az = rng.uniform(0, 2 * np.pi, 64)
    V = np.array([st.get_channel(c).get_frequency_spectrum() for c in range(4)])
    F = V.shape[-1]
    freqs = np.fft.rfftfreq(2 * (F - 1), 1.0)
    band = np.abs(jfilters.chain_response(
        freqs, [((0.12, 0.3), "butterabs", {"order": 10})]))
    tpl = jantenna.build_analytic_template("analytic_LPDA", freqs)
    templates = np.array([tpl] * 4)
    rots = np.array([jantenna.antenna_rotation_matrix(*JDET.get_antenna_orientation(7, c))
                     for c in range(4)])
    pos = np.array([JDET.get_relative_position(7, c) for c in range(4)])
    t0 = np.array([0.0, 0.5, 1.0, -0.25])
    kinds = np.zeros(4, dtype=np.int32)
    for pol in (0, 1):
        ref = np.asarray(jdir.beamforming_score(
            jnp.asarray(zen), jnp.asarray(az), V, band, pos, t0, rots, templates, kinds,
            pol, 1.3, 1.0))
        got = tdir.beamforming_score(
            torch.as_tensor(zen), torch.as_tensor(az), torch.as_tensor(V),
            torch.as_tensor(band), pos, t0, torch.as_tensor(rots),
            torch.as_tensor(templates), list(kinds), pol, 1.3, 1.0).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_template_fitter_same_direction():
    def event(ev):
        chp = (jpar if ev is jev else tpar).channelParameters
        evt, st = examples.plane_wave_event(ev, zenith=np.deg2rad(130.0),
                                            azimuth=np.deg2rad(20.0))
        for cid, p in enumerate(JDET.get_relative_position(7, c) for c in range(4)):
            st.get_channel(cid)[chp.nu_xcorrelations] = {
                "nu_ref_xcorr_time": jdir.get_time_delay_from_direction(
                    np.deg2rad(130.0), np.deg2rad(20.0), p, n=1.3)}
        return evt, st

    (zj, aj), (zt, at) = _fit("templateDirectionFitter", event)
    assert zt == zj and at == aj
