"""The port's IFT-style efield reconstruction against the JAX package's, on
the CPU in float64, on tests/test_ift_efield.py's four-LPDA station and
pulse from 135 deg zenith (``examples.IFT_TRUTH``), the same spectra (numpy
seed 0) through both packages:

* 135 deg arrives 45 deg off the downward LPDAs' axis, on the edge of two
  phase sectors: the sector each channel's VEL takes (the port decides it on
  the host) equals the JAX package's, and the VELs agree at rtol 1e-12;
* the loss and its gradient at the initial point: ``torch.autograd``
  against ``jax.value_and_grad`` (read from the JAX module's own optimizer
  step), rtol 1e-9;
* every parameter after 50 Adam steps (lr 0.03) within 1e-6 of the JAX
  package's, relative to max(1, |parameter|);
* the final spectrum of a 600-step run within the physics bounds of
  tests/test_ift_efield.py:62-64.
"""

import jax
import numpy as np
import optax

from nuradiomc_tpu.detector.detector import Detector as JDetector
from nuradiomc_tpu.framework import event as jev
from nuradiomc_tpu.framework import parameters as jpar
from nuradiomc_tpu.ops import antenna as jantenna
from nuradiomc_tpu.reco import efield_converters as jec
from nuradiomc_tpu.reco import ift_efield as jift
from nuradiomc_tpu_torch.detector.detector import Detector as TDetector
from nuradiomc_tpu_torch.framework import event as tev
from nuradiomc_tpu_torch.framework import parameters as tpar
from nuradiomc_tpu_torch.ops import antenna as tantenna
from nuradiomc_tpu_torch.reco import efield_converters as tec
from nuradiomc_tpu_torch.reco import examples
from nuradiomc_tpu_torch.reco import ift_efield as tift

JDET = JDetector(examples.MIXED_DETECTOR)
TDET = TDetector(examples.MIXED_DETECTOR)
BEGIN = dict(passband=examples.IFT_TRUTH["band"], noise_rms=examples.IFT_TRUTH["noise"])


def _vel(cid, ff, zen, az):
    return jec.get_channel_vel(JDET, 7, cid, ff, zen, az)


def _jax_run(n_iter):
    reco = jift.iftElectricFieldReconstructor()
    reco.begin(n_iterations=n_iter, **BEGIN)
    evt, st = examples.ift_event(jev, jpar, _vel)
    reco.run(evt, st, JDET, use_channels=[0, 1, 2, 3])
    return reco


def _port(n_iter=600):
    reco = tift.iftElectricFieldReconstructor(device="cpu")
    reco.begin(n_iterations=n_iter, **BEGIN)
    evt, st = examples.ift_event(tev, tpar, _vel)
    return reco, evt, st


def test_lpda_sector_at_the_edge_matches_jax():
    zen, az = examples.IFT_TRUTH["zenith"], examples.IFT_TRUTH["azimuth"]
    ff = np.fft.rfftfreq(512, 1.0)
    sectors = []
    for cid in range(4):
        rot = tantenna.antenna_rotation_matrix(*TDET.get_antenna_orientation(7, cid))
        port = int(tantenna.lpda_sector_host(zen, az, rot, tantenna.KIND_LPDA))
        jax_sector = int(jantenna.analytic_vel_mix(zen, az, rot, jantenna.KIND_LPDA)[2])
        assert port == jax_sector, (cid, port, jax_sector)
        sectors.append(port)
        for a, b in zip(tec.get_channel_vel(TDET, 7, cid, ff, zen, az, device="cpu"),
                        _vel(cid, ff, zen, az)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-12 * np.max(np.abs(b)))
    # the edge is real: the channels do not all take one sector
    assert len(set(sectors)) > 1, sectors


def test_loss_and_gradient_at_start(monkeypatch):
    """The JAX module's first optimizer step, run eagerly, hands its
    gradient to a recording Adam."""
    seen = []
    real_adam = optax.adam

    def recording_adam(lr):
        inner = real_adam(lr)

        def update(grads, state, params=None):
            seen.append(jax.tree.map(np.asarray, grads))
            return inner.update(grads, state, params)

        return optax.GradientTransformation(inner.init, update)

    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(optax, "adam", recording_adam)
    jreco = _jax_run(1)
    monkeypatch.undo()

    treco, _, st = _port()
    params = treco.setup(st, TDET, (0, 1, 2, 3))
    for p in params.values():
        p.requires_grad_(True)
    loss = treco.loss(params)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jreco.final_loss, rtol=1e-9)
    for name in tift.PARAM_NAMES:
        np.testing.assert_allclose(params[name].grad.numpy(), seen[0][name], rtol=1e-9,
                                   atol=1e-9 * np.max(np.abs(seen[0][name])), err_msg=name)


def test_parameters_after_50_steps():
    jreco = _jax_run(50)
    treco, evt, st = _port(50)
    treco.run(evt, st, TDET, use_channels=[0, 1, 2, 3])
    for name in tift.PARAM_NAMES:
        a, b = np.atleast_1d(treco.params[name]), np.atleast_1d(np.asarray(jreco.params[name]))
        assert np.all(np.abs(a - b) <= 1e-6 * np.maximum(1.0, np.abs(b))), name
    np.testing.assert_allclose(treco.final_loss, jreco.final_loss, rtol=1e-6)


def test_full_run_physics():
    treco, evt, st = _port(600)
    ef = treco.run(evt, st, TDET, use_channels=[0, 1, 2, 3])
    ff = np.fft.rfftfreq(512, 1.0)
    band = (ff >= 0.08) & (ff <= 0.45)
    spec = np.asarray(ef.get_frequency_spectrum())
    amp_rec = np.sqrt(np.abs(spec[1][band]) ** 2 + np.abs(spec[2][band]) ** 2)
    amp_true = np.abs(examples.ift_true_spectrum(ff)[band])
    good = amp_true > 10 * examples.IFT_TRUTH["noise"]
    assert np.median(np.abs(amp_rec[good] / amp_true[good] - 1)) < 0.25
    assert abs(ef[tpar.electricFieldParameters.polarization_angle]
               - examples.IFT_TRUTH["pol"]) < 0.15
    assert np.isfinite(treco.final_loss)
