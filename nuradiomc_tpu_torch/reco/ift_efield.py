"""Bayesian (IFT-style) electric-field reconstruction (torch).

Counterpart of ``nuradiomc_tpu/reco/ift_efield.py`` (reference
NuRadioReco/modules/iftElectricFieldReconstructor :1-986, which runs Metric
Gaussian Variational Inference with NIFTy5 over a correlated-field prior on
the E-field spectrum). The same differentiable forward model and MAP
optimization as the JAX package:

prior (standardized latents xi ~ N(0,1)):
    log|E|(f)   = offset + slope * f + sigma * (K^{1/2} xi_amp)   (GP fluct.)
    phase(f)    = phi0 + 2 pi f t0                                 (time shift)
    polarization: mixing angle between eTheta and ePhi

likelihood: every channel's measured spectrum against the E-field folded
through its antenna response, Gaussian noise. MAP = minimize
chi2/2 + |xi|^2/2 over all latents with ``torch.optim.Adam`` on the
``torch.autograd`` gradient, on the module's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.framework.event import ElectricField
from nuradiomc_tpu_torch.reco.base import Module, host, register_run, spectrum_tensor
from nuradiomc_tpu_torch.reco.efield_converters import get_channel_vel
from nuradiomc_tpu_torch.utils import units

efp = par.electricFieldParameters
stnp = par.stationParameters

PARAM_NAMES = ("xi", "offset", "slope", "phi0", "t0", "pol")


# copied from nuradiomc_tpu/reco/ift_efield.py:39-45
def _gp_sqrt_kernel(ff, correlation_length):
    """Square root of a squared-exponential prior covariance on the
    frequency axis (dense Cholesky, host-side)."""
    d = (ff[:, None] - ff[None, :]) / correlation_length
    K = np.exp(-0.5 * d ** 2) + 1e-8 * np.eye(len(ff))
    return np.linalg.cholesky(K)


class iftElectricFieldReconstructor(Module):

    def begin(self, passband=None, noise_rms=None,
              correlation_length=100 * units.MHz, sigma_amp=1.0,
              n_iterations=600, learning_rate=0.03,
              antenna_replacements=None):
        self._passband = passband
        self._noise_rms = noise_rms
        self._clen = correlation_length
        self._sigma_amp = sigma_amp
        self._n_iter = n_iterations
        self._lr = learning_rate
        self._reps = antenna_replacements or {}

    def setup(self, station, det, use_channels=(0, 1, 2, 3)):
        """The fixed inputs of the fit (data, antenna responses, prior) and
        the initial parameters; sets ``self.loss`` / ``self.forward`` and
        returns the parameters as a dict of leaf tensors on the device."""
        station_id = station.get_id()
        zenith = station[stnp.zenith]
        azimuth = station[stnp.azimuth]
        ch0 = station.get_channel(use_channels[0])
        fs = ch0.get_sampling_rate()
        n_t = ch0.get_number_of_samples()
        ff = np.fft.rfftfreq(n_t, 1.0 / fs)

        band = (ff > 0)
        if self._passband is not None:
            band = (ff >= self._passband[0]) & (ff <= self._passband[1])
        band_t = self.tensor(band)
        ffb = ff[band]

        V_data = torch.stack([spectrum_tensor(station.get_channel(c), self.device)[band_t]
                              for c in use_channels])
        vel = [get_channel_vel(det, station_id, cid, ff, zenith, azimuth, self._reps,
                               device=self.device) for cid in use_channels]
        vel_t = torch.stack([v[0][band_t] for v in vel])
        vel_p = torch.stack([v[1][band_t] for v in vel])

        noise = self._noise_rms
        if noise is None:
            # spectral noise scale from the quietest quarter of the data
            noise = float(np.median(np.abs(host(V_data)))) + 1e-12

        L = self.tensor(_gp_sqrt_kernel(ffb, self._clen))
        scale0 = float(np.median(np.abs(host(V_data)))
                       / max(np.median(np.abs(host(vel_t)) + np.abs(host(vel_p))), 1e-12))
        ffj = self.tensor(ffb)
        two_noise2 = torch.tensor(2 * noise ** 2, dtype=torch.float64, device=self.device)
        sigma = self._sigma_amp

        def forward(params):
            log_amp = (params["offset"]
                       + params["slope"] * (ffj - ffj[0]) / (ffj[-1] - ffj[0])
                       + sigma * (L @ params["xi"]))
            amp = torch.exp(log_amp) * scale0
            phase = params["phi0"] + 2 * math.pi * ffj * params["t0"]
            E = amp * torch.complex(torch.cos(phase), torch.sin(phase))
            e_t = torch.cos(params["pol"]) * E
            e_p = torch.sin(params["pol"]) * E
            return vel_t * e_t[None, :] + vel_p * e_p[None, :], (e_t, e_p)

        def loss(params):
            model, _ = forward(params)
            chi2 = torch.sum(torch.abs(model - V_data) ** 2) / two_noise2
            prior = 0.5 * (torch.sum(params["xi"] ** 2) + params["offset"] ** 2 / 9.0
                           + params["slope"] ** 2 / 25.0)
            return chi2 + prior

        # the chi2 is violently multimodal in the pulse time t0: initialize
        # it with a matched filter (sum of antenna-deconvolved correlations)
        full = torch.zeros((len(use_channels), len(ff)), dtype=torch.complex128,
                           device=self.device)
        full[:, band_t] = torch.conj(vel_t + vel_p) * V_data
        mf = torch.sum(torch.abs(torch.fft.irfft(full, n_t)), dim=0)
        t0_init = float(int(torch.argmax(mf)) / fs)

        self.forward, self.loss = forward, loss
        self._meta = (fs, ff, band, zenith, azimuth, use_channels)
        zero = torch.zeros((), dtype=torch.float64, device=self.device)
        return {"xi": torch.zeros(len(ffb), dtype=torch.float64, device=self.device),
                "offset": zero.clone(), "slope": zero.clone(), "phi0": zero.clone(),
                "t0": zero - t0_init, "pol": zero + 0.7}

    @register_run()
    def run(self, evt, station, det, use_channels=(0, 1, 2, 3), efield_scaling=True):
        params = self.setup(station, det, use_channels)
        for p in params.values():
            p.requires_grad_(True)
        opt = torch.optim.Adam(list(params.values()), lr=self._lr)
        val = None
        for _ in range(self._n_iter):
            opt.zero_grad()
            val = self.loss(params)
            val.backward()
            opt.step()

        fs, ff, band, zenith, azimuth, use_channels = self._meta
        with torch.no_grad():
            _, (e_t, e_p) = self.forward(params)
        spec = np.zeros((3, len(ff)), dtype=complex)
        spec[1][band] = host(e_t)
        spec[2][band] = host(e_p)
        ef = ElectricField(list(use_channels))
        ef.set_frequency_spectrum(spec, fs)
        ef[efp.zenith] = zenith
        ef[efp.azimuth] = azimuth
        dt = 1.0 / fs
        fluence = np.sum(np.asarray(ef.get_trace()) ** 2, axis=1) * dt \
            / (376.730313667 * units.ohm)
        ef[efp.signal_energy_fluence] = fluence
        ef[efp.polarization_angle] = float(np.mod(float(params["pol"].detach()), np.pi))
        station.add_electric_field(ef)
        self.final_loss = float(val.detach())
        self.params = {k: host(v) for k, v in params.items()}
        return ef
