"""HCRB2017 fully-analytic Askaryan model (Hanson & Connolly, Astropart.
Phys. 91, 75-89 (2017)), torch.

Counterpart of ``nuradiomc_tpu/ops/hcrb2017.py`` (reference
NuRadioMC/SignalGen/HCRB2017.py). The shower width and excess-charge
normalization (Nmax, a) come from a profile construction and a Gaussian fit
on the host per shower, cached (``get_N_AskDepthA``, a numpy copy of
hcrb2017.py:31: that module imports jax). The frequency-domain field
(eR, eTheta) is closed form and elementwise over the batch axes of
``theta`` / ``R`` (``get_E_omega``). A stand-alone op: the pipeline does not
call it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from nuradiomc_tpu_torch.utils import units
from nuradiomc_tpu_torch.utils.constants import speed_of_light

ICE_DENSITY = 0.9167 * units.g / units.cm ** 3
ICE_RAD_LENGTH = 36.08 * units.g / units.cm ** 2
_strictLowFreqLimit = True


def _gauss(x, A, mu, sigma):
    return A * np.exp(-(x - mu) ** 2 / 2 / sigma ** 2)


# copied from nuradiomc_tpu/ops/hcrb2017.py:31 (get_N_AskDepthA)
@functools.lru_cache(maxsize=4096)
def get_N_AskDepthA(E: float, EM: bool = True, LPM: bool = True):
    """(Nmax, askaryan_depth_a): Greisen (EM) / Gaisser-Hillas (HAD) widths
    with optional LPM parameterization (HCRB2017.get_N_AskDepthA:200-296)."""
    from scipy.optimize import curve_fit

    if EM:
        E_CRIT = 0.073 * units.GeV
        dx = 0.01
        x = np.arange(0.01, 5000.0, dx)
        a_ = 0.31 / np.log(E / E_CRIT) ** 0.5
        d = np.log(3 * x / (x + 2 * np.log(E / E_CRIT)))
        nx = a_ * np.exp(x - 1.5 * x * d)
    else:
        dx = 1.0 * units.g / units.cm ** 2
        x = np.arange(dx, 200000.0 * units.g / units.cm ** 2, dx)
        S0, X0 = 0.11842, 39.562 * units.g / units.cm ** 2
        lam, Ec = 113.03 * units.g / units.cm ** 2, 0.17006 * units.GeV
        Xmax = X0 * np.log(E / Ec)
        a_ = S0 * E / Ec * (Xmax - lam) / Xmax * np.exp(Xmax / lam - 1)
        nx = a_ * np.power(x / (Xmax - lam), Xmax / lam) * np.exp(-x / lam)

    n_max_position = int(np.argmax(nx))
    n_max = float(np.max(nx))
    if EM:
        excess = 0.09 + dx * n_max_position * ICE_RAD_LENGTH / ICE_DENSITY / 100.0
    else:
        excess = 0.09 + dx * n_max_position / ICE_DENSITY * 1.0e-2
    Nmax = excess * n_max / 1000.0

    fit_region_cut = 0.95
    cut_left = np.argwhere((nx[:n_max_position] / nx[n_max_position]) > fit_region_cut)[0][0]
    cut_right = np.argwhere((nx[n_max_position:] / nx[n_max_position]) < fit_region_cut)[0][0] + n_max_position
    fit_width = cut_right - cut_left
    vic = nx[n_max_position - fit_width:n_max_position + fit_width] / nx[n_max_position]
    sigma = curve_fit(_gauss, np.arange(len(vic)), vic)[0]
    if EM:
        depth_a = dx * sigma[2] / ICE_DENSITY * ICE_RAD_LENGTH
    else:
        depth_a = dx * sigma[2] / ICE_DENSITY

    if EM and LPM:
        p = (-2.8564e2, 7.8140e1, -8.3893, 4.4175e-1, -1.1382e-2, 1.1493e-4)
        e = np.log10(E / units.eV)
        log10_depth = (p[0] + p[1] * e + p[2] * e ** 2 + p[3] * e ** 3
                       + p[4] * e ** 4 + p[5] * e ** 5)
        a_lpm = 10.0 ** log10_depth * 0.5
        if _strictLowFreqLimit:
            Nmax = Nmax / (a_lpm / depth_a)
        depth_a = a_lpm
    return float(Nmax), float(depth_a)


def get_E_omega(ff, E, R, theta, n_index, Nmax, depth_a,
                use_form_factor=True,
                rho0=1.0 / (np.sqrt(2.0 * np.pi) * 0.03 * units.m)):
    """(eR(f), eTheta(f)) closed form (HCRB2017._get_E_omega:122-193), on
    the broadcast of ``ff`` [F] with ``R`` / ``theta`` [..., 1]."""
    cos_tc = 1.0 / n_index
    k = 2 * math.pi * ff / speed_of_light * n_index
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    eta = k * depth_a ** 2 / R * sin_t ** 2

    # I(f,f) factor (:108-120)
    re_d = 1 - 3 * eta ** 2 * cos_t / sin_t ** 2 * (cos_t - cos_tc) / (1 + eta ** 2)
    im_d = -eta - 3 * eta ** 3 * cos_t / sin_t ** 2 * (cos_t - cos_tc) / (1 + eta ** 2)
    denom = torch.complex(re_d, im_d)
    power = (-0.5 * (k * depth_a) ** 2 * (cos_t - cos_tc) ** 2 / (1 + eta ** 2)
             * torch.complex(torch.ones_like(eta), eta))
    I_FF = torch.exp(power) / torch.sqrt(denom)

    nu = speed_of_light * k / (2 * math.pi)
    norm = 2.52e-7 * 1e3 * depth_a * Nmax * nu / R
    psi = torch.complex(sin_t * torch.sin(k * R), -sin_t * torch.cos(k * R))

    r_num = -(cos_t - cos_tc) / sin_t
    eR = I_FF * norm * psi * r_num
    t_num = torch.complex(
        1 + eta ** 2 / (1 + eta) ** 2 * cos_tc / sin_t ** 2 * (cos_t - cos_tc),
        -(eta / (1 + eta) ** 2 * cos_tc / sin_t ** 2 * (cos_t - cos_tc)))
    eTheta = I_FF * norm * psi * t_num

    if use_form_factor:
        af = k / rho0
        bf = sin_t / math.sqrt(2.0 * math.pi)
        atten = (1 + af ** 2 * bf ** 2) ** -1.5
        eR = eR * atten
        eTheta = eTheta * atten
    return eR, eTheta


def get_time_trace(energy, theta, N: int, dt: float, is_em_shower: bool,
                   n_index, R, LPM: bool = True, a=None):
    """(eR, eTheta, ePhi) time traces [..., 3, N] (HCRB2017:34-66) of one
    shower (``energy`` and ``is_em_shower`` are Python scalars) seen from the
    viewing angles ``theta`` and distances ``R`` (tensors of one shape)."""
    Nmax, depth_a = get_N_AskDepthA(float(energy), bool(is_em_shower), LPM)
    if a is not None:
        depth_a = a
    theta = torch.as_tensor(theta)
    R = torch.as_tensor(R, dtype=theta.dtype, device=theta.device)
    ff = torch.fft.rfftfreq(N, dt, dtype=theta.dtype, device=theta.device)
    eR, eTheta = get_E_omega(ff, energy, R[..., None], theta[..., None], n_index,
                             Nmax, depth_a)
    traceR = torch.fft.irfft(eR, n=N) / dt
    traceTheta = torch.fft.irfft(eTheta, n=N) / dt
    return torch.stack([traceR, traceTheta, torch.zeros_like(traceTheta)], dim=-2)
