# frozen copy of nuradiomc_tpu_torch/ops/askaryan.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
"""Askaryan emission, ZHS1992, Alvarez2000 and Alvarez2009 (torch).

Counterpart of ``nuradiomc_tpu/ops/askaryan.py`` for the parametrised models
(reference NuRadioMC/SignalGen/parametrizations.py:92-275). The inputs are
tensors of one batch shape; the frequency axis is appended last. The roll of
the reference's time trace is a linear phase, so the spectrum matches
``fft.time2freq(get_time_trace(...))``:

    spec(f) = sqrt(2) * S(f) * i * exp(-2 pi i f k dt)

with k = N // 2 (the window centre) for the Alvarez models and k = 2 ns / dt
for ZHS1992. Alvarez2009's stochastic EM parameter ``k_L`` is an input, drawn
per shower on the host by :func:`draw_alvarez2009_k_L` (numpy, a copy of the
JAX package's). The semi-analytic ARZ models live in ``ops/arz.py`` and
HCRB2017 in ``ops/hcrb2017.py``; their names raise here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import units
from portbench.reference.constants import speed_of_light

# the parametrized spectra of this module (askaryan.py:35)
MODELS = ("ZHS1992", "Alvarez2000", "Alvarez2009")


def _freqs(N: int, dt: float, like: torch.Tensor):
    return torch.fft.rfftfreq(N, dt, dtype=like.dtype, device=like.device)


def spectrum_zhs1992(energy, theta, N: int, dt: float, is_em, n_index, R):
    """ZHS1992 raw spectrum S(f) [..., F] (askaryan.py:49); EM and HAD alike."""
    del is_em
    ff = _freqs(N, dt, theta)
    vv0 = ff / (0.5 * units.GHz)
    domega = (theta - torch.arccos(1.0 / n_index))[..., None]
    mag = (1.1e-7 * energy[..., None] / units.TeV * vv0 / (1 + 0.4 * vv0 ** 2)
           * torch.exp(-0.5 * (domega * vv0 / (2.4 * units.deg)) ** 2)
           * units.V / units.m / (R[..., None] / units.m) / units.MHz)
    return 0.5 * mag  # ZHS fourier normalization factor


def spectrum_alvarez2000(energy, theta, N: int, dt: float, is_em, n_index, R):
    """Alvarez2000 raw spectrum S(f) [..., F] (askaryan.py:62)."""
    ff = _freqs(N, dt, theta)
    fpos = torch.where(ff > 0, ff, 1.0)
    e = energy[..., None]
    theta = theta[..., None]
    cherenkov = torch.arccos(1.0 / n_index)[..., None]

    Elpm = 2e15 * units.eV
    dThetaEM = (2.7 * units.deg * 500 * units.MHz / fpos
                * (Elpm / (0.14 * e + Elpm)) ** 0.3)

    epsilon = torch.log10(e / units.TeV)
    base = 500 * units.MHz / fpos * units.deg
    dHad_0_2 = base * (2.07 - 0.33 * epsilon + 7.5e-2 * epsilon ** 2)
    dHad_2_5 = base * (1.74 - 1.21e-2 * epsilon)
    dHad_5_7 = base * (4.23 - 0.785 * epsilon + 5.5e-2 * epsilon ** 2)
    dHad_7p = (base * (4.23 - 0.785 * 7 + 5.5e-2 * 49)
               * (1 + (epsilon - 7) * 0.075))
    dThetaHad = torch.where(
        epsilon <= 2, dHad_0_2,
        torch.where(epsilon <= 5, dHad_2_5,
                    torch.where(epsilon <= 7, dHad_5_7, dHad_7p)))
    had_valid = epsilon >= 0

    f0 = 1.15 * units.GHz
    E = (2.53e-7 * e / units.TeV * ff / f0 / (1 + (fpos / f0) ** 1.44)
         * units.V / units.m / units.MHz
         * torch.sin(theta) / torch.sin(cherenkov))

    f_eps = (-1.27e-2 - 4.76e-2 * (epsilon + 3) - 2.07e-3 * (epsilon + 3) ** 2
             + 0.52 * torch.sqrt(epsilon + 3))

    is_em = is_em[..., None]
    dTheta = torch.where(is_em, dThetaEM, dThetaHad)
    scale = torch.where(is_em, 1.0, torch.where(had_valid, f_eps, 0.0))
    spec = (E * torch.exp(-math.log(2.0) * ((theta - cherenkov) / dTheta) ** 2)
            / R[..., None] * scale)
    spec = torch.where(ff > 0, spec, 0.0)
    return 0.5 * spec


# ---- Alvarez2009 k_L host draw, copied from nuradiomc_tpu/ops/askaryan.py:105-127

def had_k_L_alvarez2009(energy):
    """Deterministic hadronic k_L parameter (parametrizations.py:140-144)."""
    return 31.25 * (energy / (1.0e15 * units.eV)) ** 3.01e-2


def em_k_L_params_alvarez2009(energy):
    """(log10_k_L_bar, sigma_k_L) of the EM k_L distribution (:146-172)."""
    log10_E0 = np.log10(energy / units.eV)
    sigma_0, delta_1, log10_E_sigma = 3.39e-2, 2.25e-2, 14.99
    sigma = np.where(log10_E0 < log10_E_sigma, sigma_0,
                     sigma_0 + delta_1 * (log10_E0 - log10_E_sigma))
    log10_k0, log10_E_LPM, gamma_0, gamma_1 = 1.52, 16.61, 5.59e-2, 0.39
    log10_bar = np.where(log10_E0 < log10_E_LPM,
                         log10_k0 + gamma_0 * (log10_E0 - log10_E_LPM),
                         log10_k0 + gamma_1 * (log10_E0 - log10_E_LPM))
    return log10_bar, sigma


def draw_alvarez2009_k_L(energy, is_em, rng: np.random.Generator):
    """Host-side per-shower k_L draw (EM: log-normal; HAD: deterministic)."""
    log10_bar, sigma = em_k_L_params_alvarez2009(np.asarray(energy))
    em_draw = 10 ** rng.normal(log10_bar, sigma)
    return np.where(np.asarray(is_em), em_draw, had_k_L_alvarez2009(np.asarray(energy)))


# ice density, radiation length and Moliere radius enter only through ratios;
# units.g alone (~5.8e39) overflows float32, so combine them in float64 here
_RHO = 0.924 * units.g / units.cm ** 3
_X0_OVER_RHO = float((36.08 * units.g / units.cm ** 2) / _RHO)     # ~0.39 m
_RHO_OVER_X0 = float(_RHO / (36.08 * units.g / units.cm ** 2))     # ~2.56 / m
_RHO_OVER_RM = float(_RHO / (10.57 * units.g / units.cm ** 2))     # ~8.74 / m


def spectrum_alvarez2009(energy, theta, N: int, dt: float, is_em, n_index, R, k_L):
    """Alvarez2009 raw spectrum S(f) [..., F] (askaryan.py:130-169)."""
    ff = _freqs(N, dt, theta)
    fpos = torch.where(ff > 0, ff, 1.0)
    e = energy[..., None]
    theta = theta[..., None]
    n_index = n_index[..., None]
    is_em = is_em[..., None]
    log10_e = torch.log10(e / units.eV)

    # amplitude A
    k_E_bar_had = (4.13e-16 * units.V / units.cm / units.MHz ** 2
                   * torch.tanh((log10_e - 10.60) / 2.54))
    k_E_bar = torch.where(is_em, 4.65e-16 * units.V / units.cm / units.MHz ** 2,
                          k_E_bar_had)
    A = k_E_bar * e / (73.1 * units.MeV) * _X0_OVER_RHO * torch.sin(theta) * ff

    # longitudinal form factor d_L
    denom = torch.clamp(torch.abs(1 - n_index * torch.cos(theta)), min=1e-8)
    nu_L = _RHO_OVER_X0 / k_L[..., None] * speed_of_light / denom
    # a where of two Python numbers would be float32, whatever e's dtype
    beta = torch.where(is_em, e.new_tensor(2.74), e.new_tensor(2.57))
    d_L = 1.0 / (1 + (fpos / nu_L) ** beta)

    # lateral form factor d_R
    k_R_bar = torch.where(is_em, 1.54, 2.73 + torch.tanh((12.92 - log10_e) / 1.72))
    nu_R = _RHO_OVER_RM / k_R_bar * speed_of_light / torch.sqrt(n_index ** 2 - 1)
    d_R = 1.0 / (1 + (fpos / nu_R) ** 1.27)

    spec = A * d_L * d_R * 0.5 / R[..., None]
    return torch.where(ff > 0, spec, 0.0)


def get_frequency_spectrum(energy, theta, N: int, dt: float, is_em, n_index,
                           R, model: str, k_L=None):
    """NuRadioMC-normalized eTheta spectrum [..., F] (askaryan.py:179)."""
    k = N // 2  # Alvarez2000 / Alvarez2009 centre the pulse
    if model == "ZHS1992":
        S = spectrum_zhs1992(energy, theta, N, dt, is_em, n_index, R)
        k = int(2 * units.ns / dt)
    elif model == "Alvarez2000":
        S = spectrum_alvarez2000(energy, theta, N, dt, is_em, n_index, R)
    elif model == "Alvarez2009":
        if k_L is None:
            raise ValueError("Alvarez2009 requires a per-shower k_L (draw on host)")
        S = spectrum_alvarez2009(energy, theta, N, dt, is_em, n_index, R, k_L)
    else:
        raise NotImplementedError(
            f"Askaryan model {model} is not a parametrized spectrum of this module "
            "(ARZ2019 / ARZ2020: ops/arz.py; HCRB2017: ops/hcrb2017.py)")
    ff = _freqs(N, dt, theta)
    ctype = torch.complex128 if S.dtype == torch.float64 else torch.complex64
    # 90 deg phase + roll to the window centre + sqrt(2) rFFT normalization
    roll = torch.exp(torch.complex(torch.zeros_like(ff), -2 * math.pi * ff * k * dt))
    return math.sqrt(2.0) * S.to(ctype) * 1j * roll
