"""Stratified ice profiles beyond the single exponential (torch).

Counterpart of ``nuradiomc_tpu/models/ice_profiles.py``: the reference's
RadioPropa-only models (utilities/medium.py) greenland_firn (:156-293, a
double exponential), greenland_poly5 (:318-338, an exponential-polynomial
density fit) and a perturbation-layer profile, as frozen dataclasses of
Python numbers whose ``index_of_refraction`` acts elementwise on tensors of
any shape. ``ops/raytrace_numeric.py`` and ``ops/raytrace_3d.py`` consume
them; the parameters are those of ice_profiles.py:70-126.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nuradiomc_tpu_torch.utils import units


@dataclasses.dataclass(frozen=True)
class FirnIceModel:
    """Piecewise multi-exponential profile: in segment k (z <= z_top[k]),
    n(z) = n_ice[k] - delta_n[k] * exp((z - z_shift[k]) / z_0[k]); 1 above
    the surface."""

    z_tops: tuple          # segment upper boundaries, descending; first = 0
    n_ice: tuple
    delta_n: tuple
    z_0: tuple
    z_shift: tuple
    z_bottom: float = -3000.0 * units.m

    def index_of_refraction(self, z: torch.Tensor) -> torch.Tensor:
        z = torch.as_tensor(z)
        seg = torch.zeros(z.shape, dtype=torch.int32, device=z.device)
        for k, zt in enumerate(self.z_tops[1:], start=1):
            seg = torch.where(z <= zt, k, seg)
        n = torch.ones_like(z)
        for k in range(len(self.z_tops)):
            nk = self.n_ice[k] - self.delta_n[k] * torch.exp((z - self.z_shift[k]) / self.z_0[k])
            n = torch.where(seg == k, nk, n)
        return torch.where(z > 0, torch.ones_like(n), n)


@dataclasses.dataclass(frozen=True)
class ExponentialPolynomialIceModel:
    """n(z) = 1 + density_factor * sum_i a_i exp(i (z - z_shift)/z_0)
    (medium_base.IceModelExponentialPolynomial:424-501)."""

    a: tuple
    z_0: float
    density_factor: float
    z_shift: float = 0.0
    z_bottom: float = -3000.0 * units.m

    def index_of_refraction(self, z: torch.Tensor) -> torch.Tensor:
        z = torch.as_tensor(z)
        x = torch.exp((z - self.z_shift) / self.z_0)
        rho = torch.zeros_like(x)
        for i, ai in enumerate(self.a):
            rho = rho + ai * x ** i
        return torch.where(z > 0, torch.ones_like(rho), 1.0 + rho * self.density_factor)


@dataclasses.dataclass(frozen=True)
class PerturbedIceModel:
    """A stratified base profile plus a horizontal layer: n(z) = n_base(z)
    + fraction * amplitude * exp(-((z - z_center) / width)^2 / 2) below the
    surface (ice_profiles.py:89-127; the reference's greenland_perturbation,
    medium.py:294-316, whose layer comes from radiopropa). The default
    amplitude keeps n(z) monotone, as the two-branch stratified solver
    requires."""

    base: object                      # profile with index_of_refraction(z)
    z_center: float = -100.0 * units.m
    width: float = 2.0 * units.m
    fraction: float = 1.0
    amplitude: float = 0.001          # peak dn of the layer
    z_bottom: float = -3000.0 * units.m

    def index_of_refraction(self, z: torch.Tensor) -> torch.Tensor:
        z = torch.as_tensor(z)
        n = self.base.index_of_refraction(z)
        bump = self.fraction * self.amplitude * torch.exp(
            -0.5 * ((z - self.z_center) / self.width) ** 2)
        return torch.where(z > 0, torch.ones_like(n), n + bump)


# double exponential at Summit, Greenland (medium.py:203-216)
greenland_firn = FirnIceModel(
    z_tops=(0.0, -14.9 * units.m),
    n_ice=(1.78, 1.78),
    delta_n=(0.502, 0.310),
    z_0=(30.8 * units.m, 40.9 * units.m),
    z_shift=(0.0, -14.9 * units.m),
)

# fifth-degree exponential polynomial at Summit (medium.py:318-338)
greenland_poly5 = ExponentialPolynomialIceModel(
    a=tuple(np.array([917, -62.2, 1177, -9051, 14360, -7024])
            * (units.kg / units.m ** 3)),
    z_0=74.6 * units.m,
    density_factor=0.851 * (units.cm ** 3 / units.gram),
)

greenland_perturbation = PerturbedIceModel(base=greenland_firn)

PROFILES = {
    "greenland_firn": greenland_firn,
    "greenland_poly5": greenland_poly5,
    "greenland_perturbation": greenland_perturbation,
}


def get_profile(name: str):
    if name not in PROFILES:
        raise NotImplementedError(f"ice profile {name} not implemented")
    return PROFILES[name]
