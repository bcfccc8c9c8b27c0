# frozen copy of nuradiomc_tpu_torch/models/ice.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
"""Exponential ice models (torch).

Counterpart of ``nuradiomc_tpu/models/ice.py``: a frozen dataclass of Python
scalars whose methods act on tensors of any shape,

    n(z) = n_ice - delta_n * exp((z - z_shift) / z_0)   for z <= z_air_boundary
    n(z) = 1                                            above the surface

Reflective-bottom sites (Moore's Bay) carry (refl_z, refl_coef,
refl_phase_shift); the parameters of the concrete sites are those of
``nuradiomc_tpu/models/ice.py:62-85``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from portbench.reference import units


@dataclasses.dataclass(frozen=True)
class IceModelSimple:
    """Exponential refractive-index profile with optional reflective bottom."""

    n_ice: float
    delta_n: float
    z_0: float
    z_shift: float = 0.0
    z_air_boundary: float = 0.0
    z_bottom: Optional[float] = None
    refl_z: Optional[float] = None
    refl_coef: Optional[float] = None
    refl_phase_shift: Optional[float] = None

    def index_of_refraction(self, z: torch.Tensor) -> torch.Tensor:
        """n(z), elementwise over ``z``."""
        n = self.n_ice - self.delta_n * torch.exp((z - self.z_shift) / self.z_0)
        return torch.where(z - self.z_air_boundary > 0, torch.ones_like(n), n)

    def average_index_of_refraction(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        """Depth-averaged n between two depths below the surface (ice.py:45)."""
        zmax = torch.maximum(z1, z2)
        zmin = torch.minimum(z1, z2)
        same = zmax == zmin
        dz = torch.where(same, torch.ones_like(zmax), zmax - zmin)
        avg = self.n_ice - self.delta_n * self.z_0 / dz * (
            torch.exp((zmax - self.z_shift) / self.z_0)
            - torch.exp((zmin - self.z_shift) / self.z_0))
        return torch.where(same, self.index_of_refraction(zmin), avg)

    @property
    def has_reflective_bottom(self) -> bool:
        return self.refl_z is not None


southpole_simple = IceModelSimple(  # RICE2014/SP
    n_ice=1.78, delta_n=0.426, z_0=71.0 * units.m, z_bottom=-2820.0 * units.m)

southpole_2015 = IceModelSimple(  # SPICE2015/SP
    n_ice=1.78, delta_n=0.423, z_0=77.0 * units.m, z_bottom=-2820.0 * units.m)

ARAsim_southpole = IceModelSimple(
    n_ice=1.78, delta_n=0.43, z_0=75.75757575757576 * units.m,
    z_bottom=-2820.0 * units.m)

ARA_2022 = IceModelSimple(
    n_ice=1.78, delta_n=0.454, z_0=49.5049505 * units.m,
    z_bottom=-2820.0 * units.m)

mooresbay_simple = IceModelSimple(  # MB1
    n_ice=1.78, delta_n=0.46, z_0=34.5 * units.m,
    refl_z=-576.0 * units.m, refl_coef=0.82, refl_phase_shift=180 * units.deg)

mooresbay_simple_2 = IceModelSimple(  # MB2
    n_ice=1.78, delta_n=0.481, z_0=37.0 * units.m,
    refl_z=-576.0 * units.m, refl_coef=0.82, refl_phase_shift=180 * units.deg)

greenland_simple = IceModelSimple(
    n_ice=1.78, delta_n=0.51, z_0=37.25 * units.m, z_bottom=-3000.0 * units.m)

uniform_ice = IceModelSimple(n_ice=1.78, delta_n=0.0, z_0=1.0 * units.m)

_MODELS = {
    "southpole_simple": southpole_simple,
    "southpole_2015": southpole_2015,
    "ARAsim_southpole": ARAsim_southpole,
    "ARA_2022": ARA_2022,
    "mooresbay_simple": mooresbay_simple,
    "mooresbay_simple_2": mooresbay_simple_2,
    "greenland_simple": greenland_simple,
    "uniform_ice": uniform_ice,
}


def get_ice_model(name: str) -> IceModelSimple:
    """Look up a named site model."""
    if name not in _MODELS:
        raise NotImplementedError(
            f"ice model '{name}' is not implemented; available: {sorted(_MODELS)}")
    return _MODELS[name]
