"""Layered atmosphere model + refractivity for air-shower reconstruction (torch).

Counterpart of ``nuradiomc_tpu/models/atmosphere.py``. :class:`Atmosphere`
(Linsley 5-layer parameterizations, curved-Earth slant depth) stays host
numpy: the reconstructions call it for a handful of depths. The straight-line
refractivity integral of :class:`Refractivity` is the batched part: the
interferometric fits ask for the light travel time from thousands of points
in the atmosphere to every antenna at once, so it works on tensors over
leading axes ``[points, observers]`` on their device.

All heights in internal units (meters); mass overburden in g/cm^2.
"""

from __future__ import annotations

import numpy as np
import torch

from nuradiomc_tpu_torch.utils import units

R_EARTH = 6.371e6 * units.m


# copied from nuradiomc_tpu/models/atmosphere.py:23-173
# Linsley parameterizations: layer boundaries [m], a,b [g/cm^2], c [cm].
# Model 1: US standard atmosphere (CORSIKA builtin); model 17: US standard
# after Keilhauer (the common radiotools default).
ATM_MODELS = {
    1: {
        "h": np.array([0.0, 4e3, 1e4, 4e4, 1e5]),
        "a": np.array([-186.555305, -94.919, 0.61289, 0.0, 0.01128292]),
        "b": np.array([1222.6562, 1144.9069, 1305.5948, 540.1778, 1.0]),
        "c": np.array([994186.38, 878153.55, 636143.04, 772170.16, 1e9]),
    },
    17: {
        "h": np.array([0.0, 7e3, 11.4e3, 37e3, 1e5]),
        "a": np.array([-149.801663, -57.932486, 0.63631894, 4.35453690e-4,
                       0.01128292]),
        "b": np.array([1183.6071, 1143.0425, 1322.9748, 655.67307, 1.0]),
        "c": np.array([954248.34, 800005.34, 629568.93, 737521.77, 1e9]),
    },
}

M_TO_CM = 100.0


class Atmosphere:
    """Linsley atmosphere with curved-Earth slant-depth integrals."""

    def __init__(self, model=17, n_taylor=5, curved=True):
        if model not in ATM_MODELS:
            raise ValueError(f"unknown atmosphere model {model}")
        self.model = model
        p = ATM_MODELS[model]
        self._hb = p["h"]
        self._a, self._b, self._c = p["a"], p["b"], p["c"]
        # top of the atmosphere: X_v = 0 in the linear layer
        self.h_max = self._a[4] * self._c[4] / self._b[4] / M_TO_CM

    def _layer(self, h):
        return np.clip(np.searchsorted(self._hb, h, side="right") - 1, 0, 4)

    def get_vertical_depth(self, h):
        """Vertical mass overburden X_v(h) in g/cm^2 (h in m)."""
        h = np.asarray(h, dtype=float)
        i = self._layer(h)
        h_cm = h * M_TO_CM
        exp_part = self._a[i] + self._b[i] * np.exp(-h_cm / self._c[i])
        lin_part = self._a[4] - self._b[4] * h_cm / self._c[4]
        out = np.where(i < 4, exp_part, lin_part)
        return np.where(h >= self.h_max, 0.0, out)

    def get_density(self, h):
        """rho(h) in g/cm^3."""
        h = np.asarray(h, dtype=float)
        i = self._layer(h)
        h_cm = h * M_TO_CM
        rho = np.where(i < 4, self._b[i] / self._c[i] * np.exp(-h_cm / self._c[i]),
                       self._b[4] / self._c[4])
        return np.where(h >= self.h_max, 0.0, rho)

    def get_vertical_height(self, X):
        """Inverse of get_vertical_depth (X in g/cm^2, returns m)."""
        X = np.asarray(X, dtype=float)
        # piecewise analytic inverse
        X_bounds = self.get_vertical_depth(self._hb)
        out = np.empty_like(X)
        i = np.clip(np.searchsorted(-X_bounds, -X, side="right") - 1, 0, 4)
        exp_h = -self._c[i] * np.log(np.maximum((X - self._a[i]) / self._b[i],
                                                1e-300)) / M_TO_CM
        lin_h = (self._a[4] - X) * self._c[4] / self._b[4] / M_TO_CM
        out = np.where(i < 4, exp_h, lin_h)
        return np.where(X <= 0, self.h_max, out)

    # ---- curved geometry helpers ------------------------------------

    @staticmethod
    def height_at_distance(d, zenith, observation_level=0.0):
        """Height above sea level after travelling distance d from the
        observation level along a direction with zenith angle ``zenith``
        (curved Earth)."""
        r0 = R_EARTH + observation_level
        r = np.sqrt(r0 ** 2 + np.asarray(d) ** 2
                    + 2 * r0 * np.asarray(d) * np.cos(zenith))
        return r - R_EARTH

    def _distance_grid(self, zenith, observation_level, n=4096):
        # distance to the top of the atmosphere along the axis
        r0 = R_EARTH + observation_level
        rt = R_EARTH + self.h_max
        d_top = (np.sqrt(rt ** 2 - r0 ** 2 * np.sin(zenith) ** 2)
                 - r0 * np.cos(zenith))
        return np.linspace(0.0, d_top, n)

    def get_slant_depth_at_distance(self, d, zenith, observation_level=0.0):
        """Slant depth X(d): overburden along the axis from the top of the
        atmosphere down to distance d from the observation level (g/cm^2),
        curved-Earth numeric integral."""
        grid = self._distance_grid(zenith, observation_level)
        rho = self.get_density(self.height_at_distance(grid, zenith,
                                                       observation_level))
        # integral from s to d_top of rho ds  (ds in cm)
        cum = np.concatenate([
            [0.0], np.cumsum(0.5 * (rho[1:] + rho[:-1]) * np.diff(grid))
        ]) * M_TO_CM
        X_of_d = cum[-1] - np.interp(d, grid, cum)
        return X_of_d

    def get_distance_xmax_geometric(self, zenith, x_max,
                                    observation_level=0.0):
        """Geometric distance from the observation level (along the axis) of
        the point with slant depth ``x_max`` (radiotools
        Atmosphere.get_distance_xmax_geometric equivalent)."""
        grid = self._distance_grid(zenith, observation_level)
        X = self.get_slant_depth_at_distance(grid, zenith, observation_level)
        # X decreases with d; invert by interpolation
        x_max = np.asarray(x_max, dtype=float)
        if np.any(x_max > X[0]) or np.any(x_max < 0):
            raise ValueError("requested depth outside the atmosphere")
        return np.interp(-x_max, -X, grid)


class Refractivity:
    """Gladstone-Dale refractivity N(h) = N0 rho(h)/rho(0) and the
    straight-line effective refractivity between points, on tensors
    (atmosphere.py:141-177)."""

    def __init__(self, atmosphere: Atmosphere, n0=1.000292, n_samples=512):
        self.at = atmosphere
        self.refractivity_at_sea_level = n0 - 1.0
        self._rho0 = float(atmosphere.get_density(0.0))
        self._n = n_samples
        # the integration nodes, numpy's linspace as the JAX package takes it
        self._t = np.linspace(0.0, 1.0, n_samples)

    def density(self, h: torch.Tensor) -> torch.Tensor:
        """``Atmosphere.get_density`` elementwise on a tensor of heights."""
        at = self.at
        hb, a, b, c = (torch.as_tensor(x, dtype=h.dtype, device=h.device)
                       for x in (at._hb, at._a, at._b, at._c))
        i = torch.clamp(torch.searchsorted(hb, h.contiguous(), right=True) - 1, 0, 4)
        h_cm = h * M_TO_CM
        rho = torch.where(i < 4, b[i] / c[i] * torch.exp(-h_cm / c[i]), b[4] / c[4])
        return torch.where(h >= at.h_max, torch.zeros_like(rho), rho)

    def refractivity(self, h: torch.Tensor) -> torch.Tensor:
        return self.refractivity_at_sea_level * self.density(h) / self._rho0

    def effective_refractivity(self, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
        """Average N along the straight lines p1 -> p2: ``p1`` [..., 3]
        sources and ``p2`` [..., 3] observers broadcast against each other
        (e.g. [P, 1, 3] and [A, 3] give [P, A]); the trapezoid rule of
        ``np.trapezoid`` over ``n_samples`` nodes."""
        t = torch.as_tensor(self._t, dtype=p1.dtype, device=p1.device)
        p1, p2 = torch.broadcast_tensors(p1, p2)
        d = p2 - p1
        x = p1[..., None, 0] + t * d[..., None, 0]
        y = p1[..., None, 1] + t * d[..., None, 1]
        z = p1[..., None, 2] + t * d[..., None, 2]
        r = torch.sqrt(x ** 2 + y ** 2 + (z + R_EARTH) ** 2)
        n = self.refractivity(r - R_EARTH)
        dt = t[1:] - t[:-1]
        return (dt * (n[..., 1:] + n[..., :-1]) / 2.0).sum(-1)

    def time_delay(self, target: torch.Tensor, positions: torch.Tensor,
                   speed_of_light) -> torch.Tensor:
        """Light travel time source -> observer including refractivity
        (interferometry.get_time_shifts_rit:189-221); ``target`` [..., 3] and
        ``positions`` [..., 3] broadcast as in :meth:`effective_refractivity`."""
        diff = positions - target
        dist = torch.sqrt((diff * diff).sum(-1))
        n_eff = 1.0 + self.effective_refractivity(target, positions)
        return dist * n_eff / speed_of_light
