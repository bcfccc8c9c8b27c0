"""Two-point ray tracing through any horizontally stratified ice (torch).

Counterpart of ``nuradiomc_tpu/ops/raytrace_numeric.py`` (the reference's
RadioPropa path, SignalProp/radioproparaytracing.py, for stratified
profiles). In a stratified medium Snell's invariant s = n(z) sin(theta) is
conserved, so every observable is a quadrature in z:

    horizontal advance  y  = int s / sqrt(n^2 - s^2) dz
    path length         L  = int n / sqrt(n^2 - s^2) dz
    travel time       c t  = int n^2 / sqrt(n^2 - s^2) dz

The turning depth solves n(z_t) = s by bisection; the 1/sqrt singularity
there goes away with z = z_cap - u^2 and a midpoint rule in u. The
two-point problem splits into a direct and a turn-or-reflect branch, each
monotone in s and solved by bisection. The JAX function is written for one
pair and vmapped; here the pairs are the leading axes of the inputs, and
both branches bisect together as one [2, ...] batch (each branch's advance
is the same formula as the JAX package's, so the numbers agree). Memory is
[2, ..., N_QUAD] per quadrature: pass many pairs per call, since the cost
(about 9,000 sequential steps) does not depend on their number.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils.constants import speed_of_light

N_QUAD = 192       # midpoint-rule steps in the u substitution
N_BISECT_TURN = 62  # turning-point bisection iterations
N_BISECT_S = 70    # Snell-parameter bisection iterations


class NumericRaySolutions(NamedTuple):
    """Leading axes = the pairs', last = the two slots (direct, mirror)."""

    s: torch.Tensor             # Snell invariant n sin(theta)
    mask: torch.Tensor
    sol_type: torch.Tensor      # 1 direct / 2 refracted / 3 reflected, 0 invalid
    launch_angle: torch.Tensor
    receive_angle: torch.Tensor
    path_length: torch.Tensor
    travel_time: torch.Tensor


def _turning_depth(profile, s, z_lo):
    """z_t in [z_lo, 0] with n(z_t) = s; 0 where the ray reaches the surface
    (n decreases toward the surface)."""
    a = torch.full_like(s, z_lo)
    b = torch.zeros_like(s)
    for _ in range(N_BISECT_TURN):
        m = 0.5 * (a + b)
        below = profile.index_of_refraction(m) > s      # still denser than s
        a, b = torch.where(below, m, a), torch.where(below, b, m)
    z_t = 0.5 * (a + b)
    no_turn = profile.index_of_refraction(torch.full_like(s, 0.0 - 1e-9)) > s
    return torch.where(no_turn, torch.zeros_like(z_t), z_t)


def _w_integrals(profile, s, z, z_cap):
    """(advance, path length, time) of the leg from depth z up to z_cap,
    with the z = z_cap - u^2 substitution; quadrature over a trailing axis."""
    u_max = torch.sqrt(torch.clamp(z_cap - z, min=0.0))
    k = (torch.arange(N_QUAD, dtype=s.dtype, device=s.device) + 0.5) / N_QUAD
    u = u_max[..., None] * k
    zz = z_cap[..., None] - u ** 2
    n = profile.index_of_refraction(zz)
    root = torch.sqrt(torch.clamp(n ** 2 - s[..., None] ** 2, min=1e-14))
    du = u_max / N_QUAD
    w = torch.sum(2.0 * u * s[..., None] / root, dim=-1) * du
    ell = torch.sum(2.0 * u * n / root, dim=-1) * du
    t = torch.sum(2.0 * u * n ** 2 / root, dim=-1) * du / speed_of_light
    return w, ell, t


def _branch_quantities(profile, s, z1, z2, z_bottom):
    """(direct, mirror) observables for Snell parameter s, and z_t."""
    z_t = _turning_depth(profile, s, z_bottom)
    z_cap = torch.clamp(z_t, max=0.0)
    w1, l1, t1 = _w_integrals(profile, s, z1, z_cap)
    w2, l2, t2 = _w_integrals(profile, s, z2, z_cap)
    return (w1 - w2, l1 - l2, t1 - t2), (w1 + w2, l1 + l2, t1 + t2), z_t


def find_solutions_numeric(profile, x1y, x1z, x2y, x2z, z_bottom=None,
                           device=device_util.DEFAULT) -> NumericRaySolutions:
    """Two-slot solutions from the deep point x1 to the shallow point x2 in
    the 2D plane (x2 above or level and to the right, as in
    ``raytrace.find_solutions``), batched over the inputs' broadcast axes.
    Numbers or arrays are put on ``device`` (float64); hold float64, since
    the bracket's upper end n2 (1 - 1e-7) is below float32's resolution."""
    if z_bottom is None:
        z_bottom = getattr(profile, "z_bottom", -3000.0)
    dev = device_util.resolve(device)
    x1y, x1z, x2y, x2z = torch.broadcast_tensors(*(
        x.to(dev) if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float64, device=dev)
        for x in (x1y, x1z, x2y, x2z)))
    dy = x2y - x1y
    n1 = profile.index_of_refraction(x1z)
    n2 = profile.index_of_refraction(x2z)
    eps = 1e-7
    # both branches at once: axis 0 is the branch (0 direct, 1 mirror)
    mirror = torch.tensor([False, True], device=dev).reshape(2, *([1] * dy.dim()))
    z1, z2, dy2 = (x.expand(2, *x.shape) for x in (x1z, x2z, dy))

    def advance(s):
        (wd, _, _), (wm, _, _), _ = _branch_quantities(profile, s, z1, z2, z_bottom)
        return torch.where(mirror, wm, wd)

    # the advance increases strictly with s on (0, n2): bisect
    a = torch.full_like(dy2, eps)
    b = (n2 * (1.0 - eps)).expand(2, *n2.shape)
    for _ in range(N_BISECT_S):
        m = 0.5 * (a + b)
        f = dy2 - advance(m)
        a, b = torch.where(f > 0, m, a), torch.where(f > 0, b, m)
    s = 0.5 * (a + b)
    resid = torch.abs(dy2 - advance(s))
    tol = torch.clamp(1e-3 * torch.clamp(dy2, min=1.0), min=1e-2)
    ok = resid < tol

    (_, ld, td), (_, lm, tm), z_t = _branch_quantities(profile, s, z1, z2, z_bottom)
    ell = torch.where(mirror, lm, ld)
    tt = torch.where(mirror, tm, td)
    one = torch.ones_like(z_t, dtype=torch.int64)
    sol_type = torch.where(mirror, torch.where(z_t < 0.0, 2 * one, 3 * one), one)
    launch = torch.arcsin(torch.clamp(s / n1, 0.0, 1.0))
    # both branches launch upward from the deep point; the mirror ray
    # turns above x2 and arrives from above
    receive_up = torch.arcsin(torch.clamp(s / n2, 0.0, 1.0))
    receive = torch.where(mirror, math.pi - receive_up, receive_up)

    def last(x):
        return torch.movedim(x, 0, -1)

    return NumericRaySolutions(
        s=last(s), mask=last(ok), sol_type=last(torch.where(ok, sol_type, 0 * one)),
        launch_angle=last(launch), receive_angle=last(receive),
        path_length=last(ell), travel_time=last(tt))
