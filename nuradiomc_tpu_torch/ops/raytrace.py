"""Batched analytic ray tracing in exponential ice (torch), main-path subset.

Counterpart of ``nuradiomc_tpu/ops/raytrace.py``: the two-point solver
(``find_solutions``, two solution slots sorted by C0), the closed-form
observables (launch/receive angles, Bouma path length and travel time), the
3D <-> 2D plane reduction, and the SP1 attenuation factor by moment-factored
Gauss-Legendre quadrature. Every function is elementwise over the leading
batch axes: the JAX package's ``vmap`` over flattened pairs is a batch
dimension here, and each fixed-count ``fori_loop`` is a fixed-count Python
loop. ``focusing_dtheta_dz`` gives the implicit-mode focusing derivative.
The numeric focusing re-solve is ``find_solutions`` at a displaced receiver
(``sim/pipeline.py``). ``find_solutions_all`` adds the bottom-reflection
slots of a reflective-bottom ice (Moore's Bay), with their closed-form
observables and the per-slot attenuation ``attenuation_factor_slots``.
``reflection_angle`` gives the surface-incidence zenith of reflected rays,
and ``find_solution_ice_to_air`` the single solution for a receiver above
the surface (the closed-form in-ice leg and a straight air leg).
``delta_y`` is the solver's miss distance for a trial C0 and
``focusing_factor`` the analytic (Bouma) focusing factor.

``find_solutions`` launches the CUDA kernel ``csrc/ray_solver.cu`` for CUDA
tensors (the whole solve and the observables of both slots in one launch)
and runs ``find_solutions_plain`` for CPU tensors; there is no other
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from nuradiomc_tpu_torch.utils import units
from nuradiomc_tpu_torch.utils.constants import speed_of_light
from nuradiomc_tpu_torch.models.ice import IceModelSimple
from nuradiomc_tpu_torch.ops import _build, attenuation as attenuation_ops
from nuradiomc_tpu_torch.utils import device as device_util, timing

SOL_DIRECT = 1
SOL_REFRACTED = 2
SOL_REFLECTED = 3

# ray-solver kernel launches since the count was last set to 0
launches = 0

_LOGC0_HI = 100.0
# |delta_y| acceptance for a grazing (tangent) solution (raytrace.py:54)
_TANGENT_TOL = 3.16e-4


class RaySolutions(NamedTuple):
    """Struct-of-arrays solutions; leading axes = batch, last = slot."""

    c0: torch.Tensor
    c1: torch.Tensor
    mask: torch.Tensor          # bool, slot holds a valid solution
    sol_type: torch.Tensor      # 1 direct / 2 refracted / 3 reflected
    launch_angle: torch.Tensor
    receive_angle: torch.Tensor
    path_length: torch.Tensor
    travel_time: torch.Tensor
    reflection: torch.Tensor    # number of bottom reflections
    refl_case: torch.Tensor     # 1 up-going start, 2 down-going start


class Geometry2D(NamedTuple):
    """Per-pair reduction of the 3D problem to the propagation plane."""

    x1y: torch.Tensor
    x1z: torch.Tensor
    x2y: torch.Tensor
    x2z: torch.Tensor
    swapped: torch.Tensor   # bool: source/receiver exchanged
    dphi: torch.Tensor
    ux: torch.Tensor        # unit horizontal direction (pre-swap x1 -> x2)
    uy: torch.Tensor


def _c0_from_log(logc0, n_ice):
    return torch.exp(logc0) + 1.0 / n_ice


def _gamma(z, ice: IceModelSimple):
    return ice.delta_n * torch.exp((z - ice.z_shift) / ice.z_0)


def _n_z(z, ice: IceModelSimple):
    return ice.n_ice - ice.delta_n * torch.exp((z - ice.z_shift) / ice.z_0)


def _arg_stable(z, c0, ice: IceModelSimple):
    """c0^2 n(z)^2 - 1 without the near-turning-point cancellation
    (raytrace.py:71): arg = c0 (gamma_t - gamma(z)) (c0 n(z) + 1) with
    gamma_t - gamma(z) = -gamma_t expm1((z - z_turn_raw) / z_0)."""
    b = 2.0 * ice.n_ice
    c = ice.n_ice ** 2 - c0 ** -2
    disc = torch.sqrt(torch.clamp(0.25 * b * b - c, min=0.0))
    gamma_t = c / (0.5 * b + disc)
    safe_g = torch.clamp(gamma_t, min=1e-30)
    dz = (z - ice.z_shift) - torch.log(safe_g / ice.delta_n) * ice.z_0
    dgamma = -safe_g * torch.expm1(torch.clamp(dz / ice.z_0, max=0.0))
    nz = _n_z(z, ice)
    return c0 * dgamma * (c0 * nz + 1.0)


def _turning_point(c0, ice: IceModelSimple):
    """(gamma_turn, z_turn), stable form (raytrace.py:92); a saddle point
    above the surface means a surface reflection with the turn at z = 0."""
    b = 2.0 * ice.n_ice
    c = ice.n_ice ** 2 - c0 ** -2
    disc = torch.sqrt(torch.clamp(0.25 * b * b - c, min=0.0))
    gamma2 = c / (0.5 * b + disc)
    z2 = torch.log(gamma2 / ice.delta_n) * ice.z_0 + ice.z_shift
    above = z2 > 0
    z2 = torch.where(above, 0.0, z2)
    gamma_surface = ice.delta_n * math.exp((0.0 - ice.z_shift) / ice.z_0)
    gamma2 = torch.where(above, gamma_surface, gamma2)
    return gamma2, z2


def _y_of_gamma(gamma, c0, c1, ice: IceModelSimple):
    """Closed-form ray path y(gamma) (get_y, analyticraytracing.py:105-125)."""
    b = 2.0 * ice.n_ice
    c = ice.n_ice ** 2 - c0 ** -2
    root = torch.abs(gamma ** 2 - gamma * b + c)
    logargument = gamma / (2 * torch.sqrt(c) * torch.sqrt(root) - b * gamma + 2 * c)
    return (ice.z_0 / torch.sqrt(ice.n_ice ** 2 * c0 ** 2 - 1.0)
            * torch.log(logargument) + c1)


def _y_with_mirror(z, c0, ice: IceModelSimple, c1=0.0):
    gamma_turn, z_turn = _turning_point(c0, ice)
    y_turn = _y_of_gamma(gamma_turn, c0, c1, ice)
    below = z < z_turn
    y_below = _y_of_gamma(_gamma(z, ice), c0, c1, ice)
    y_above = 2 * y_turn - _y_of_gamma(_gamma(2 * z_turn - z, ice), c0, c1, ice)
    return torch.where(below, y_below, y_above)


def _c1_of(x1y, x1z, c0, ice: IceModelSimple):
    return x1y - _y_with_mirror(x1z, c0, ice)


def delta_y(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """Miss distance at the receiver for trial parameter C0 (raytrace.py:134,
    get_delta_y:204-272, in-ice without bottom reflections); elementwise.
    Positive when the path falls short of the receiver (direct branch); the
    "turning point too deep" penalty and the mirrored overshoot branch make
    it negative at both ends of the logC0 axis."""
    c1 = _c1_of(x1y, x1z, c0, ice)
    gamma_turn, z_turn = _turning_point(c0, ice)
    y_turn = _y_of_gamma(gamma_turn, c0, c1, ice)
    penalty = -(torch.sqrt((z_turn - x2z) ** 2 + (y_turn - x2y) ** 2)
                + 10.0 * torch.abs(z_turn - x2z))
    y2 = _y_of_gamma(_gamma(x2z, ice), c0, c1, ice)
    d_direct = x2y - y2
    d_mirror = -(x2y - (2 * y_turn - y2))
    out = torch.where(y_turn > x2y, d_direct, d_mirror)
    return torch.where(z_turn < x2z, penalty, out)


def _w_up(z, c0, ice: IceModelSimple):
    """Horizontal advance of the rising ray, y(gamma(z)) with C1 = 0."""
    return _y_of_gamma(_gamma(z, ice), c0, 0.0, ice)


def _branch_misses(logc0, x1z, x2z, dy_target, ice: IceModelSimple):
    """(miss_direct, miss_mirror) for trial logC0 (raytrace.py:188)."""
    c0 = _c0_from_log(logc0, ice.n_ice)
    _, z_turn = _turning_point(c0, ice)
    w1 = _w_up(x1z, c0, ice)
    w2 = _w_up(x2z, c0, ice)
    wt = _w_up(z_turn, c0, ice)
    return dy_target - (w2 - w1), dy_target - (2 * wt - w2 - w1)


def _logc0_min(x2z, ice: IceModelSimple):
    """logC0 of the ray that turns exactly at the receiver depth."""
    gamma2 = _gamma(x2z, ice)
    b = 2.0 * ice.n_ice
    c = gamma2 * (b - gamma2)
    c0_min = 1.0 / torch.sqrt(ice.n_ice ** 2 - c)
    return torch.log(c0_min - 1.0 / ice.n_ice)


def _bisect_split(n_bisect: int):
    """(n_narrow, n_secant): the bisections and secant steps of
    ``_bracketed_solve`` (and of ``csrc/ray_solver.cu``) for ``n_bisect``
    evaluations of f; the secant's two bracket evaluations count too."""
    n_secant = max(min(4, n_bisect // 4), 0)
    return n_bisect - n_secant - (2 if n_secant else 0), n_secant


def _bracketed_solve(f, lo, hi, f_lo, n_bisect: int):
    """Root of a sign-changing f on [lo, hi]: bisection, then a
    bracket-clamped secant polish (raytrace.py:225)."""
    n_narrow, n_secant = _bisect_split(n_bisect)
    s_lo = torch.sign(f_lo)
    for _ in range(n_narrow):
        mid = 0.5 * (lo + hi)
        same = torch.sign(f(mid)) == s_lo
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    if n_secant == 0:
        return 0.5 * (lo + hi)
    a, b = lo, hi
    fa, fb = f(a), f(b)
    tiny = torch.tensor(1e-30, dtype=lo.dtype, device=lo.device)
    for _ in range(n_secant):
        denom = fb - fa
        x = b - fb * (b - a) / torch.where(torch.abs(denom) > tiny, denom, tiny)
        x = torch.minimum(torch.maximum(x, torch.minimum(a, b)),
                          torch.maximum(a, b))
        fx = f(x)
        same = torch.sign(fx) == s_lo
        a, b, fa, fb = (torch.where(same, x, a), torch.where(same, b, x),
                        torch.where(same, fx, fa), torch.where(same, fb, fx))
    return 0.5 * (a + b)


_GOLDEN_ITERS = 48
_INV_PHI = 0.6180339887498949


def _golden_min(f, lo, hi, n_iter: int = _GOLDEN_ITERS):
    """Argmin of a unimodal f on [lo, hi] by golden-section (raytrace.py:264)."""
    a, b = lo, hi
    c = b - _INV_PHI * (b - a)
    d = a + _INV_PHI * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(n_iter):
        # <= tie-break keeps the minimum on the left of a flat plateau
        left = fc <= fd
        a2 = torch.where(left, a, c)
        b2 = torch.where(left, d, b)
        c = b2 - _INV_PHI * (b2 - a2)
        d = a2 + _INV_PHI * (b2 - a2)
        a, b = a2, b2
        fc, fd = f(c), f(d)
    return 0.5 * (a + b)


def _solve_branch_pair(f_direct, f_mirror, lo0, hi0, n_bisect: int):
    """Up to two roots of the (direct, mirror) branch pair
    (raytrace.py:288). Returns (root0, valid0, mirror0, root1, valid1)."""
    fd_lo = f_direct(lo0)
    fd_hi = f_direct(hi0)
    has_direct = torch.sign(fd_lo) != torch.sign(fd_hi)
    r_direct = _bracketed_solve(f_direct, lo0, hi0, fd_lo, n_bisect)

    mid = _golden_min(f_mirror, lo0, hi0)
    fm_lo = f_mirror(lo0)
    fm_mid = f_mirror(mid)
    fm_hi = f_mirror(hi0)
    has_m_hi = torch.sign(fm_mid) != torch.sign(fm_hi)
    r_m_hi = _bracketed_solve(f_mirror, mid, hi0, fm_mid, n_bisect)
    has_m_lo = (torch.sign(fm_lo) != torch.sign(fm_mid)) & ~has_direct
    r_m_lo = _bracketed_solve(f_mirror, lo0, mid, fm_lo, n_bisect)

    tangent = (~has_direct) & (~has_m_lo) & (torch.abs(fd_lo) < _TANGENT_TOL)
    root0 = torch.where(has_direct, r_direct, torch.where(has_m_lo, r_m_lo, lo0))
    valid0 = has_direct | has_m_lo | tangent
    mirror0 = ~has_direct & has_m_lo
    return root0, valid0, mirror0, r_m_hi, has_m_hi


def _solve_two_roots(x1y, x1z, x2y, x2z, ice: IceModelSimple, n_bisect: int):
    """(logc0 [..., 2], valid [..., 2]) sorted ascending by C0, invalid
    slots last (raytrace.py:330)."""
    dy_target = x2y - x1y

    def f_direct(lg):
        return _branch_misses(lg, x1z, x2z, dy_target, ice)[0]

    def f_mirror(lg):
        return _branch_misses(lg, x1z, x2z, dy_target, ice)[1]

    eps = 1e-12 if x1y.dtype == torch.float64 else 1e-5
    lo0 = _logc0_min(x2z, ice) + eps
    hi0 = torch.full_like(lo0, _LOGC0_HI)
    root0, valid0, _, root1, valid1 = _solve_branch_pair(
        f_direct, f_mirror, lo0, hi0, n_bisect)
    roots = torch.stack([root0, root1], dim=-1)
    valid = torch.stack([valid0, valid1], dim=-1)
    key = torch.where(valid, roots, torch.inf)
    order = torch.argsort(key, dim=-1, stable=True)
    return torch.gather(roots, -1, order), torch.gather(valid, -1, order)


def _solution_type(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """1 direct / 2 refracted / 3 reflected (determine_solution_type)."""
    c1 = _c1_of(x1y, x1z, c0, ice)
    gamma_turn, z_turn = _turning_point(c0, ice)
    y_turn = _y_of_gamma(gamma_turn, c0, c1, ice)
    direct = x2y < y_turn
    reflected = z_turn >= 0.0
    one = torch.ones_like(c0, dtype=torch.int32)
    return torch.where(direct, one * SOL_DIRECT,
                       torch.where(reflected, one * SOL_REFLECTED,
                                   one * SOL_REFRACTED))


def _dy_dz(z, c0, ice: IceModelSimple):
    """|dy/dz| along the path (get_y_diff:306-355)."""
    nz = _n_z(z, ice)
    arg = c0 ** 2 * nz ** 2 - 1.0
    return torch.where(arg > 0, 1.0 / torch.sqrt(torch.clamp(arg, min=1e-30)),
                       torch.inf)


def _z2_mirrored(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    c1 = _c1_of(x1y, x1z, c0, ice)
    return _z2_past_turn(c0, c1, *_turning_point(c0, ice), x1z, x2y, x2z, ice)


def _z2_past_turn(c0, c1, gamma_turn, z_turn, x1z, x2y, x2z, ice: IceModelSimple):
    """``_z2_mirrored`` from the path's c1 and turning point."""
    y_turn = _y_of_gamma(gamma_turn, c0, c1, ice)
    past_turn = y_turn < x2y
    return torch.where(past_turn,
                       x1z + torch.abs(z_turn - x1z) + torch.abs(z_turn - x2z),
                       x2z)


def launch_angle(c0, x1z, ice: IceModelSimple):
    """2D launch zenith at the source (always upward)."""
    return torch.atan(_dy_dz(x1z, c0, ice))


def receive_angle(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """2D receive zenith at the receiver (get_receive_angle:1198)."""
    z2m = _z2_mirrored(c0, x1y, x1z, x2y, x2z, ice)
    dy = _dy_dz(x2z, c0, ice)
    past_turn = z2m != x2z
    ang = torch.atan(dy)
    ang = torch.where(past_turn, math.pi - ang, ang)
    return math.pi - ang


def reflection_angle(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """Surface-incidence zenith for reflected rays, NaN otherwise
    (raytrace.py:661, get_reflection_angle:1201-1237); elementwise."""
    _, z_turn = _turning_point(c0, ice)
    ang = torch.atan(_dy_dz(torch.zeros_like(c0), c0, ice))
    sol = _solution_type(c0, x1y, x1z, x2y, x2z, ice)
    return torch.where((sol == SOL_REFLECTED) & (z_turn >= 0), ang, torch.nan)


def _bouma_beta_alpha(c0, x1z, ice: IceModelSimple):
    n1 = _n_z(x1z, ice)
    beta = n1 * torch.sin(launch_angle(c0, x1z, ice))
    alpha = ice.n_ice ** 2 - beta ** 2
    return beta, alpha


def path_length(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """Closed-form path length (get_path_length_analytic:602-690, Bouma)."""
    beta, alpha = _bouma_beta_alpha(c0, x1z, ice)

    def s_of(z):
        nz = _n_z(z, ice)
        gam = torch.clamp(nz ** 2 - beta ** 2, min=0.0)
        l1 = torch.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2
        l2 = torch.sqrt(gam) + nz
        return (ice.n_ice / torch.sqrt(alpha) * (z - ice.z_0 * torch.log(l1))
                + ice.z_0 * torch.log(l2))

    sol = _solution_type(c0, x1y, x1z, x2y, x2z, ice)
    _, z_turn = _turning_point(c0, ice)
    z_turn = torch.where(sol == SOL_REFLECTED, 0.0, z_turn)
    s_direct = s_of(x2z) - s_of(x1z)
    s_turn = 2 * s_of(z_turn) - s_of(x1z) - s_of(x2z)
    return torch.where(sol == SOL_DIRECT, s_direct, s_turn)


def travel_time(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """Closed-form travel time (get_travel_time_analytic:692-783, Bouma)."""
    beta, alpha = _bouma_beta_alpha(c0, x1z, ice)

    def ct_of(z):
        nz = _n_z(z, ice)
        gam = torch.clamp(nz ** 2 - beta ** 2, min=0.0)
        l1 = torch.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2
        l2 = torch.sqrt(gam) + nz
        return (ice.z_0 * (torch.sqrt(gam)
                           - ice.n_ice ** 2 / torch.sqrt(alpha) * torch.log(l1)
                           + ice.n_ice * torch.log(l2))
                + ice.n_ice ** 2 * z / torch.sqrt(alpha))

    sol = _solution_type(c0, x1y, x1z, x2y, x2z, ice)
    _, z_turn = _turning_point(c0, ice)
    z_turn = torch.where(sol == SOL_REFLECTED, 0.0, z_turn)
    ct_direct = ct_of(x2z) - ct_of(x1z)
    ct_turn = 2 * ct_of(z_turn) - ct_of(x1z) - ct_of(x2z)
    return torch.where(sol == SOL_DIRECT, ct_direct, ct_turn) / speed_of_light


def focusing_factor(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple, limit=2.0):
    """Analytic focusing factor (raytrace.py:717, get_focusing_analytic:786-883,
    Bouma appendix), clipped to ``limit``; refracted trajectories, where the
    analytic form diverges, are clamped at the limit as well."""
    beta, alpha = _bouma_beta_alpha(c0, x1z, ice)
    la = launch_angle(c0, x1z, ice)
    ra = receive_angle(c0, x1y, x1z, x2y, x2z, ice)
    s = path_length(c0, x1y, x1z, x2y, x2z, ice)
    n1 = _n_z(x1z, ice)
    n2 = _n_z(x2z, ice)

    def w_phi(z):
        nz = _n_z(z, ice)
        gam = torch.clamp(nz ** 2 - beta ** 2, min=0.0)
        return (z - ice.z_0 * torch.log(torch.sqrt(alpha * gam) + ice.n_ice * nz
                                        - beta ** 2)) / torch.sqrt(alpha)

    def w_theta(z):
        nz = _n_z(z, ice)
        gam = torch.clamp(nz ** 2 - beta ** 2, min=1e-30)
        return (ice.n_ice ** 2 * z / alpha ** 1.5
                + ice.z_0 * (ice.n_ice * nz + beta ** 2) / (alpha * torch.sqrt(gam))
                - ice.n_ice ** 2 * ice.z_0 / alpha ** 1.5
                * torch.log(torch.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2))

    surface = torch.zeros_like(c0)
    sol = _solution_type(c0, x1y, x1z, x2y, x2z, ice)
    direct = sol == SOL_DIRECT
    wt = torch.where(direct, w_theta(x2z) - w_theta(x1z),
                     2 * w_theta(surface) - w_theta(x1z) - w_theta(x2z))
    wp = torch.where(direct, w_phi(x2z) - w_phi(x1z),
                     2 * w_phi(surface) - w_phi(x1z) - w_phi(x2z))

    f_inv_sq = n1 * n2 * torch.abs(torch.cos(la) * torch.cos(ra)) * wt * wp / s ** 2
    focusing = torch.sqrt(1.0 / torch.clamp(f_inv_sq, min=1e-30))
    return torch.clamp(focusing, max=limit)


def turning_depth(c0, ice: IceModelSimple):
    """Turning depth (clamped to the surface for reflected rays)."""
    return _turning_point(c0, ice)[1]


def surface_touches_slots(sol_type, reflection, refl_case, z_turn):
    """Number of surface reflections per slot (raytrace.py:560)."""
    n = (reflection - (refl_case == 2).to(reflection.dtype)
         + (sol_type != SOL_DIRECT).to(reflection.dtype))
    return torch.where(z_turn >= 0, torch.clamp(n, min=0), torch.zeros_like(n))


def find_solutions_plain(x1y, x1z, x2y, x2z, ice: IceModelSimple,
                         n_bisect: int = 96) -> RaySolutions:
    """Solve the in-ice two-point problem for a batch of 2D geometries
    (raytrace.py:875). x2 must be above-or-level with x1 and to its right
    (``to_2d`` arranges that). Returns 2 slots (last axis), sorted by C0;
    invalid slots hold finite garbage and mask False. The plain version of
    ``csrc/ray_solver.cu``: :func:`find_solutions` runs it for CPU tensors."""
    logc0, valid = _solve_two_roots(x1y, x1z, x2y, x2z, ice, n_bisect)
    c0 = _c0_from_log(logc0, ice.n_ice)
    a, b, c, d = (x[..., None] for x in (x1y, x1z, x2y, x2z))
    c1 = _c1_of(a, b, c0, ice)
    sol_type = _solution_type(c0, a, b, c, d, ice)
    zeros = torch.zeros_like(sol_type)
    return RaySolutions(
        c0=c0, c1=c1, mask=valid,
        sol_type=torch.where(valid, sol_type, zeros),
        launch_angle=launch_angle(c0, b, ice),
        receive_angle=receive_angle(c0, a, b, c, d, ice),
        path_length=path_length(c0, a, b, c, d, ice),
        travel_time=travel_time(c0, a, b, c, d, ice),
        reflection=zeros, refl_case=torch.ones_like(sol_type))


@functools.lru_cache(maxsize=16)
def _solver_scalars(ice: IceModelSimple, f64: bool):
    """The kernel's scalars (``csrc/ray_solver.cu``, enum ``S_*``), each as
    the plain version's ATen ops on the card see it: a Python scalar rounded
    to the dtype, ``x / s`` as ``x * (1 / s)`` with the reciprocal rounded in
    the dtype."""
    dt = np.float64 if f64 else np.float32
    b = 2.0 * ice.n_ice
    vals = (dt(ice.n_ice), dt(ice.delta_n), dt(ice.z_0), dt(ice.z_shift), dt(ice.n_ice ** 2),
            dt(b), dt(0.25 * b * b), dt(0.5 * b), dt(1.0 / ice.n_ice),
            dt(1) / dt(ice.z_0), dt(1) / dt(ice.delta_n),
            dt(ice.delta_n * math.exp((0.0 - ice.z_shift) / ice.z_0)),
            dt(1) / dt(speed_of_light), dt(math.pi), dt(1e-12 if f64 else 1e-5), dt(1e-30),
            dt(_TANGENT_TOL), dt(_INV_PHI), dt(_LOGC0_HI))
    return (ctypes.c_double * len(vals))(*(float(v) for v in vals))


def _solver_fn(dtype):
    lib = _build.load("ray_solver")
    fn = lib.ray_solver_f32 if dtype == torch.float32 else lib.ray_solver_f64
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_long, ctypes.POINTER(ctypes.c_double)]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, lib.ray_solver_nscalars()


def find_solutions(x1y, x1z, x2y, x2z, ice: IceModelSimple,
                   n_bisect: int = 96) -> RaySolutions:
    """``find_solutions_plain``'s solve and observables: the CUDA kernel
    ``csrc/ray_solver.cu`` (one launch) for CUDA tensors, the plain version
    for CPU tensors. On the card the inputs share one device and one dtype
    (float32 or float64); they broadcast, and every field is shaped like
    them with a trailing slot axis of 2."""
    global launches
    xs = (x1y, x1z, x2y, x2z)
    devices = {x.device for x in xs}
    if devices == {torch.device("cpu")}:
        return find_solutions_plain(x1y, x1z, x2y, x2z, ice, n_bisect)
    if len(devices) != 1:
        raise ValueError(f"ray solver: inputs on several devices {sorted(map(str, devices))}")
    dev = x1y.device
    if dev.type != "cuda":
        raise ValueError(f"ray solver: unsupported device {dev}")
    dtype = x1y.dtype
    if any(x.dtype != dtype for x in xs):
        raise ValueError(f"ray solver: mixed dtypes {[x.dtype for x in xs]}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ray solver: dtype {dtype} is not float32/float64")
    xs = torch.broadcast_tensors(*xs)
    shape = xs[0].shape
    xs = [x.contiguous().reshape(-1) for x in xs]
    n = xs[0].numel()
    # RaySolutions' fields in order: c0, c1, mask, sol_type, the four
    # observables, reflection, refl_case
    field_dtypes = (dtype, dtype, torch.bool, torch.int32) + (dtype,) * 4 + (torch.int32,) * 2
    out = [torch.empty((n, 2), dtype=d, device=dev) for d in field_dtypes]
    if n:
        fn, n_scalars = _solver_fn(dtype)
        scalars = _solver_scalars(ice, dtype == torch.float64)
        if n_scalars != len(scalars):
            raise RuntimeError(f"ray solver: the kernel takes {n_scalars} scalars, "
                               f"the wrapper gives {len(scalars)}")
        err = fn(*(t.data_ptr() for t in xs), *(t.data_ptr() for t in out), n, scalars,
                 *_bisect_split(n_bisect), _build.current_stream_ptr(dev))
        _build.check(err, "ray solver kernel")
        launches += 1
        timing.count("raytrace.kernel_pairs", n)
    return RaySolutions(*(t.reshape(*shape, 2) for t in out))


@functools.lru_cache(maxsize=16)
def _quad_nodes(n_steps: int, quadrature: str):
    """(nodes, weights) on [0, 1]: Gauss-Legendre or midpoint (numpy)."""
    if quadrature == "gauss":
        x, w = np.polynomial.legendre.leggauss(n_steps)
        return (x + 1.0) / 2.0, w / 2.0
    return (np.arange(n_steps) + 0.5) / n_steps, np.full(n_steps, 1.0 / n_steps)


# moment-factored SP1 quadrature constants (raytrace.py:769-771)
_SP1_BLO = 0.22
_SP1_BHI = 1.6
_SP1_K = 10


def _sp1_branch_moments(c0, ice, qt, qw, z_start, z_end_top):
    """Taylor moments M_k = int q(z) e^{b1(z)} (bb(z) - b_bar)^k ds of one
    t-substituted branch (raytrace.py:774); returns ([..., K+1], [..., K+1])."""
    qt = torch.as_tensor(qt, dtype=c0.dtype, device=c0.device)
    qw = torch.as_tensor(qw, dtype=c0.dtype, device=c0.device)
    T = torch.sqrt(torch.clamp(z_end_top - z_start, min=0.0))[..., None]
    t = qt * T
    z = z_end_top[..., None] - t ** 2
    nz = _n_z(z, ice)
    arg = torch.clamp(_arg_stable(z, c0[..., None], ice), min=1e-20)
    ds_dt = 2.0 * t * c0[..., None] * nz / torch.sqrt(arg)
    q = qw * ds_dt * T
    b1, bb_lo, bb_hi = attenuation_ops.sp1_w_coeffs(z)
    e = torch.where(z > 0, 0.0, q * torch.exp(b1))
    dlo = bb_lo - _SP1_BLO
    dhi = bb_hi - _SP1_BHI
    mlo, mhi = [], []
    plo = e
    phi = e
    for _ in range(_SP1_K + 1):
        mlo.append(torch.sum(plo, dim=-1))
        mhi.append(torch.sum(phi, dim=-1))
        plo = plo * dlo
        phi = phi * dhi
    return torch.stack(mlo, dim=-1), torch.stack(mhi, dim=-1)


def _sp1_attenuation_from_moments(m_lo, m_hi, frequencies, dtype):
    """exp(-exponent(f)) from the summed branch moments (raytrace.py:799)."""
    f_ghz = torch.clamp(frequencies / units.GHz, min=1e-4)
    w = torch.log(f_ghz).to(dtype)                            # [F]
    kk = np.arange(_SP1_K + 1)
    inv_fact = torch.tensor([1.0 / math.factorial(int(k)) for k in kk],
                            dtype=dtype, device=w.device)
    wk = (torch.pow(w[None, :], torch.tensor(kk, dtype=dtype, device=w.device)[:, None])
          * inv_fact[:, None])                                # [K+1, F]
    expo_lo = torch.exp(_SP1_BLO * w) * (m_lo @ wk)
    expo_hi = torch.exp(_SP1_BHI * w) * (m_hi @ wk)
    lo = frequencies < 1.0 * units.GHz
    return torch.exp(-torch.where(lo, expo_lo, expo_hi))


def attenuation_factor(c0, x1y, x1z, x2y, x2z, ice: IceModelSimple,
                       frequencies, model: str, n_steps: int = 64,
                       quadrature: str = "midpoint"):
    """exp(-int ds / L_att(z, f)) along the path, per frequency
    (raytrace.py:819): the inputs broadcast elementwise, the result is
    [..., F]. SP1 goes through the moment-factored quadrature, every other
    model through one t-substituted integral per branch."""
    c0, x1y, x1z, x2y, x2z = torch.broadcast_tensors(c0, x1y, x1z, x2y, x2z)
    _, z_turn = _turning_point(c0, ice)
    sol = _solution_type(c0, x1y, x1z, x2y, x2z, ice)
    z_top = torch.where(sol == SOL_REFLECTED, 0.0, z_turn)
    direct = sol == SOL_DIRECT
    qt, qw = _quad_nodes(n_steps, quadrature)
    # direct rays: one branch [z1, z2]; else [z1, z_top] up and [z2, z_top]
    # down (zero length for direct rays)
    z_end = torch.where(direct, x2z, z_top)
    if model == "SP1":
        up_lo, up_hi = _sp1_branch_moments(c0, ice, qt, qw, x1z, z_end)
        dn_lo, dn_hi = _sp1_branch_moments(c0, ice, qt, qw, x2z, z_end)
        return _sp1_attenuation_from_moments(up_lo + dn_lo, up_hi + dn_hi,
                                             frequencies, c0.dtype)
    exp_up = _leg_integral(c0, z_end, x1z, ice, frequencies, model, qt, qw)
    exp_down = _leg_integral(c0, z_end, x2z, ice, frequencies, model, qt, qw)
    return torch.exp(-(exp_up + exp_down))


# ---- bottom-reflection paths (raytrace.py:362-613) --------------------------
# every observable of a path with r bottom bounces is
#   A f(z_turn) + B f(z_bottom) + C f(z1) + D f(z2)
# with f the observable's antiderivative and integer coefficients that depend
# only on (r, reflection case, final-leg branch)

def _path_coeffs(r: int, case: int, mirror: bool):
    """(A, B, C, D) coefficients of the segment decomposition."""
    A = 2 * r - 2 * (case == 2) + 2 * int(mirror)
    B = -2 * r
    C = -1 if case == 1 else 1
    D = -1 if mirror else 1
    return A, B, C, D


def _refl_depth(ice: IceModelSimple, like):
    zb = ice.refl_z if ice.refl_z is not None else 0.0
    return torch.as_tensor(zb, dtype=like.dtype, device=like.device)


def _advance_general(logc0, x1z, x2z, ice: IceModelSimple, r: int, case: int,
                     mirror: bool):
    """Total horizontal advance of an r-bounce path."""
    c0 = _c0_from_log(logc0, ice.n_ice)
    _, z_turn = _turning_point(c0, ice)
    A, B, C, D = _path_coeffs(r, case, mirror)
    return (A * _w_up(z_turn, c0, ice) + B * _w_up(_refl_depth(ice, c0), c0, ice)
            + C * _w_up(x1z, c0, ice) + D * _w_up(x2z, c0, ice))


def _solve_reflection_roots(x1y, x1z, x2y, x2z, ice: IceModelSimple,
                            r: int, case: int, n_bisect: int):
    """Roots (direct final leg, mirror final leg) of an r-bounce path:
    (logc0 [..., 2], valid [..., 2], is_mirror [..., 2]). Near the shadow
    boundary both solutions can sit on the mirror branch; slot 0 then
    carries a mirror root and is_mirror[..., 0] is True."""
    dy_target = x2y - x1y
    eps = 1e-12 if x1y.dtype == torch.float64 else 1e-5
    lo0 = _logc0_min(x2z, ice) + eps
    hi0 = torch.full_like(lo0, _LOGC0_HI)

    def f_direct(lg):
        return dy_target - _advance_general(lg, x1z, x2z, ice, r, case, False)

    def f_mirror(lg):
        return dy_target - _advance_general(lg, x1z, x2z, ice, r, case, True)

    root0, valid0, mirror0, root1, valid1 = _solve_branch_pair(
        f_direct, f_mirror, lo0, hi0, n_bisect)
    return (torch.stack([root0, root1], dim=-1), torch.stack([valid0, valid1], dim=-1),
            torch.stack([mirror0, torch.ones_like(mirror0)], dim=-1))


def _bouma_s(c0, x1z, ice: IceModelSimple):
    """The Bouma path-length antiderivative s(z) of the ray (c0, x1z)."""
    beta, alpha = _bouma_beta_alpha(c0, x1z, ice)

    def s_of(z):
        nz = _n_z(z, ice)
        gam = torch.clamp(nz ** 2 - beta ** 2, min=0.0)
        l1 = torch.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2
        l2 = torch.sqrt(gam) + nz
        return (ice.n_ice / torch.sqrt(alpha) * (z - ice.z_0 * torch.log(l1))
                + ice.z_0 * torch.log(l2))
    return s_of


def _bouma_ct(c0, x1z, ice: IceModelSimple):
    """The Bouma travel-time antiderivative c t(z) of the ray (c0, x1z)."""
    beta, alpha = _bouma_beta_alpha(c0, x1z, ice)

    def ct_of(z):
        nz = _n_z(z, ice)
        gam = torch.clamp(nz ** 2 - beta ** 2, min=0.0)
        l1 = torch.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2
        l2 = torch.sqrt(gam) + nz
        return (ice.z_0 * (torch.sqrt(gam)
                           - ice.n_ice ** 2 / torch.sqrt(alpha) * torch.log(l1)
                           + ice.n_ice * torch.log(l2))
                + ice.n_ice ** 2 * z / torch.sqrt(alpha))
    return ct_of


def _general_sum(f, c0, x1z, x2z, ice: IceModelSimple, r, case, mirror):
    _, z_turn = _turning_point(c0, ice)
    A, B, C, D = _path_coeffs(r, case, mirror)
    return A * f(z_turn) + B * f(_refl_depth(ice, c0)) + C * f(x1z) + D * f(x2z)


def path_length_general(c0, x1z, x2z, ice: IceModelSimple, r, case, mirror):
    """Closed-form path length of an r-bounce path (raytrace.py:419)."""
    return _general_sum(_bouma_s(c0, x1z, ice), c0, x1z, x2z, ice, r, case, mirror)


def travel_time_general(c0, x1z, x2z, ice: IceModelSimple, r, case, mirror):
    """Closed-form travel time of an r-bounce path (raytrace.py:436)."""
    return _general_sum(_bouma_ct(c0, x1z, ice), c0, x1z, x2z, ice, r, case,
                        mirror) / speed_of_light


def launch_angle_general(c0, x1z, ice: IceModelSimple, case):
    """Launch zenith; case 2 paths start downward (pi - upward angle)."""
    up = torch.atan(_dy_dz(x1z, c0, ice))
    return math.pi - up if case == 2 else up


def receive_angle_general(c0, x2z, ice: IceModelSimple, mirror: bool):
    """Receive zenith from the final-leg branch (up-going unless mirrored)."""
    ang = torch.atan(_dy_dz(x2z, c0, ice))
    ang = math.pi - ang if mirror else ang
    return math.pi - ang


def surface_touches(r: int, case: int, mirror: bool, z_turn):
    """Number of surface reflections of the path (Fresnel factor count)."""
    n = (r if case == 1 else r - 1) + int(mirror)
    return torch.where(z_turn >= 0, n, 0)


def _leg_integral(c0, z_turn, z_start, ice: IceModelSimple, frequencies, model, qt, qw):
    """I(z_start) = int_{z_start}^{z_turn} ds / L by the t-substitution
    z = z_turn - t^2, [..., F] (``I_of`` of raytrace.py:483, :515)."""
    qt = torch.as_tensor(qt, dtype=c0.dtype, device=c0.device)
    qw = torch.as_tensor(qw, dtype=c0.dtype, device=c0.device)
    T = torch.sqrt(torch.clamp(z_turn - z_start, min=0.0))[..., None]
    t = qt * T
    z = z_turn[..., None] - t ** 2
    nz = _n_z(z, ice)
    arg = torch.clamp(_arg_stable(z, c0[..., None], ice), min=1e-20)
    ds_dt = 2.0 * t * c0[..., None] * nz / torch.sqrt(arg)
    inv_L = attenuation_ops.inv_length_factored(z, frequencies, model)   # [..., Q, F]
    return torch.sum((qw * ds_dt)[..., None] * inv_L, dim=-2) * T


def attenuation_factor_general(c0, x1z, x2z, ice: IceModelSimple, frequencies,
                               model: str, r, case, mirror, n_steps: int = 64,
                               quadrature: str = "midpoint"):
    """Attenuation of an r-bounce path (raytrace.py:472): exponent =
    c1 I(z1) + cb I(zb) + c2 I(z2), I(z) = int_z^{z_turn} ds / L."""
    c0, x1z, x2z = torch.broadcast_tensors(c0, x1z, x2z)
    _, z_turn = _turning_point(c0, ice)
    qt, qw = _quad_nodes(n_steps, quadrature)

    def I_of(z_start):
        return _leg_integral(c0, z_turn, z_start, ice, frequencies, model, qt, qw)

    c1 = 1.0 if case == 1 else -1.0
    cb = 2.0 * r
    c2 = 1.0 if mirror else -1.0
    zb = _refl_depth(ice, c0).expand(c0.shape)
    return torch.exp(-(c1 * I_of(x1z) + cb * I_of(zb) + c2 * I_of(x2z)))


def attenuation_factor_slots(c0, sol_type, reflection, refl_case, x1z, x2z,
                             ice: IceModelSimple, frequencies, model: str,
                             n_steps: int = 64, quadrature: str = "gauss"):
    """``attenuation_factor_general`` with per-slot (r, case, mirror) tensors:
    one code path over all 2 + 4 n_reflections slots of
    ``find_solutions_all``, r = 0 included (raytrace.py:501). mirror is
    sol_type != direct, case the stored refl_case. The bottom leg is
    evaluated for every slot and weighted by cb = 2 r (0 where there is no
    bounce: every leg integral is finite, so the sum holds no NaN)."""
    c0, sol_type, reflection, refl_case, x1z, x2z = torch.broadcast_tensors(
        c0, sol_type, reflection, refl_case, x1z, x2z)
    _, z_turn = _turning_point(c0, ice)
    qt, qw = _quad_nodes(n_steps, quadrature)

    def I_of(z_start):
        return _leg_integral(c0, z_turn, z_start, ice, frequencies, model, qt, qw)

    one = torch.ones((), dtype=c0.dtype, device=c0.device)
    c1 = torch.where(refl_case == 1, one, -one)[..., None]
    cb = (2.0 * reflection.to(c0.dtype))[..., None]
    c2 = torch.where(sol_type != SOL_DIRECT, one, -one)[..., None]
    zb = _refl_depth(ice, c0).expand(c0.shape)
    return torch.exp(-(c1 * I_of(x1z) + cb * I_of(zb) + c2 * I_of(x2z)))


def find_solutions_all(x1y, x1z, x2y, x2z, ice: IceModelSimple,
                       n_reflections: int = 0, n_bisect: int = 96) -> RaySolutions:
    """All solutions including bottom reflections, batched over the leading
    axes: 2 + 4 n_reflections slots (last axis) ordered
    [r=0 x2, (r=1, case 1) x2, (r=1, case 2) x2, ...] (raytrace.py:570). The
    bounce slots keep the solver's order (root of the direct-or-low-mirror
    branch, then the high mirror root); ``sol_type`` is 0 where invalid."""
    base = find_solutions(x1y, x1z, x2y, x2z, ice, n_bisect)
    if n_reflections == 0:
        return base
    if ice.refl_z is None:
        raise ValueError("n_reflections > 0 requires an ice model with a reflective bottom")
    a, b, d = (x[..., None] for x in (x1y, x1z, x2z))
    parts = [base]
    for r in range(1, n_reflections + 1):
        for case in (1, 2):
            logc0, valid, mk = _solve_reflection_roots(
                x1y, x1z, x2y, x2z, ice, r, case, n_bisect)
            c0 = _c0_from_log(logc0, ice.n_ice)
            _, z_turn = _turning_point(c0, ice)
            one = torch.ones_like(c0, dtype=torch.int32)
            sol_type = torch.where(
                mk, torch.where(z_turn >= 0, one * SOL_REFLECTED, one * SOL_REFRACTED),
                one * SOL_DIRECT)

            def pick(fn):
                return torch.where(mk, fn(True), fn(False))

            parts.append(RaySolutions(
                c0=c0, c1=_c1_of(a, b, c0, ice), mask=valid,
                sol_type=torch.where(valid, sol_type, torch.zeros_like(sol_type)),
                launch_angle=launch_angle_general(c0, b, ice, case),
                receive_angle=pick(lambda m: receive_angle_general(c0, d, ice, m)),
                path_length=pick(lambda m: path_length_general(c0, b, d, ice, r, case, m)),
                travel_time=pick(lambda m: travel_time_general(c0, b, d, ice, r, case, m)),
                reflection=one * r, refl_case=one * case))
    return RaySolutions(*(torch.cat(xs, dim=-1) for xs in zip(*parts)))


# ---- ice to air (raytrace.py:906-991): one solution lies between the
# vertical ray and the ray that leaves at the critical angle. The
# reference's own Python path returns none here (its objective cannot
# change sign for a receiver in the air); this solves the physics directly.

def _air_miss(logc0, x1y, x1z, x2y, x2z, ice: IceModelSimple):
    """Horizontal miss at a receiver in the air: the closed-form in-ice path
    to the surface, then a straight Snell-refracted line."""
    c0 = _c0_from_log(logc0, ice.n_ice)
    y_exit = x1y + _w_up(torch.zeros_like(c0), c0, ice) - _w_up(x1z, c0, ice)
    n_surf = ice.n_ice - ice.delta_n
    sin_ice = 1.0 / (c0 * n_surf)          # zenith sine at the surface, in the ice
    sin_air = torch.clamp(n_surf * sin_ice, 0.0, 1.0 - 1e-12)
    tan_air = sin_air / torch.sqrt(1.0 - sin_air ** 2)
    return x2y - (y_exit + x2z * tan_air)


def find_solution_ice_to_air(x1y, x1z, x2y, x2z, ice: IceModelSimple, n_bisect: int = 96,
                             device=device_util.DEFAULT) -> RaySolutions:
    """The single solution for a receiver above the surface (x2z > 0),
    batched over the inputs' axes (raytrace.py:928): a bisection in log C0
    between the ray leaving at the critical angle and the vertical one.
    Numbers or arrays are put on ``device`` (float64); every field gains a
    trailing slot axis of 1."""
    dev = device_util.resolve(device)
    x1y, x1z, x2y, x2z = torch.broadcast_tensors(*(
        x.to(dev) if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float64, device=dev)
        for x in (x1y, x1z, x2y, x2z)))
    n_surf = ice.n_ice - ice.delta_n
    eps = 1e-12 if x1y.dtype == torch.float64 else 1e-5
    # the flattest escaping ray leaves at the critical angle: c0 = 1 / n_surf
    lo0 = torch.full_like(x1y, math.log(1.0 / n_surf - 1.0 / ice.n_ice) + eps)
    hi0 = torch.full_like(x1y, _LOGC0_HI)

    def f(lg):
        return _air_miss(lg, x1y, x1z, x2y, x2z, ice)

    s_lo = torch.sign(f(lo0))
    has = s_lo != torch.sign(f(hi0))
    lo, hi = lo0, hi0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        same = torch.sign(f(mid)) == s_lo
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    c0 = _c0_from_log(0.5 * (lo + hi), ice.n_ice)

    # observables: the in-ice leg to z = 0 in closed form, plus the air leg
    beta, alpha = _bouma_beta_alpha(c0, x1z, ice)
    zero = torch.zeros_like(c0)

    def parts(z):
        nz = _n_z(z, ice)
        gam = torch.clamp(nz ** 2 - beta ** 2, min=0.0)
        l1 = torch.sqrt(alpha * gam) + ice.n_ice * nz - beta ** 2
        l2 = torch.sqrt(gam) + nz
        return gam, l1, l2

    def s_of(z):
        _, l1, l2 = parts(z)
        return (ice.n_ice / torch.sqrt(alpha) * (z - ice.z_0 * torch.log(l1))
                + ice.z_0 * torch.log(l2))

    def ct_of(z):
        gam, l1, l2 = parts(z)
        return (ice.z_0 * (torch.sqrt(gam) - ice.n_ice ** 2 / torch.sqrt(alpha) * torch.log(l1)
                           + ice.n_ice * torch.log(l2))
                + ice.n_ice ** 2 * z / torch.sqrt(alpha))

    y_exit = x1y + _w_up(zero, c0, ice) - _w_up(x1z, c0, ice)
    d_air = torch.sqrt((x2y - y_exit) ** 2 + x2z ** 2)
    path = s_of(zero) - s_of(x1z) + d_air
    ttime = (ct_of(zero) - ct_of(x1z)) / speed_of_light + d_air / speed_of_light
    sin_air = torch.clamp(n_surf * (1.0 / (c0 * n_surf)), 0.0, 1.0 - 1e-12)
    one = torch.ones_like(c0, dtype=torch.int32)
    sol_type = torch.where(has, one * SOL_DIRECT, 0 * one)
    sols = RaySolutions(
        c0=c0, c1=_c1_of(x1y, x1z, c0, ice), mask=has, sol_type=sol_type,
        launch_angle=torch.atan(_dy_dz(x1z, c0, ice)),
        receive_angle=math.pi - torch.asin(sin_air),   # from +z, arriving from below
        path_length=path, travel_time=ttime,
        reflection=0 * one, refl_case=one)
    return RaySolutions(*(t[..., None] for t in sols))


def to_2d(x1, x2) -> Geometry2D:
    """Rotate each pair into the y-z plane; x1, x2: (..., 3)."""
    swap = x2[..., 2] < x1[..., 2]
    a = torch.where(swap[..., None], x2, x1)   # lower point
    b = torch.where(swap[..., None], x1, x2)   # upper point
    d = b - a
    r_h = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
    dphi = -torch.atan2(d[..., 1], d[..., 0])
    zero = r_h == 0
    safe_r = torch.where(zero, 1.0, r_h)
    return Geometry2D(
        x1y=a[..., 0], x1z=a[..., 2],
        x2y=a[..., 0] + r_h, x2z=b[..., 2],
        swapped=swap, dphi=dphi,
        ux=torch.where(zero, 1.0, d[..., 0] / safe_r),
        uy=torch.where(zero, 0.0, d[..., 1] / safe_r))


def focusing_dtheta_dz(geom: Geometry2D, sols: RaySolutions, ice: IceModelSimple):
    """|d(launch angle at the emitter) / d(receiver depth)| at the solved
    roots (raytrace.py:1040): the dz -> 0 limit of the displaced-receiver
    focusing (get_focusing, analyticraytracing.py:2778-2888) by implicit
    differentiation of miss(logC0; z1, z2) = 0, both partials by central
    differences of the closed-form miss function. Shaped like ``sols.c0``;
    values at masked-out slots are meaningless."""
    dtype = sols.c0.dtype
    tiny = torch.tensor(1e-30, dtype=dtype, device=sols.c0.device)
    logc0 = torch.log(torch.maximum(sols.c0 - 1.0 / ice.n_ice, tiny))
    dy_target = (geom.x2y - geom.x1y)[..., None]
    is_mirror = sols.sol_type != SOL_DIRECT
    z1 = geom.x1z[..., None].expand(logc0.shape)
    z2 = geom.x2z[..., None].expand(logc0.shape)

    def miss(lg, z1_, z2_):
        md, mm = _branch_misses(lg, z1_, z2_, dy_target, ice)
        return torch.where(is_mirror, mm, md)

    # the steps change numbers: 1e-6 (float64) / 1e-3 (float32) in logC0,
    # the receiver displaced by +-5 mm
    h_l = (1e-6 if dtype == torch.float64 else 1e-3) * torch.clamp(torch.abs(logc0), min=1.0)
    h_z = 0.005
    g_l = (miss(logc0 + h_l, z1, z2) - miss(logc0 - h_l, z1, z2)) / (2 * h_l)
    # the true receiver is the 2D x1 when the pair was swapped
    swapped = geom.swapped[..., None].expand(logc0.shape)
    g_zr = (miss(logc0, torch.where(swapped, z1 + h_z, z1), torch.where(swapped, z2, z2 + h_z))
            - miss(logc0, torch.where(swapped, z1 - h_z, z1),
                   torch.where(swapped, z2, z2 - h_z))) / (2 * h_z)
    dlog_dzr = -g_zr / torch.where(torch.abs(g_l) > tiny, g_l, tiny)

    # emitter-side angle: launch angle at 2D x1, receive angle at 2D x2
    theta_e = torch.where(swapped, sols.receive_angle, sols.launch_angle)
    dth_dc0 = torch.sin(theta_e) / (sols.c0 * torch.clamp(torch.abs(torch.cos(theta_e)),
                                                            min=1e-6))
    dc0_dlog = sols.c0 - 1.0 / ice.n_ice
    return torch.abs(dth_dc0 * dc0_dlog * dlog_dzr)


def launch_receive_vectors(geom: Geometry2D, sols: RaySolutions):
    """3D launch and receive unit vectors [..., slot, 3], handling the swap
    (get_launch_vector/get_receive_vector, analyticraytracing.py:2561-2624)."""
    la, ra = sols.launch_angle, sols.receive_angle
    ux = geom.ux[..., None]
    uy = geom.uy[..., None]

    def rot_to_3d(sin_component, cos_component):
        return torch.stack([ux * sin_component, uy * sin_component,
                            cos_component], dim=-1)

    launch_plain = rot_to_3d(torch.sin(la), torch.cos(la))
    receive_plain = rot_to_3d(-torch.sin(ra), torch.cos(ra))
    swapped = geom.swapped[..., None, None]
    launch = torch.where(swapped, receive_plain, launch_plain)
    receive = torch.where(swapped, launch_plain, receive_plain)
    return launch, receive
