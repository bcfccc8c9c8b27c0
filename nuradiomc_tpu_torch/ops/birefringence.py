"""Birefringent pulse propagation (torch).

Counterpart of ``nuradiomc_tpu/ops/birefringence.py``: effective refractive
indices and the polarization eigenbasis from the diagonalized dielectric
tensor, and the per-segment path scan that rotates (eTheta, ePhi) into the
birefringent eigenbasis, applies the fast/slow relative time shift and
rotates back (NuRadioMC get_pulse_propagation_birefringence:2369-2445).

Every function is elementwise over leading batch axes: where the JAX package
``vmap``s one path at a time, :func:`path_points_3d` and
:func:`propagate_pulse` take all paths at once ([P] geometry, [P, F]
spectra). The segment scan (:func:`segment_scan`) is one launch of the CUDA
kernel ``csrc/birefringence_scan.cu`` for CUDA tensors and the plain
version, :func:`segment_scan_plain`, for CPU tensors: a Python loop over
segments on [P, F] tensors that computes each segment's phase from its
scalar time shift inside the step, so no [P, K, F] phase is ever built.
Everything runs in the real dtype of the path (the model tables are cast to
it), as the JAX package does with x64 off.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import numpy as np
import torch

from nuradiomc_tpu_torch.utils.constants import speed_of_light
from nuradiomc_tpu_torch.models.ice import IceModelSimple
from nuradiomc_tpu_torch.ops import _build, raytrace
from nuradiomc_tpu_torch.utils import geometry, timing

_MODEL_DIR = Path(__file__).resolve().parents[1] / "data" / "birefringence_models"

# segment-scan kernel launches since the count was last set to 0
launches = 0


# copied from nuradiomc_tpu/ops/birefringence.py:37 (load_model)
@functools.lru_cache(maxsize=8)
def load_model(name: str = "southpole_A", n_depth: int = 2501):
    """(depths[m positive], nx, ny, nz) dense tables from the spline model."""
    from scipy import interpolate

    path = _MODEL_DIR / f"birefringence_{name}.npy"
    if not path.exists():
        raise FileNotFoundError(f"birefringence model {name} not found")
    tck = np.load(path, allow_pickle=True)
    f1 = interpolate.UnivariateSpline._from_tck(tck[0])
    f2 = interpolate.UnivariateSpline._from_tck(tck[1])
    f3 = interpolate.UnivariateSpline._from_tck(tck[2])
    depths = np.linspace(0.0, 2500.0, n_depth)
    return (depths, f1(depths), f2(depths), f3(depths))


@functools.lru_cache(maxsize=8)
def _model_tensors(name: str, dtype, device):
    """``load_model(name)``'s tables as tensors of ``dtype`` on ``device``,
    copied there once: a copy from host memory waits for the device's queue,
    so each call would hold the host until the work before it ran."""
    return tuple(torch.as_tensor(t, dtype=dtype, device=device) for t in load_model(name))


def _interp(x, xp, *fps):
    """``jnp.interp(x, xp, fp)`` for each table ``fp`` on one strictly
    increasing ``xp``: linear interpolation, clamped to fp[0] / fp[-1]
    outside (torch has no interp). The bracket and weight of ``x`` are found
    once for all the tables."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    lo = i - 1
    w = (x - xp[lo]) / (xp[i] - xp[lo])
    below, above = x < xp[0], x > xp[-1]
    out = []
    for fp in fps:
        f = torch.where(below, fp[0], fp[lo] + w * (fp[i] - fp[lo]))
        out.append(torch.where(above, fp[-1], f))
    return out


def _eigensystem_2x2(direction, nx, ny, nz):
    """Exact transverse-D eigensystem of the dielectric tensor, posed so
    float32 cannot blow it up (birefringence.py:58-134, as posed there).

    The dispersion relation ``(P_t B P_t) D = (1/n^2) D`` with ``B =
    diag(1/nx^2, 1/ny^2, 1/nz^2)`` restricted to the on-sky (theta-hat,
    phi-hat) basis is a symmetric 2x2 eigenproblem whose eigenvectors are
    exactly orthonormal, so each segment's propagation matrix is a pure
    rotation. The anisotropy enters only through ``delta_i = B_i - mean(B)``
    (no large-term cancellation). NuRadioMC's eigenvector formula
    ``s_i / (n^2 - n_i^2)`` is never used: in float32 its denominator is
    cancellation noise near a principal index and the scan amplifies the
    resulting non-orthogonality by e^30..e^70 over a path.

    Returns (n1, n2, cos_psi, sin_psi, dn, k1sq, k2sq): n1 <= n2 (fast mode
    first), the fast-mode eigenvector angle psi in the (theta_hat, phi_hat)
    basis, dn = n2 - n1 without cancellation, and k_i^2 <= 1 the reference's
    per-segment walk-off damping of mode i."""
    sx, sy, sz = direction[..., 0], direction[..., 1], direction[..., 2]
    rho = torch.sqrt(sx ** 2 + sy ** 2)
    safe = rho > 1e-12
    inv_rho = torch.where(safe, 1.0 / torch.clamp(rho, min=1e-12), 0.0)
    cp = torch.where(safe, sx * inv_rho, 1.0)
    sp = torch.where(safe, sy * inv_rho, 0.0)
    ct, st_ = sz, rho
    th = (ct * cp, ct * sp, -st_)          # theta_hat
    ph = (-sp, cp, torch.zeros_like(sp))   # phi_hat

    bx, by, bz = 1.0 / nx ** 2, 1.0 / ny ** 2, 1.0 / nz ** 2
    bbar = (bx + by + bz) / 3.0
    dx, dy, dz = bx - bbar, by - bbar, bz - bbar
    q11 = dx * th[0] ** 2 + dy * th[1] ** 2 + dz * th[2] ** 2
    q22 = dx * ph[0] ** 2 + dy * ph[1] ** 2 + dz * ph[2] ** 2
    m12 = dx * th[0] * ph[0] + dy * th[1] * ph[1] + dz * th[2] * ph[2]
    half_diff = 0.5 * (q11 - q22)
    mean = bbar + 0.5 * (q11 + q22)
    r = torch.sqrt(half_diff ** 2 + m12 ** 2)
    lam1, lam2 = mean + r, mean - r        # lam1 >= lam2  ->  n1 <= n2
    s1, s2 = torch.sqrt(lam1), torch.sqrt(lam2)
    n1, n2 = 1.0 / s1, 1.0 / s2
    dn = 2.0 * r / (s1 * s2 * (s1 + s2))   # n2 - n1 without cancellation
    psi = 0.5 * torch.atan2(2.0 * m12, q11 - q22)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)

    def _ksq(c, s, lam):
        # the reference's 2D norm of the projected 3D E eigenvector, squared
        v = (c * th[0] + s * ph[0], c * th[1] + s * ph[1],
             c * th[2] + s * ph[2])
        bv2 = (bx * v[0]) ** 2 + (by * v[1]) ** 2 + (bz * v[2]) ** 2
        return lam ** 2 / bv2

    k1sq = _ksq(cpsi, spsi, lam1)
    k2sq = _ksq(-spsi, cpsi, lam2)
    return n1, n2, cpsi, spsi, dn, k1sq, k2sq


def effective_indices(direction, nx, ny, nz):
    """(n1, n2) effective indices (get_effective_index_birefringence:
    2165-2210), n1 <= n2, from the stable eigensystem."""
    n1, n2, _, _, _, _, _ = _eigensystem_2x2(direction, nx, ny, nz)
    return n1, n2


def polarization_onsky(n_eff, direction, nx, ny, nz, eps=0.0):
    """Normalized polarization eigenvector projected on (eTheta, ePhi)
    (get_polarization_birefringence_simple:2212-2243). Diagnostic only:
    its ``n^2 - n_i^2`` denominators are float32-catastrophic, and the scan
    uses the rotation of :func:`_eigensystem_2x2` instead."""
    d = torch.stack([direction[..., 0] / (n_eff ** 2 - nx ** 2 + eps),
                     direction[..., 1] / (n_eff ** 2 - ny ** 2 + eps),
                     direction[..., 2] / (n_eff ** 2 - nz ** 2 + eps)], dim=-1)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-30)
    zen, az = geometry.cartesian_to_spherical(direction)
    onsky = geometry.ground_to_onsky(d, zen, az)
    return onsky[..., 1], onsky[..., 2]


def _linspace(start, stop, num: int):
    """``jnp.linspace(start, stop, num)`` along a new last axis, with its
    arithmetic: start * (1 - t) + stop * t, t = i / (num - 1), stop exact."""
    div = num - 1
    t = (torch.arange(div, dtype=start.dtype, device=start.device)
         / torch.full((), div, dtype=start.dtype, device=start.device))
    out = start[..., None] * (1 - t) + stop[..., None] * t
    return torch.cat([out, stop[..., None]], dim=-1)


def path_points_3d(c0, geom: raytrace.Geometry2D, ice: IceModelSimple,
                   n_points: int, iceflow_angle: float = 0.0):
    """3D sample points along each ray solution (get_path:2060-2116 + the
    ice-flow rotation of get_pulse_propagation_birefringence:2405-2408).
    ``c0`` and the geometry fields share the leading shape [...];
    returns [..., n_points, 3]."""
    c1 = raytrace._c1_of(geom.x1y, geom.x1z, c0, ice)
    gamma_turn, z_turn = raytrace._turning_point(c0, ice)
    z2m = raytrace._z2_past_turn(c0, c1, gamma_turn, z_turn, geom.x1z, geom.x2y, geom.x2z, ice)

    zm = _linspace(geom.x1z, z2m, n_points)            # [..., n_points]
    c0, c1, z_turn = c0[..., None], c1[..., None], z_turn[..., None]
    below = zm < z_turn
    y_below = raytrace._y_of_gamma(raytrace._gamma(zm, ice), c0, c1, ice)
    y_turn = raytrace._y_of_gamma(raytrace._gamma(z_turn, ice), c0, c1, ice)
    y_above = 2 * y_turn - raytrace._y_of_gamma(
        raytrace._gamma(2 * z_turn - zm, ice), c0, c1, ice)
    y = torch.where(below, y_below, y_above)
    z = torch.where(below, zm, 2 * z_turn - zm)

    # into 3D: horizontal direction (ux, uy) from the 2D reduction, then the
    # rotation by the ice-flow angle
    dx = y - geom.x1y[..., None]
    px = geom.ux[..., None] * dx
    py = geom.uy[..., None] * dx
    ca, sa = math.cos(iceflow_angle), math.sin(iceflow_angle)
    x_rot = ca * px - sa * py
    y_rot = sa * px + ca * py
    return torch.stack([x_rot, y_rot, z], dim=-1)


def segment_parameters(path_xyz, ice: IceModelSimple, model: str = "southpole_A"):
    """Each segment's scan parameters along paths [..., K, 3]: (cpsi, spsi,
    k1sq, k2sq, dt_rel, ok), each [..., K-1] and contiguous, in the path's
    dtype (``ok`` bool: the eigensystem and the delay finite and the length
    above 0)."""
    depths, bx, by, bz = _model_tensors(model, path_xyz.dtype, path_xyz.device)

    p0 = path_xyz[..., :-1, :]
    d_vec = path_xyz[..., 1:, :] - p0
    seg_len = torch.sqrt(torch.sum(d_vec * d_vec, dim=-1))           # [P, K-1]
    direction = d_vec / torch.clamp(seg_len[..., None], min=1e-30)

    n_iso = ice.index_of_refraction(p0[..., 2])
    depth_pos = -p0[..., 2]
    nx, ny, nz = (n_iso + b - 1.78 for b in _interp(depth_pos, depths, bx, by, bz))

    _, _, cpsi, spsi, dn, k1sq, k2sq = _eigensystem_2x2(direction, nx, ny, nz)
    dt_rel = seg_len * dn / speed_of_light          # t_slow - t_fast >= 0
    ok = (torch.isfinite(cpsi) & torch.isfinite(spsi) & torch.isfinite(dt_rel)
          & (seg_len > 0))
    return tuple(t.contiguous() for t in (cpsi, spsi, k1sq, k2sq, dt_rel, ok))


def propagate_pulse(spec_theta, spec_phi, path_xyz, frequencies,
                    ice: IceModelSimple, model: str = "southpole_A"):
    """Propagate (eTheta(f), ePhi(f)) [P, F] along paths [P, K, 3] with
    per-segment birefringent eigenbasis rotations and relative time shifts
    (get_pulse_propagation_birefringence:2369-2445); returns the propagated
    (spec_theta, spec_phi).

    Each segment applies R^T diag(k1^2, k2^2 e^{-2 pi i f dt}) R with R an
    exact rotation and k_i <= 1, so the scan never amplifies. A segment whose
    eigensystem is not finite, or whose length is 0, is skipped by a select
    (never a multiply). The parameters (:func:`segment_parameters`) are plain
    PyTorch on either device; the scan is :func:`segment_scan`."""
    return segment_scan(spec_theta.contiguous(), spec_phi.contiguous(),
                        *segment_parameters(path_xyz, ice, model),
                        frequencies.to(path_xyz.dtype).contiguous())


def segment_scan_plain(spec_theta, spec_phi, cpsi, spsi, k1sq, k2sq, dt_rel, ok, frequencies):
    """The segment scan as plain PyTorch, the CPU path and the kernel's
    yardstick: spectra [..., F] through the segments [..., S] of each path
    in order, one segment's rotations, damping and phase a step; a segment
    whose ``ok`` is False is skipped by a select (never a multiply)."""
    ffr = frequencies.to(dt_rel.dtype)
    st, sp = spec_theta, spec_phi
    for k in range(cpsi.shape[-1]):
        cc, ss = cpsi[..., k, None], spsi[..., k, None]
        arg = ((-2.0 * math.pi) * dt_rel[..., k, None]) * ffr
        ph = torch.complex(torch.cos(arg), torch.sin(arg))
        b0 = k1sq[..., k, None] * (cc * st + ss * sp)     # fast mode (n1)
        b1 = k2sq[..., k, None] * (-ss * st + cc * sp)    # slow mode (n2)
        b1 = b1 * ph
        valid = ok[..., k, None]
        st, sp = (torch.where(valid, cc * b0 - ss * b1, st),
                  torch.where(valid, ss * b0 + cc * b1, sp))
    return st, sp


@functools.lru_cache(maxsize=2)
def _scan_fn(dtype):
    lib = _build.load("birefringence_scan")
    f64 = dtype == torch.float64
    fn = lib.birefringence_scan_f64 if f64 else lib.birefringence_scan_f32
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_long, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_double] + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn, lib.birefringence_scan_max_segments(int(f64))


def segment_scan(spec_theta, spec_phi, cpsi, spsi, k1sq, k2sq, dt_rel, ok, frequencies):
    """``segment_scan_plain``'s result: the CUDA kernel
    ``csrc/birefringence_scan.cu`` (one launch, on the current stream, no
    synchronize) for CUDA tensors, the plain version for CPU tensors. On the
    card the spectra [..., F] are complex64 / complex128, the segment arrays
    [..., S] the matching float32 / float64 (``ok`` bool or uint8), the
    frequencies [F] of that dtype, all contiguous on one device; anything
    else is refused. Returns two new [..., F] tensors."""
    global launches
    ts = (spec_theta, spec_phi, cpsi, spsi, k1sq, k2sq, dt_rel, ok, frequencies)
    devices = {t.device for t in ts}
    if devices == {torch.device("cpu")}:
        return segment_scan_plain(*ts)
    if len(devices) != 1:
        raise ValueError(f"birefringence scan: inputs on several devices "
                         f"{sorted(map(str, devices))}")
    rdtype = cpsi.dtype
    ctype = {torch.float32: torch.complex64, torch.float64: torch.complex128}.get(rdtype)
    if ctype is None:
        raise TypeError(f"birefringence scan: dtype {rdtype} is not float32/float64")
    want = [ctype] * 2 + [rdtype] * 5
    if ([t.dtype for t in ts[:7]] != want or ok.dtype not in (torch.bool, torch.uint8)
            or frequencies.dtype != rdtype):
        raise ValueError(f"birefringence scan: mixed dtypes {[t.dtype for t in ts]}; want "
                         f"{ctype} spectra, {rdtype} segments and frequencies, bool ok")
    lead, F, S = tuple(spec_theta.shape[:-1]), spec_theta.shape[-1], cpsi.shape[-1]
    if (tuple(spec_phi.shape) != lead + (F,) or tuple(frequencies.shape) != (F,)
            or any(tuple(t.shape) != lead + (S,) for t in ts[2:8])):
        raise ValueError(f"birefringence scan: shapes {[tuple(t.shape) for t in ts]}; want "
                         f"spectra [..., F], segments [..., S] with the same leading axes, "
                         f"frequencies [F]")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("birefringence scan: every input must be contiguous")
    dev = spec_theta.device
    if dev.type != "cuda":
        raise ValueError(f"birefringence scan: unsupported device {dev}")
    fn, max_segments = _scan_fn(rdtype)
    if S > max_segments:
        raise ValueError(f"birefringence scan: {S} segments a path; the kernel takes at most "
                         f"{max_segments} in {rdtype}")
    P = math.prod(lead)
    out_t, out_p = torch.empty_like(spec_theta), torch.empty_like(spec_phi)
    if P and F:
        err = fn(*(t.data_ptr() for t in ts[2:8]), spec_theta.data_ptr(), spec_phi.data_ptr(),
                 frequencies.data_ptr(), P, S, F, -2.0 * math.pi, out_t.data_ptr(),
                 out_p.data_ptr(), _build.current_stream_ptr(dev))
        _build.check(err, "birefringence scan kernel")
        launches += 1
        timing.count("birefringence.kernel_paths", P)
    return out_t, out_p
