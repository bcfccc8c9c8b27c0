"""The layered Earth's chord integral on the card.

``slant_depth`` is ``sim.earth_attenuation.EarthModel.slant_depth`` for a
run on a CUDA device: the per-chord prelude (the shift by the Earth radius,
the unit direction, the entry distance) stays on the host in numpy, line for
line as the method has it (``chords``); the trapezoid over the sample
positions ``np.linspace(0, 1, n_samples)`` of every chord is one launch of
the CUDA kernel ``csrc/earth_slant.cu``, whose result is read back once (the
``weights`` host-sync site). Everything is float64, whatever the run's
dtype. The numpy method stays the CPU path and the reference: the kernel
computes each sample's point, radius, density and trapezoid term with
numpy's operations in numpy's order, so only the order of the sum differs
from ``np.trapz``'s.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nuradiomc_tpu_torch.ops import _build
from nuradiomc_tpu_torch.utils import timing

# kernel launches since the count was last set to 0
launches = 0


def chords(earth, endpoints, directions):
    """(endpoints shifted by the Earth radius [N, 3], unit directions [N, 3],
    distances to the surface [N]): ``EarthModel.slant_depth``'s prelude."""
    endpoints = np.atleast_2d(np.asarray(endpoints, dtype=float)).copy()
    directions = np.atleast_2d(np.asarray(directions, dtype=float))
    endpoints[:, 2] += earth.earth_radius
    d = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    dot = np.sum(endpoints * d, axis=-1)
    disc = dot ** 2 - np.sum(endpoints ** 2, axis=-1) + earth.earth_radius ** 2
    distance = np.where(disc > 0, -dot + np.sqrt(np.maximum(disc, 0.0)), 0.0)
    distance = np.maximum(distance, 0.0)
    return endpoints, d, distance


def _kernel():
    lib = _build.load("earth_slant")
    fn = lib.earth_slant_f64
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_long, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_double]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn, lib.earth_slant_max_shells()


def integrate(earth, ends, dirs, dist, ts) -> torch.Tensor:
    """The column densities [N] on the card: one launch over the device
    tensors of ``chords`` (float64, contiguous) and the sample positions
    ``ts``; nothing is synchronized."""
    global launches
    fn, max_shells = _kernel()
    radii = np.ascontiguousarray(earth.radii, dtype=np.float64)
    coeffs = np.ascontiguousarray(earth.coeffs, dtype=np.float64)
    if not 1 <= len(radii) <= max_shells or coeffs.shape != (len(radii), 4):
        raise ValueError(f"earth slant: {len(radii)} shells with coefficients {coeffs.shape}; "
                         f"the kernel takes 1 to {max_shells} shells of 4 coefficients")
    n = dist.shape[0]
    for t, shape in ((ends, (n, 3)), (dirs, (n, 3)), (dist, (n,)), (ts, (ts.shape[0],))):
        if (t.device.type != "cuda" or t.dtype != torch.float64 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"earth slant: want contiguous float64 CUDA tensors of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if ts.shape[0] < 2:
        raise ValueError(f"earth slant: {ts.shape[0]} samples; the trapezoid needs 2 or more")
    out = torch.empty(n, dtype=torch.float64, device=dist.device)
    if n:
        err = fn(ends.data_ptr(), dirs.data_ptr(), dist.data_ptr(), ts.data_ptr(), n,
                 ts.shape[0], radii.ctypes.data, coeffs.ctypes.data, len(radii),
                 earth.earth_radius, out.data_ptr(), _build.current_stream_ptr(dist.device))
        _build.check(err, "earth slant kernel")
        launches += 1
        timing.count("weights.kernel_chords", n)
    return out


def slant_depth(earth, endpoints, directions, n_samples=4096, device=None) -> np.ndarray:
    """``earth.slant_depth(endpoints, directions, n_samples)`` with the
    integral on the CUDA ``device``: the prelude on the host, one launch,
    one read-back. The sample positions are numpy's ``linspace``, copied
    to the card with the chords and freed with them. Returns numpy float64
    [N]."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        raise ValueError(f"earth slant: device {device!r} is not a CUDA device; the numpy "
                         f"EarthModel.slant_depth is the path off the card")
    ends, d, dist = chords(earth, endpoints, directions)
    ts = np.linspace(0.0, 1.0, n_samples)
    slant = integrate(earth, *(torch.as_tensor(a, device=dev) for a in (ends, d, dist, ts)))
    with timing.host_sync("weights"):
        return slant.cpu().numpy()
