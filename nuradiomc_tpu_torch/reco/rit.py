"""Radio-interferometric air-shower reconstruction (RIT), batched (torch).

Counterpart of ``nuradiomc_tpu/reco/rit.py``
(NuRadioReco/modules/efieldRadioInterferometricReconstruction.py:32-956,
utilities/interferometry.py:24-327). The beamformed signal at a point in the
atmosphere is the sum of all antenna traces shifted by the refractivity-
corrected light travel time from that point; its longitudinal profile gives
X_RIT and the maxima of lateral planes give the shower axis.

The JAX package interpolates point by point; here every point of a zoom
level (and every depth of an axis pass) is one tensor program on the
module's device: the time shifts for [points, antennas], the linear
interpolation of every antenna trace onto each point's summed time grid
(zero outside it) and the sum over antennas. A point's summed grid is
``np.arange(min, max + tstep, tstep)`` of its own shifted times, so its
length varies from point to point, and the Hilbert envelope and the roll of
:func:`get_signal` depend on it: the lengths are computed on the host with
numpy's own rule from the shifts, the interpolation runs over buckets of
points of similar length (each point on its own grid, taken to the
bucket's longest length), and the Hilbert envelopes of a bucket's points,
each of its own length, are one Bluestein batch on power-of-two FFTs (one
FFT plan per distinct length would cost a plan and a launch chain each). The Gauss fit stays
``scipy.optimize.curve_fit`` on the host.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import optimize

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.models.atmosphere import Atmosphere, Refractivity
from nuradiomc_tpu_torch.reco.base import Module, host, register_run, rows_per_chunk
from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils import units
from nuradiomc_tpu_torch.utils.constants import speed_of_light

shp = par.showerParameters

CONVERSION_FACTOR_INTEGRATED_SIGNAL = 1.0 / (376.730313667 * units.ohm)

# The longest grid length of a bucket of points over its shortest: every
# point of a bucket is interpolated up to the bucket's longest length, so
# 1.125 wastes at most an eighth of a bucket's work on padding while keeping
# the buckets (each one interpolation and one envelope batch) few.
BUCKET_SPREAD = 1.125


def _chirp(m: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """exp(i pi m^2 / n) with m^2 reduced mod 2n in integers first."""
    return torch.polar(torch.ones_like(m, dtype=torch.float64),
                       torch.pi * torch.remainder(m * m, 2 * n).to(torch.float64) / n)


def ragged_dft(x: torch.Tensor, lengths: torch.Tensor, inverse=False) -> torch.Tensor:
    """The DFT of length ``lengths[p]`` of the first ``lengths[p]`` samples
    of each row of ``x`` [P, L] (complex), all rows in one batch by
    Bluestein's algorithm on power-of-two FFTs; samples past a row's length
    come back as 0 (``inverse``: the inverse DFT, 1/n included)."""
    P, L = x.shape
    M = 1 << (2 * L - 1).bit_length()
    n = lengths[:, None]
    j = torch.arange(L, device=x.device)
    inside = j < n
    w = _chirp(j.expand(P, L), n)                                 # w_j = e^{i pi j^2/n}
    if inverse:
        x = torch.conj(x)
    a = torch.zeros((P, M), dtype=torch.complex128, device=x.device)
    a[:, :L] = torch.where(inside, x * torch.conj(w), 0)
    b = torch.zeros((P, M), dtype=torch.complex128, device=x.device)
    b[:, :L] = torch.where(inside, w, 0)
    b[:, M - L + 1:] = torch.flip(torch.where(inside[:, 1:], w[:, 1:], 0), [1])
    conv = torch.fft.ifft(torch.fft.fft(a) * torch.fft.fft(b))[:, :L]
    out = torch.where(inside, torch.conj(w) * conv, 0)
    return torch.conj(out) / n if inverse else out


def ragged_hilbert_envelope(traces: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """|analytic signal| (``scipy.signal.hilbert``, even and odd lengths) of
    the first ``lengths[p]`` samples of each row of ``traces`` [P, L], by
    :func:`ragged_dft`; 0 past a row's length."""
    n = lengths[:, None]
    k = torch.arange(traces.shape[1], device=traces.device)
    h = torch.where((k == 0) | ((n % 2 == 0) & (k == n // 2)), 1.0,
                    torch.where((k >= 1) & (k < (n + 1) // 2), 2.0, 0.0))
    spec = ragged_dft(traces.to(torch.complex128), lengths)
    return torch.abs(ragged_dft(spec * h, lengths, inverse=True))


def get_signal(sum_traces: torch.Tensor, tsteps, window_width=100 * units.ns,
               kind="power", lengths=None) -> torch.Tensor:
    """Signal metric of beamformed traces [P, n] with sampling steps
    ``tsteps`` [P] (interferometry.get_signal:24-80): the envelope maximum,
    or the power (or envelope sum) in a window of ``window_width`` around it
    after the trace is rolled to put the maximum in the middle and zero
    padded when it is shorter than the window. With ``lengths`` [P] (host
    ints), row p is its first ``lengths[p]`` samples, else every row is
    whole. Every envelope, of rows of any lengths, is one Bluestein batch
    (:func:`ragged_hilbert_envelope`), equal to the FFT's to rounding."""
    if kind not in ("power", "hilbert_sum", "amplitude"):
        raise ValueError(f"unknown signal kind {kind}")
    P, width = sum_traces.shape
    dev = sum_traces.device
    tsteps = np.array(np.broadcast_to(np.asarray(tsteps, dtype=float), (P,)))
    lengths = np.full(P, width) if lengths is None else np.asarray(lengths)
    n = torch.as_tensor(lengths, device=dev)[:, None]
    env = ragged_hilbert_envelope(sum_traces, n[:, 0])
    peak = torch.argmax(env, -1)
    if kind == "amplitude":
        return torch.gather(env, -1, peak[:, None])[:, 0]
    half = np.floor_divide(window_width / 2, tsteps).astype(np.int64)
    half_t = torch.as_tensor(half, device=dev)[:, None]
    scale = torch.as_tensor(tsteps, device=dev)[:, None]
    k = torch.arange(2 * int(half.max()), device=dev)
    if kind == "hilbert_sum":
        # the rolled trace, padded by half a window on each side where it is
        # shorter than the window, is row p's own length n + 2 pad; the
        # envelope of all of them is one more ragged batch
        pad = np.where(lengths < 2 * half, half, 0)
        pad_t = torch.as_tensor(pad, device=dev)[:, None]
        i = torch.arange(int((lengths + 2 * pad).max()), device=dev) - pad_t
        src = torch.remainder(i - n // 2 + peak[:, None], n)
        tr = torch.where((i >= 0) & (i < n), torch.gather(sum_traces, -1, src), 0.0)
        env = ragged_hilbert_envelope(tr * CONVERSION_FACTOR_INTEGRATED_SIGNAL * scale,
                                      n[:, 0] + 2 * pad_t[:, 0])
        m = n // 2 + pad_t - half_t + k
        m = torch.clamp(m, max=env.shape[1] - 1)
        return torch.where(k < 2 * half_t, torch.gather(env, -1, m), 0.0).sum(-1)
    # rolled index i = n//2 - half + k of the window, k < 2 half; outside the
    # trace (a trace shorter than the window) it is a padded zero
    i = n // 2 - half_t + k
    src = torch.remainder(i - n // 2 + peak[:, None], n)
    vals = torch.gather(sum_traces, -1, src) * CONVERSION_FACTOR_INTEGRATED_SIGNAL * scale
    keep = (k < 2 * half_t) & (i >= 0) & (i < n)
    return torch.where(keep, vals ** 2, 0.0).sum(-1)


def summed_grids(tshifts: np.ndarray, times: np.ndarray):
    """The summed time grid of every point, as ``interfere_traces`` of the
    JAX package builds it from the shifted times ``times - tshifts[p, :, None]``:
    (start, step, fill step, length), each [P], with ``np.arange``'s length
    rule ceil((stop - start) / step); the grid is start + i * fill step,
    fill step = fl(start + step) - start, numpy's fill. Host float64, from ``tshifts`` [P, A] and ``times``
    [A, n]."""
    start = (times.min(axis=1)[None, :] - tshifts).min(axis=1)
    stop = (times.max(axis=1)[None, :] - tshifts).max(axis=1)
    step = (times[0, 1] - tshifts[:, 0]) - (times[0, 0] - tshifts[:, 0])
    length = np.ceil(((stop + step) - start) / step).astype(np.int64)
    delta = (start + step) - start
    return start, step, delta, length


def _interfere_group(traces, times, tshifts, start, delta, n_len):
    """[P, n_len] sums over antennas of ``np.interp(grid, times[a] - s[p, a],
    traces[a], left=0, right=0)`` for points of one grid length: numpy's
    bracket (xp[j] <= x < xp[j+1], by a binary search of the shifted times),
    slope and value."""
    P, A = tshifts.shape
    n = times.shape[-1]
    grid = start[:, None] + torch.arange(n_len, dtype=times.dtype,
                                         device=times.device) * delta[:, None]
    x = grid[:, None, :]                                          # [P, 1, L]
    xp = times[None] - tshifts[..., None]                         # [P, A, n]
    j = torch.searchsorted(xp, x.expand(P, A, n_len).contiguous(), right=True)
    j = (j - 1).clamp(0, n - 2)
    xj = torch.gather(xp, 2, j)
    xj1 = torch.gather(xp, 2, j + 1)
    f_a = traces[None].expand(P, A, n)
    fj = torch.gather(f_a, 2, j)
    fj1 = torch.gather(f_a, 2, j + 1)
    val = (fj1 - fj) / (xj1 - xj) * (x - xj) + fj
    val = torch.where(x == xj, fj, val)
    xpl = xp[..., -1:]
    val = torch.where(x == xpl, traces[None, :, -1:].expand(P, A, 1), val)
    val = torch.where((x < xp[..., :1]) | (x > xpl), 0.0, val)
    return val.sum(1)


class Interferometer:
    """The beamformed traces and signals of many points at once for one set
    of antenna traces, on ``device``."""

    def __init__(self, traces, times, positions, refractivity: Refractivity,
                 device=device_util.DEFAULT):
        self.device = device_util.resolve(device)
        self.times_np = np.asarray(times, dtype=float)
        self.traces = torch.as_tensor(np.asarray(traces, dtype=float), device=self.device)
        self.times = torch.as_tensor(self.times_np, device=self.device)
        self.positions = torch.as_tensor(np.asarray(positions, dtype=float),
                                         device=self.device)
        self.refr = refractivity
        self.last_chunks = {}

    def time_shifts(self, points: np.ndarray) -> torch.Tensor:
        """[P, A] light travel times from each point to each antenna."""
        pts = torch.as_tensor(np.asarray(points, dtype=float).reshape(-1, 3),
                              device=self.device)
        A = self.positions.shape[0]
        rows = rows_per_chunk(A * self.refr._n * 8 * 10, self.device, pts.shape[0])
        self.last_chunks["shifts"] = rows
        return torch.cat([self.refr.time_delay(pts[i:i + rows, None, :], self.positions,
                                               speed_of_light)
                          for i in range(0, pts.shape[0], rows)])

    def grids(self, points):
        """(shifts [P, A] on the device; the summed grids' starts, steps,
        fill steps and lengths [P] on the host, :func:`summed_grids`)."""
        shifts = self.time_shifts(points)
        return (shifts, *summed_grids(host(shifts), self.times_np))

    def sum_traces(self, shifts, start, delta, length):
        """The beamformed traces of all points, each on its own grid: a list
        of (point indices, [len(indices), L] traces) over buckets of points
        sorted by grid length, a bucket's lengths within ``BUCKET_SPREAD`` of
        each other and its points within one chunk of memory; point p's trace is
        the first ``length[p]`` samples of its row."""
        A, n = self.traces.shape
        start_t = torch.as_tensor(start, device=self.device)
        delta_t = torch.as_tensor(delta, device=self.device)
        order = np.argsort(length, kind="stable")
        out, at = [], 0
        while at < len(order):
            limit = length[order[at]] * BUCKET_SPREAD
            end = at + int(np.searchsorted(length[order[at:]], limit, side="right"))
            n_len = int(length[order[end - 1]])
            rows = rows_per_chunk(A * n_len * 8 * 12, self.device, end - at)
            self.last_chunks["interfere"] = rows
            idx = order[at:at + rows]
            sel = torch.as_tensor(idx, device=self.device)
            out.append((idx, _interfere_group(self.traces, self.times, shifts[sel],
                                              start_t[sel], delta_t[sel], n_len)))
            at += rows
        return out

    def signals(self, points, kind="power", window_width=100 * units.ns) -> np.ndarray:
        """get_signal of the beamformed trace at every point, [P] host: the
        interpolation and the sum over antennas by buckets of similar grid
        length, then the signals of a bucket's points in one batch, each of
        its own length."""
        points = np.asarray(points, dtype=float).reshape(-1, 3)
        out = np.zeros(len(points))
        if len(points) == 0:
            return out
        shifts, start, step, delta, length = self.grids(points)
        for idx, summed in self.sum_traces(shifts, start, delta, length):
            out[idx] = host(get_signal(summed, step[idx], window_width, kind, length[idx]))
        return out


def interfere_traces(target_pos, positions, traces, times, refractivity,
                     device=device_util.DEFAULT):
    """Shift every antenna trace to the source point and sum
    (interferometry.interfere_traces_rit:83-112): (summed trace tensor,
    tstep) of one point."""
    itf = Interferometer(traces, times, positions, refractivity, device)
    shifts, start, step, delta, length = itf.grids(np.asarray(target_pos)[None])
    ((_, summed),) = itf.sum_traces(shifts, start, delta, length)
    return summed[0], float(step[0])


# copied from nuradiomc_tpu/reco/rit.py:71-103
def shower_frame(zenith, azimuth, magnetic_field_vector):
    """(e_vxB, e_vxvxB, v) unit vectors; v = propagation direction of the
    shower (radiotools cstrafo convention: zenith/azimuth point back to the
    source)."""
    v = -np.array([np.sin(zenith) * np.cos(azimuth),
                   np.sin(zenith) * np.sin(azimuth), np.cos(zenith)])
    B = np.asarray(magnetic_field_vector, dtype=float)
    B = B / np.linalg.norm(B)
    e1 = np.cross(v, B)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(v, e1)
    e2 /= np.linalg.norm(e2)
    return e1, e2, v


def fit_axis_through_points(points, observation_level=0.0):
    """Least-squares line through beamformed maxima: returns (zenith,
    azimuth, core) with the core at the observation level
    (interferometry.fit_axis:251-289 equivalent)."""
    points = np.asarray(points, dtype=float)
    centroid = points.mean(axis=0)
    _, _, vh = np.linalg.svd(points - centroid)
    axis = vh[0]
    if axis[2] < 0:
        axis = -axis
    zenith = np.arccos(np.clip(axis[2], -1, 1))
    azimuth = np.mod(np.arctan2(axis[1], axis[0]), 2 * np.pi)
    t_core = (observation_level - centroid[2]) / axis[2]
    core = centroid + t_core * axis
    return zenith, azimuth, core


class efieldInterferometricDepthReco(Module):
    """Depth of the beamformed-emission maximum X_RIT along a given axis
    (efieldRadioInterferometricReconstruction.py:32-388)."""

    def begin(self, interpolation=True, signal_kind="power", debug=False,
              atmospheric_model=17, refractivity_at_ground=1.000292):
        self._signal_kind = signal_kind
        self._at = Atmosphere(atmospheric_model)
        self._refr = Refractivity(self._at, n0=refractivity_at_ground)

    def interferometer(self, traces, times, station_positions) -> Interferometer:
        """The batched interference of these antennas on the module's device
        (kept as ``last_interferometer``, whose ``last_chunks`` say how many
        points went into one chunk)."""
        self.last_interferometer = Interferometer(traces, times, station_positions, self._refr,
                                                  self.device)
        return self.last_interferometer

    def sample_longitudinal_profile(self, traces, times, station_positions,
                                    shower_axis, core, depths=None,
                                    distances=None):
        """Beamformed signal sampled along the axis (:78-160), every depth
        in one batch. ``shower_axis`` points from the core toward the source."""
        zenith = np.arccos(np.clip(shower_axis[2] / np.linalg.norm(shower_axis),
                                   -1, 1))
        dod = np.asarray(depths if depths is not None else distances, dtype=float)
        keep, points = [], []
        for idx, val in enumerate(dod):
            if depths is not None:
                try:
                    dist = self._at.get_distance_xmax_geometric(
                        zenith, val, observation_level=core[-1])
                except ValueError:
                    continue
            else:
                dist = val
            if dist < 0:
                continue
            keep.append(idx)
            points.append(np.asarray(shower_axis) * dist + np.asarray(core))
        signals = np.zeros(len(dod))
        if keep:
            itf = self.interferometer(traces, times, station_positions)
            signals[keep] = itf.signals(np.array(points), self._signal_kind)
        return signals

    # copied from nuradiomc_tpu/reco/rit.py:163-219
    def reconstruct_interferometric_depth(self, traces, times,
                                          station_positions, shower_axis,
                                          core, lower_depth=400.0,
                                          upper_depth=800.0, bin_size=100.0,
                                          return_profile=False):
        """Gauss fit to the longitudinal profile peak (:163-280), extending
        the sampling range if the maximum sits on an edge."""
        depths = np.arange(lower_depth, upper_depth, bin_size)
        sig = self.sample_longitudinal_profile(
            traces, times, station_positions, shower_axis, core, depths=depths)
        while np.argmax(sig) == len(depths) - 1 and depths[-1] <= 2000:
            depths = np.append(depths, depths[-1] + bin_size)
            sig = np.append(sig, self.sample_longitudinal_profile(
                traces, times, station_positions, shower_axis, core,
                depths=depths[-1:]))
        while np.argmax(sig) == 0 and depths[0] > 0:
            depths = np.append(depths[0] - bin_size, depths)
            sig = np.append(self.sample_longitudinal_profile(
                traces, times, station_positions, shower_axis, core,
                depths=depths[:1]), sig)

        imax = int(np.argmax(sig))
        lo = depths[max(imax - 1, 0)]
        hi = depths[min(imax + 1, len(depths) - 1)]
        depths_fine = np.linspace(lo, hi, 20)
        sig_fine = self.sample_longitudinal_profile(
            traces, times, station_positions, shower_axis, core,
            depths=depths_fine)

        def normal(x, A, x0, sigma):
            return A / np.sqrt(2 * np.pi * sigma ** 2) * np.exp(
                -0.5 * ((x - x0) / sigma) ** 2)

        popt, _ = optimize.curve_fit(
            normal, depths_fine, sig_fine,
            p0=[np.max(sig_fine), depths_fine[np.argmax(sig_fine)], 100],
            maxfev=1000)
        if return_profile:
            return depths, depths_fine, sig, sig_fine, popt
        return popt

    @register_run()
    def run(self, evt, station=None, det=None, traces=None, times=None,
            station_positions=None, shower_axis=None, core=None,
            shower=None):
        """Array-level entry point: pass the (vxB) traces and geometry
        directly, or a shower object to pull axis/core from parameters."""
        if shower is not None:
            zen, az = shower[shp.zenith], shower[shp.azimuth]
            shower_axis = np.array([np.sin(zen) * np.cos(az),
                                    np.sin(zen) * np.sin(az), np.cos(zen)])
            core = shower[shp.core]
        popt = self.reconstruct_interferometric_depth(
            traces, times, station_positions, shower_axis, core)
        return float(popt[1])


class efieldInterferometricAxisReco(efieldInterferometricDepthReco):
    """Shower-axis reconstruction from beamformed lateral maxima
    (efieldRadioInterferometricReconstruction.py:389-754, simplified as in
    the JAX package: the maxima of a refined transverse grid at several
    depths are fit with an SVD line). Every grid point of every depth of a
    zoom level is one batch."""

    def find_maximum_in_plane(self, xs, ys, p_axis, station_positions,
                              traces, times, frame):
        (k,), (signals,) = self._maxima_in_planes(
            [xs], [ys], [p_axis], self.interferometer(traces, times, station_positions),
            frame)
        return k, signals

    def _maxima_in_planes(self, xs_list, ys_list, p_axes, itf, frame):
        """Grid signals of several planes in one batch: for each plane the
        (i, j) of its maximum and its [nx, ny] signals."""
        e1, e2, _ = frame
        points = [p_axis + xs[:, None, None] * e1 + ys[None, :, None] * e2
                  for xs, ys, p_axis in zip(xs_list, ys_list, p_axes)]
        flat = itf.signals(np.concatenate([p.reshape(-1, 3) for p in points]),
                           self._signal_kind)
        ks, sigs, at = [], [], 0
        for p in points:
            s = flat[at:at + p.shape[0] * p.shape[1]].reshape(p.shape[:2])
            at += s.size
            ks.append(np.unravel_index(np.argmax(s), s.shape))
            sigs.append(s)
        return ks, sigs

    def lateral_maxima(self, traces, times, station_positions, axis_guess,
                       core_guess, depths, frame, grid_size=300.0, n_grid=7,
                       n_zoom=5, itf=None):
        """The beamformed maximum in the plane transverse to the axis at each
        slant depth of ``depths``: a coarse grid and ``n_zoom`` zooms, every
        depth's grid of a zoom level in one batch."""
        itf = itf or self.interferometer(traces, times, station_positions)
        zenith = np.arccos(np.clip(axis_guess[2], -1, 1))
        p_axes = [np.asarray(axis_guess) * self._at.get_distance_xmax_geometric(
            zenith, depth, observation_level=core_guess[-1]) + np.asarray(core_guess)
            for depth in depths]
        centers = [np.zeros(2) for _ in depths]
        half = grid_size
        for _ in range(n_zoom):
            xs_list = [c[0] + np.linspace(-half, half, n_grid) for c in centers]
            ys_list = [c[1] + np.linspace(-half, half, n_grid) for c in centers]
            ks, _ = self._maxima_in_planes(xs_list, ys_list, p_axes, itf, frame)
            centers = [np.array([xs[i], ys[j]])
                       for (i, j), xs, ys in zip(ks, xs_list, ys_list)]
            half = half / (n_grid - 1) * 2
        e1, e2, _ = frame
        return [p_axis + c[0] * e1 + c[1] * e2 for p_axis, c in zip(p_axes, centers)]

    def sample_lateral_cross_section(self, traces, times, station_positions,
                                     axis_guess, core_guess, depth, frame,
                                     grid_size=300.0, n_grid=7, n_zoom=5):
        """Maximum of the beamformed signal in the plane transverse to the
        axis at slant depth ``depth``; coarse grid + recursive zoom."""
        return self.lateral_maxima(traces, times, station_positions, axis_guess,
                                   core_guess, [depth], frame, grid_size, n_grid,
                                   n_zoom)[0]

    def reconstruct_shower_axis(self, traces, times, station_positions,
                                axis_guess, core_guess,
                                magnetic_field_vector,
                                depths=(500.0, 600.0, 700.0, 800.0),
                                grid_size=300.0, n_iterations=2):
        """Iterative: the fitted axis/core of one pass seed the next, with a
        shrinking transverse search window (the reference's angular zoom,
        :456-754, collapsed into whole-axis passes)."""
        itf = self.interferometer(traces, times, station_positions)
        axis, core = np.asarray(axis_guess, float), np.asarray(core_guess, float)
        size = grid_size
        for _ in range(n_iterations):
            zen0 = np.arccos(np.clip(axis[2], -1, 1))
            az0 = np.arctan2(axis[1], axis[0])
            frame = shower_frame(zen0, np.mod(az0 + np.pi, 2 * np.pi),
                                 magnetic_field_vector)
            points = self.lateral_maxima(traces, times, station_positions, axis, core,
                                         depths, frame, grid_size=size, itf=itf)
            zenith, azimuth, core = fit_axis_through_points(
                points, observation_level=core_guess[-1])
            axis = np.array([np.sin(zenith) * np.cos(azimuth),
                             np.sin(zenith) * np.sin(azimuth),
                             np.cos(zenith)])
            size = max(size / 5.0, 40.0)
        return zenith, azimuth, core
