"""Neutrino vertex reconstruction from channel-pair timing correlations (torch).

Counterpart of ``nuradiomc_tpu/reco/vertex.py`` (reference
neutrinoVertexReconstructor/neutrino2DVertexReconstructor.py:16-500, the
lookup-table generator create_lookup_table.py:1-107 and
neutrino3DVertexReconstructor.py:15-999). The travel-time tables are built
per antenna depth by the port's ray solver on the device, one batched solve
per chunk of grid points (the chunk sized from the free device memory);
the pair correlations, the nearest-bin lookups and the stacked maximum over
the nine ray-type pairs run on the device over the whole search grid.
"""

from __future__ import annotations

import numpy as np
import torch

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.reco.base import (Module, correlate_full, host, register_run,
                                           rows_per_chunk, spectrum_tensor)
from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils import fft, units

stnp = par.stationParameters

RAY_TYPE_INDEX = {"direct": 0, "refracted": 1, "reflected": 2}

# device bytes one grid point takes in the float64 ray solve (its live
# temporaries, two slots each), with room to spare: a whole 3,680,125-point
# table peaks at 2.19 GiB on an H100, ~640 B a point
SOLVE_BYTES_PER_POINT = 4096


def table_chunk(n_pts: int, device) -> int:
    """Grid points solved at once by :func:`build_travel_time_table`: half
    the free device memory over ``SOLVE_BYTES_PER_POINT`` on the card,
    65536 on the CPU (as the JAX package)."""
    if torch.device(device).type == "cuda":
        return rows_per_chunk(SOLVE_BYTES_PER_POINT, device, n_pts)
    return min(n_pts, 65536)


def build_travel_time_table(ice, antenna_z, x_min=10 * units.m,
                            x_max=5 * units.km, d_x=2 * units.m,
                            z_min=-3 * units.km, z_max=-50 * units.m,
                            d_z=2 * units.m, chunk=None, device=device_util.DEFAULT):
    """Travel-time tables t(r, z) for direct/refracted/reflected rays to an
    antenna at depth ``antenna_z`` (create_lookup_table.py:64-107; vertex.py:28),
    solved in float64 on ``device``.

    Returns (header dict, (3, n_x, n_z) float64 tensor on ``device``; 0 where
    no solution). ``chunk`` defaults to :func:`table_chunk`.
    """
    from nuradiomc_tpu_torch.ops import raytrace

    device = device_util.resolve(device)
    x_pos = np.arange(x_min, x_max, d_x)
    z_pos = np.arange(z_min, z_max, d_z)
    n_x, n_z = len(x_pos), len(z_pos)
    n_pts = n_x * n_z
    if chunk is None:
        chunk = table_chunk(n_pts, device)
    xs = torch.as_tensor(x_pos, device=device)
    zs = torch.as_tensor(z_pos, device=device)
    table = torch.zeros((3, n_pts), dtype=torch.float64, device=device)
    for i0 in range(0, n_pts, chunk):
        flat = torch.arange(i0, min(i0 + chunk, n_pts), device=device)
        m = flat.shape[0]
        x1 = torch.stack([xs[flat // n_z], torch.zeros(m, dtype=torch.float64, device=device),
                          zs[flat % n_z]], dim=-1)
        x2 = torch.tensor([0.0, 0.0, float(antenna_z)], dtype=torch.float64,
                          device=device).expand(m, 3)
        geom = raytrace.to_2d(x1, x2)
        sols = raytrace.find_solutions(geom.x1y, geom.x1z, geom.x2y, geom.x2z, ice)
        part = table[:, i0:i0 + m]
        for slot in range(sols.sol_type.shape[-1]):
            ok = sols.mask[:, slot] & (sols.sol_type[:, slot] > 0)
            for k in range(3):
                hit = ok & (sols.sol_type[:, slot] == k + 1)
                part[k] = torch.where(hit, sols.travel_time[:, slot], part[k])
    header = {"x_min": x_pos[0], "d_x": d_x, "n_x": n_x,
              "z_min": z_pos[0], "d_z": d_z, "n_z": n_z}
    return header, table.reshape(3, n_x, n_z)


def lookup_travel_time(header, table, ray_type, d_hor, z):
    """Nearest-bin lookup (get_signal_travel_time:396-433); NaN outside the
    grid or where the table holds no solution. ``d_hor`` and ``z`` are
    tensors (or arrays) on the table's device."""
    dev = table.device
    d_hor = torch.as_tensor(d_hor, dtype=torch.float64, device=dev)
    z = torch.as_tensor(z, dtype=torch.float64, device=dev)
    # divide by tensors: on the card a division by a Python number is a
    # multiply by its reciprocal, which rounds a bin edge differently
    d_x = torch.tensor(header["d_x"], dtype=torch.float64, device=dev)
    d_z = torch.tensor(header["d_z"], dtype=torch.float64, device=dev)
    i_x = torch.round((d_hor - header["x_min"]) / d_x).to(torch.int64)
    i_z = torch.round((z - header["z_min"]) / d_z).to(torch.int64)
    inside = (i_x >= 0) & (i_x < header["n_x"]) & (i_z >= 0) & (i_z < header["n_z"])
    tt = table[RAY_TYPE_INDEX[ray_type]][torch.clamp(i_x, 0, header["n_x"] - 1),
                                         torch.clamp(i_z, 0, header["n_z"] - 1)]
    return torch.where(inside & (tt > 0), tt, torch.nan)


class neutrino2DVertexReconstructor(Module):
    """Vertex (r, z) from stacked channel-pair correlation maps
    (neutrino2DVertexReconstructor.py:16-500).

    All channels must be on one string. For every channel pair and every
    ray-type hypothesis, the time difference expected from each grid point
    indexes the pair's cross-correlation; maps are stacked (weighted by
    correlation SNR) and the maximum is the reconstructed vertex.
    """

    RAY_TYPES = [
        ("direct", "direct"), ("reflected", "reflected"),
        ("refracted", "refracted"), ("direct", "reflected"),
        ("reflected", "direct"), ("direct", "refracted"),
        ("refracted", "direct"), ("reflected", "refracted"),
        ("refracted", "reflected"),
    ]
    DNR_RAY_TYPES = [
        ("direct", "reflected"), ("reflected", "direct"),
        ("direct", "refracted"), ("refracted", "direct"),
        ("reflected", "refracted"), ("refracted", "reflected"),
    ]

    def __init__(self, ice, table_kwargs=None, device=device_util.DEFAULT):
        """ice: the port's IceModelSimple the travel-time tables are built
        in; table_kwargs: grid overrides for build_travel_time_table."""
        super().__init__(device)
        self._ice = ice
        self._table_kwargs = table_kwargs or {}
        self._tables = {}

    def _setup(self, station_id, channel_ids, detector, passband, template):
        self._det = detector
        self._station_id = station_id
        self._channel_ids = list(channel_ids)
        self._pairs = [(a, b) for i, a in enumerate(channel_ids)
                       for b in channel_ids[i + 1:]]
        self._passband = passband
        self._template = template
        for cid in channel_ids:
            z = detector.get_relative_position(station_id, cid)[2]
            key = round(float(z), 3)
            if key not in self._tables:
                self._tables[key] = build_travel_time_table(
                    self._ice, z, device=self.device, **self._table_kwargs)

    def begin(self, station_id, channel_ids, detector, passband=None, template=None):
        first = detector.get_relative_position(station_id, channel_ids[0])
        for cid in channel_ids:
            pos = detector.get_relative_position(station_id, cid)
            if (abs(pos[0] - first[0]) > 1 * units.m
                    or abs(pos[1] - first[1]) > 1 * units.m):
                raise ValueError("All channels have to be on the same string")
        self._setup(station_id, channel_ids, detector, passband, template)

    def _travel_time(self, cid, ray_type, d_hor, z):
        key = round(float(self._det.get_relative_position(self._station_id, cid)[2]), 3)
        header, table = self._tables[key]
        return lookup_travel_time(header, table, ray_type, d_hor, z)

    def _pair_correlation(self, ch1, ch2):
        """Windowed, normalized cross-correlation of a channel pair
        (run:160-197), on the device."""
        from scipy import signal as scisig

        spec1 = spectrum_tensor(ch1, self.device)
        spec2 = spectrum_tensor(ch2, self.device)
        if self._passband is not None:
            b, a = scisig.butter(10, self._passband, "bandpass", analog=True)
            _, h = scisig.freqs(b, a, np.asarray(ch1.get_frequencies()))
            spec1 = spec1 * self.tensor(h)
            spec2 = spec2 * self.tensor(h)
        fs = ch1.get_sampling_rate()
        trace1 = fft.freq2time(spec1, fs)
        trace2 = fft.freq2time(spec2, fs)
        corr_range = 50 * units.ns
        t1 = self.tensor(np.asarray(ch1.get_times())[:trace1.shape[-1]])
        t2 = self.tensor(np.asarray(ch2.get_times())[:trace2.shape[-1]])
        if torch.max(torch.abs(trace1)) > torch.max(torch.abs(trace2)):
            far = torch.abs(t1 - t1[torch.argmax(torch.abs(trace1))]) > corr_range
            trace1 = torch.where(far, 0.0, trace1)
        else:
            far = torch.abs(t2 - t2[torch.argmax(torch.abs(trace2))]) > corr_range
            trace2 = torch.where(far, 0.0, trace2)
        corr = torch.abs(correlate_full(trace1, trace2))
        total = torch.sum(corr)
        if total > 0:
            corr = corr / total
        return corr

    def _stack(self, station, xx, yy, zz):
        """Correlation sum on same-shape coordinate tensors: for each pair the
        maximum over the nine ray-type pairs of the gathered correlation,
        normalized and weighted by the pair's correlation SNR."""
        corr_sum = torch.zeros_like(xx)
        for pair in self._pairs:
            ch1 = station.get_channel(pair[0])
            ch2 = station.get_channel(pair[1])
            if (np.max(np.abs(np.asarray(ch1.get_trace()))) == 0
                    or np.max(np.abs(np.asarray(ch2.get_trace()))) == 0):
                continue
            corr = self._pair_correlation(ch1, ch2)
            pos_corr = corr[corr > 0]
            corr_snr = torch.max(corr) / torch.mean(pos_corr) if pos_corr.numel() else 0.0
            fs = ch1.get_sampling_rate()
            n_corr = corr.shape[0]
            pos1 = self._det.get_relative_position(self._station_id, pair[0])
            pos2 = self._det.get_relative_position(self._station_id, pair[1])
            d1 = torch.sqrt((xx - pos1[0]) ** 2 + (yy - pos1[1]) ** 2)
            d2 = torch.sqrt((xx - pos2[0]) ** 2 + (yy - pos2[1]) ** 2)
            t1 = {rt: self._travel_time(pair[0], rt, d1, zz) for rt in RAY_TYPE_INDEX}
            t2 = {rt: self._travel_time(pair[1], rt, d2, zz) for rt in RAY_TYPE_INDEX}
            best = torch.zeros_like(corr_sum)
            for rt1, rt2 in self.RAY_TYPES:
                delta_t = t1[rt1] - t2[rt2]
                idx = n_corr / 2 + torch.round(delta_t * fs)
                ok = torch.isfinite(delta_t) & (idx > 0) & (idx < n_corr)
                idx = torch.where(ok, idx, 0.0).to(torch.int64)
                best = torch.maximum(best, torch.where(ok, corr[idx], 0.0))
            best_max = torch.max(best)
            if best_max > 0:
                corr_sum = corr_sum + best / best_max * corr_snr
        return corr_sum

    @register_run()
    def run(self, event, station, det=None, max_distance=3 * units.km,
            z_width=2 * units.km, grid_spacing=20 * units.m,
            direction_guess=None, use_dnr=False):
        distances = np.arange(50 * units.m, max_distance, grid_spacing)
        if direction_guess is None:
            heights = np.arange(-z_width, 0, grid_spacing)
        else:
            heights = np.arange(-z_width, z_width, grid_spacing)
        x0, z0 = np.meshgrid(distances, heights)
        if direction_guess is None:
            x_coords, z_coords = x0, z0
        else:
            ang = direction_guess - 90 * units.deg
            x_coords = np.cos(ang) * x0 + np.sin(ang) * z0
            z_coords = -np.sin(ang) * x0 + np.cos(ang) * z0

        xx = self.tensor(x_coords)
        corr_sum = self._stack(station, xx, torch.zeros_like(xx), self.tensor(z_coords))
        k = np.unravel_index(int(torch.argmax(corr_sum)), corr_sum.shape)
        station[stnp.vertex_2D_fit] = [x_coords[k], z_coords[k]]
        self.correlation_sum = host(corr_sum)
        self.grid = (x_coords, z_coords)
        return x_coords[k], z_coords[k]


class neutrino3DVertexReconstructor(neutrino2DVertexReconstructor):
    """Full 3D vertex search (neutrino3DVertexReconstructor.py:15-999): the
    same pair/ray-type correlation stacking on a Cartesian 3D grid with a
    coarse-to-fine zoom; channels may sit on different strings."""

    def begin(self, station_id, channel_ids, detector, passband=None, template=None):
        self._setup(station_id, channel_ids, detector, passband, template)

    @register_run()
    def run(self, event, station, det=None, max_distance=3 * units.km,
            z_range=(-2.7 * units.km, -50 * units.m), coarse_steps=24,
            n_zoom=3, zoom_factor=4.0):
        lo = np.array([-max_distance, -max_distance, z_range[0]])
        hi = np.array([max_distance, max_distance, z_range[1]])
        center = 0.5 * (lo + hi)
        half = 0.5 * (hi - lo)
        for _ in range(n_zoom):
            axes = [np.linspace(center[d] - half[d], center[d] + half[d], coarse_steps)
                    for d in range(3)]
            XX, YY, ZZ = np.meshgrid(*axes, indexing="ij")
            corr = self._stack(station, self.tensor(XX), self.tensor(YY), self.tensor(ZZ))
            k = np.unravel_index(int(torch.argmax(corr)), corr.shape)
            center = np.array([XX[k], YY[k], ZZ[k]])
            half = half / zoom_factor
        station[stnp.nu_vertex] = center.copy()
        self.correlation_max = float(torch.max(corr))
        return center
