"""Direction reconstruction modules (torch).

Counterpart of ``nuradiomc_tpu/reco/direction.py``:

* correlationDirectionFitter: (zenith, azimuth) maximizing the
  cross-correlation of two orthogonal channel pairs at plane-wave delays
  (modules/correlationDirectionFitter.py:33-260): the two correlations and
  every grid point of a stage are evaluated on the device;
* beamforming_score / beamFormingDirectionFitter: the cc-beam score
  (modules/beamFormingDirectionFitter.py:84-231), every direction of a
  refinement stage in one batched tensor program;
* templateDirectionFitter: the plane-wave fit to template-correlation times
  (modules/templateDirectionFitter.py:13-118), a Nelder-Mead polish on the
  host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.ops import antenna as antenna_ops
from nuradiomc_tpu_torch.ops import filters
from nuradiomc_tpu_torch.ops import trace as trace_ops
from nuradiomc_tpu_torch.reco.base import (Module, correlate_full, register_run,
                                           rows_per_chunk, trace_tensor)
from nuradiomc_tpu_torch.utils import geometry, units
from nuradiomc_tpu_torch.utils.constants import speed_of_light

stnp = par.stationParameters


# copied from nuradiomc_tpu/reco/direction.py:25-33
def get_time_delay_from_direction(zenith, azimuth, p, n=None):
    """Arrival-time delay of a plane wave at position p
    (utilities/geometryUtilities.get_time_delay_from_direction)."""
    refraction = 1.0 if n is None else n
    v = np.array([np.sin(zenith) * np.cos(azimuth),
                  np.sin(zenith) * np.sin(azimuth),
                  np.cos(zenith)])
    return -refraction / speed_of_light * np.dot(v, p)


def _dot3(v, p):
    """v (..., 3) . p (3,) summed in index order."""
    return v[..., 0] * float(p[0]) + v[..., 1] * float(p[1]) + v[..., 2] * float(p[2])


class correlationDirectionFitter(Module):

    def begin(self, debug=False, log_level=None):
        pass

    @register_run()
    def run(self, evt, station, det, n_index=None, ZenLim=None, AziLim=None,
            channel_pairs=((0, 2), (1, 3)), use_envelope=False):
        if ZenLim is None:
            ZenLim = [0, 90 * units.deg]
        if AziLim is None:
            AziLim = [0, 360 * units.deg]
        station_id = station.get_id()
        positions = [[det.get_relative_position(station_id, c) for c in pair]
                     for pair in channel_pairs]
        fs = station.get_channel(channel_pairs[0][0]).get_sampling_rate()
        tstarts = [[station.get_channel(c).get_trace_start_time() for c in pair]
                   for pair in channel_pairs]

        def get_trace(cid):
            tr = trace_tensor(station.get_channel(cid), self.device)
            return trace_ops.hilbert_envelope(tr) if use_envelope else tr

        corrs = [correlate_full(get_trace(a), get_trace(b)) for a, b in channel_pairs]
        weights = [torch.sum(torch.abs(c)) for c in corrs]
        n_ref = 1.0 if n_index is None else n_index

        def neg_ll(zen, az):
            """Over same-shape zen/az grids (ll_regular_station)."""
            v = geometry.spherical_to_cartesian(zen, az)
            ll = 0.0
            for ipair, (corr, w) in enumerate(zip(corrs, weights)):
                p0, p1 = positions[ipair]
                t0 = -n_ref / speed_of_light * _dot3(v, p0)
                t1 = -n_ref / speed_of_light * _dot3(v, p1)
                d = ((t1 - t0) - (tstarts[ipair][1] - tstarts[ipair][0])) * fs
                pos = torch.clamp((corr.shape[0] // 2 - d).to(torch.int64), 0,
                                  corr.shape[0] - 1)
                ll = ll - corr[pos] / w
            return ll

        # stage 1: dense grid; stage 2: refine around the best point
        zen_g = np.arange(ZenLim[0], ZenLim[1] + 1e-9, 1.0 * units.deg)
        az_g = np.arange(AziLim[0], AziLim[1] + 1e-9, 1.0 * units.deg)
        ZZ, AA = np.meshgrid(zen_g, az_g, indexing="ij")
        i, j = np.unravel_index(int(torch.argmin(neg_ll(self.tensor(ZZ),
                                                        self.tensor(AA)))), ZZ.shape)
        zen0, az0 = ZZ[i, j], AA[i, j]

        dz = 1.2 * units.deg
        zen_f = np.linspace(max(zen0 - dz, ZenLim[0]), min(zen0 + dz, ZenLim[1]), 121)
        az_f = np.linspace(az0 - dz, az0 + dz, 121)
        ZZ, AA = np.meshgrid(zen_f, az_f, indexing="ij")
        i, j = np.unravel_index(int(torch.argmin(neg_ll(self.tensor(ZZ),
                                                        self.tensor(AA)))), ZZ.shape)
        station[stnp.zenith] = ZZ[i, j]
        station[stnp.azimuth] = np.mod(AA[i, j], 2 * np.pi)


def beamforming_score(zen, az, V, band, positions, t_starts, rots, templates,
                      kinds, pol, n_index, fs):
    """cc-beam score of a batch of candidate directions, one tensor program
    on the inputs' device (beamformingDirectionFitter.ll_regular_station,
    beamFormingDirectionFitter.py:138-180): per channel, unfold the voltage
    spectrum to the chosen E-field polarization for each direction, bandpass,
    time-align with plane-wave delays, form the pair-product cc-beam,
    sign*sqrt, smooth, and take the maximum.

    zen, az (D,); V (C, F) complex voltage spectra; band (F,) passband
    response; positions (C, 3); t_starts (C,); rots (C, 3, 3); templates
    (C, 3, F); kinds (C,) host ints; pol 0 (eTheta) or 1 (ePhi). Returns (D,).
    """
    C, F = V.shape
    n_t = 2 * (F - 1)
    freqs = torch.fft.rfftfreq(n_t, 1.0 / fs, dtype=torch.float64, device=V.device)
    k = geometry.spherical_to_cartesian(zen, az)                      # (D, 3)
    xs = []
    for c in range(C):
        vt, vp = antenna_ops.analytic_vel(
            zen, az, rots[c], templates[c], int(kinds[c]),
            antenna_ops.lpda_sector_host(zen, az, rots[c], int(kinds[c])))
        vel = vt if pol == 0 else vp                                  # (D, F)
        absvel = torch.abs(vel)
        good = absvel > 1e-3 * absvel.max(dim=-1, keepdim=True).values
        E = torch.where(good, V[c] / torch.where(good, vel, 1.0), 0.0) * band
        # align to the plane-wave arrival: x(t + tau) <-> X(f) e^{2pi i f tau}
        delay = -n_index / speed_of_light * _dot3(k, positions[c])
        tau = delay - float(t_starts[c])
        arg = (2 * math.pi) * freqs * tau[:, None]
        xs.append(torch.fft.irfft(E * torch.complex(torch.cos(arg), torch.sin(arg)), n_t))
    x = torch.stack(xs, dim=1)                                        # (D, C, n_t)
    x = x / torch.amax(torch.abs(x), dim=(1, 2), keepdim=True)
    # all-pairs product beam: sum_{j<k} x_j x_k = ((sum x)^2 - sum x^2)/2
    s = torch.sum(x, dim=1)
    cc = (s ** 2 - torch.sum(x ** 2, dim=1)) / 2.0
    cc = cc / (C * (C - 1) / 2.0)
    cc = torch.abs(torch.sign(cc) * torch.sqrt(torch.abs(cc)))
    # moving average (reference: np.convolve(ones(2000)/2000, 'same'))
    w = min(2000, n_t)
    csum = torch.nn.functional.pad(torch.cumsum(cc, dim=-1), (1, 0))
    idx = torch.arange(n_t, device=V.device)
    lo = torch.clamp(idx - w // 2, 0, n_t)
    hi = torch.clamp(idx + (w - w // 2), 0, n_t)
    ave = (csum[:, hi] - csum[:, lo]) / w
    return torch.amax(ave, dim=-1)


class beamFormingDirectionFitter(Module):
    """Interferometric (cc-beam) direction fitter
    (modules/beamFormingDirectionFitter.py:84-231): a 3-degree first stage
    and two refinement stages, each one batched score over its directions
    (in as few chunks as the device memory allows)."""

    def begin(self, debug=False, log_level=None):
        self._debug = debug

    @register_run()
    def run(self, evt, station, det, polarization=0, n_index=1.353,
            channels=None, ZenLim=None, AziLim=None,
            passband=(120 * units.MHz, 300 * units.MHz),
            antenna_replacements=None):
        if ZenLim is None:
            ZenLim = [90 * units.deg, 180 * units.deg]
        if AziLim is None:
            AziLim = [0, 360 * units.deg]
        station_id = station.get_id()
        if channels is None:
            channels = list(det.get_channel_ids(station_id))

        reps = antenna_replacements or {}
        V, positions, t_starts, rots, templates, kinds = [], [], [], [], [], []
        fs = station.get_channel(channels[0]).get_sampling_rate()
        F = None
        for cid in channels:
            ch = station.get_channel(cid)
            spec = np.asarray(ch.get_frequency_spectrum())
            F = len(spec) if F is None else F
            V.append(spec[:F])
            positions.append(det.get_relative_position(station_id, cid))
            t_starts.append(ch.get_trace_start_time())
            model = reps.get(det.get_antenna_model(station_id, cid),
                             det.get_antenna_model(station_id, cid))
            freqs = np.fft.rfftfreq(2 * (F - 1), 1.0 / fs)
            tpl = antenna_ops.build_analytic_template(model, freqs)
            full = np.zeros((3, F), dtype=complex)
            full[:tpl.shape[0]] = tpl
            if tpl.shape[0] == 1:
                full[1:] = tpl[0]
            templates.append(full)
            rots.append(antenna_ops.antenna_rotation_matrix(
                *det.get_antenna_orientation(station_id, cid)))
            kinds.append(antenna_ops.ANALYTIC_MODELS[model][0])

        freqs = np.fft.rfftfreq(2 * (F - 1), 1.0 / fs)
        band = np.abs(filters.chain_response(freqs, [(passband, "butterabs", {"order": 10})]))
        args = (self.tensor(np.asarray(V)), self.tensor(band),
                np.asarray(positions, dtype=float), np.asarray(t_starts, dtype=float),
                self.tensor(np.asarray(rots)), self.tensor(np.asarray(templates)),
                list(kinds), polarization, n_index, fs)
        n_t = 2 * (F - 1)
        row_bytes = len(channels) * (6 * 16 * F + 6 * 8 * n_t)

        def score(zz, aa):
            zz, aa = self.tensor(zz.ravel()), self.tensor(aa.ravel())
            chunk = rows_per_chunk(row_bytes, self.device, len(zz))
            return torch.cat([beamforming_score(zz[i:i + chunk], aa[i:i + chunk], *args)
                              for i in range(0, len(zz), chunk)])

        # dense first stage (the cc-beam landscape is multimodal; the
        # reference brute-forces 1 degree), then two refinement stages
        step = 3 * units.deg
        zg = np.arange(ZenLim[0], ZenLim[1] + 1e-9, step)
        ag = np.arange(AziLim[0], AziLim[1] + 1e-9, step)
        ZZ, AA = np.meshgrid(zg, ag, indexing="ij")
        k = int(torch.argmax(score(ZZ, AA)))
        cz, ca = ZZ.ravel()[k], AA.ravel()[k]
        span_z = span_a = step * 1.5
        for n_pts in (15, 15):
            zg = np.linspace(max(cz - span_z, ZenLim[0]), min(cz + span_z, ZenLim[1]), n_pts)
            ag = np.linspace(ca - span_a, ca + span_a, n_pts)
            ZZ, AA = np.meshgrid(zg, ag, indexing="ij")
            k = int(torch.argmax(score(ZZ, AA)))
            cz, ca = ZZ.ravel()[k], AA.ravel()[k]
            span_z = (zg[1] - zg[0]) * 1.5
            span_a = (ag[1] - ag[0]) * 1.5

        station[stnp.zenith] = float(np.clip(cz, ZenLim[0], ZenLim[1]))
        station[stnp.azimuth] = float(np.mod(ca, 2 * np.pi))


# copied from nuradiomc_tpu/reco/direction.py:245-252
def get_refractive_index(depth, site="southpole"):
    """Legacy two-value ice index used by the direction fitters
    (utilities/ice.get_refractive_index:17-51): n_air for land sites, 1.3
    below the surface of in-ice sites."""
    if str(site).lower() in ("lofar", "auger", "ska"):
        return 1.000293
    return 1.3 if depth <= 0 else 1.000293


class templateDirectionFitter(Module):
    """Plane-wave (zenith, azimuth) fit from per-channel template
    cross-correlation times (modules/templateDirectionFitter.py:13-118):
    the ``{cr,nu}_ref_xcorr_time`` entries of channelTemplateCorrelation,
    the mean-subtracted plane-wave arrival-time chi2 minimized by a
    Nelder-Mead polish from the best of four azimuth starts
    (templateDirectionFitter.py:89-99), on the host."""

    @register_run()
    def run(self, evt, station, det, channels_to_use=None, cosmic_ray=False):
        from scipy import optimize as opt

        chp = par.channelParameters
        if channels_to_use is None:
            channels_to_use = [0, 1, 2, 3]
        type_str = "cr" if cosmic_ray else "nu"
        xcorrelations = chp.cr_xcorrelations if cosmic_ray else chp.nu_xcorrelations

        station_id = station.get_id()
        times, positions = [], []
        for channel_id in channels_to_use:
            channel = station.get_channel(channel_id)
            times.append(channel[xcorrelations][f"{type_str}_ref_xcorr_time"]
                         + channel.get_trace_start_time())
            positions.append(det.get_relative_position(station_id, channel_id))
        times = np.array(times)
        positions = np.array(positions)
        n_ice = get_refractive_index(-0.01, det.get_site(station_id))

        def obj_plane(params):
            zenith, azimuth = params
            if cosmic_ray:
                if zenith < 0 or zenith > 0.5 * np.pi:
                    return np.inf
            elif zenith < 0.5 * np.pi or zenith > np.pi:
                return np.inf
            v = np.array([np.sin(zenith) * np.cos(azimuth),
                          np.sin(zenith) * np.sin(azimuth),
                          np.cos(zenith)])
            c = speed_of_light if cosmic_ray else speed_of_light / n_ice
            t_expected = -(positions @ v) / c
            sigma = 1 * units.ns
            return float(np.sum(((t_expected - t_expected.mean())
                                 - (times - times.mean())) ** 2 / sigma ** 2))

        zenith_start = (45 if cosmic_ray else 135) * units.deg
        starts = np.array([0, 90, 180, 270]) * units.deg
        azimuth_start = starts[int(np.argmin([obj_plane((zenith_start, a))
                                              for a in starts]))]
        res = opt.minimize(obj_plane, x0=[zenith_start, azimuth_start],
                           method="Nelder-Mead", options={"maxiter": 1000, "disp": False})

        zen = float(res.x[0])
        az = float(np.mod(res.x[1], 2 * np.pi))
        station[stnp.zenith] = zen
        station[stnp.azimuth] = az
        if cosmic_ray:
            station[stnp.cr_zenith] = zen
            station[stnp.cr_azimuth] = az
        else:
            station[stnp.nu_zenith] = zen
            station[stnp.nu_azimuth] = az
