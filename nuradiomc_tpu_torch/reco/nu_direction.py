"""Neutrino direction + shower-energy reconstruction by forward folding (torch).

Counterpart of ``nuradiomc_tpu/reco/nu_direction.py`` (reference
neutrinoDirectionReconstructor/voltageToEfieldAnalyticConverterForNeutrinos.py
:24-512): with the vertex known, the ray geometry (launch/receive vectors,
travel times, attenuation, Fresnel coefficients, antenna responses) to every
antenna is fixed and computed once on the device; the fit parameters
(neutrino zenith and azimuth, log10 shower energy) enter through the viewing
angle, the polarization and the Askaryan amplitude. Every triple of a grid
stage is one batched tensor program (chunked where the device memory asks
for it), with a coarse-to-fine zoom.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.ops import askaryan, filters, raytrace
from nuradiomc_tpu_torch.ops import trace as trace_ops
from nuradiomc_tpu_torch.reco.base import Module, host, register_run, rows_per_chunk
from nuradiomc_tpu_torch.reco.efield_converters import get_channel_vel
from nuradiomc_tpu_torch.utils import geometry, units

stnp = par.stationParameters


class neutrinoDirectionReconstructor(Module):

    def begin(self, ice, attenuation_model="SP1", antenna_replacements=None,
              n_attenuation_steps=64):
        self._ice = ice
        self._att_model = attenuation_model
        self._reps = antenna_replacements or {}
        self._att_steps = n_attenuation_steps

    def _fixed_geometry(self, det, station_id, vertex, use_channels, ff):
        """Ray-tracing quantities that do not depend on the fit parameters
        (reference run():300-376, computed once before the minimizer), as
        tensors on the device: [A, 2] per ray slot, [A, 2, F] per frequency."""
        A = len(use_channels)
        positions = np.array([det.get_relative_position(station_id, c)
                              for c in use_channels], dtype=float)
        geom = raytrace.to_2d(self.tensor(np.broadcast_to(vertex, (A, 3)).copy()),
                              self.tensor(positions))
        sols = raytrace.find_solutions(geom.x1y, geom.x1z, geom.x2y, geom.x2z, self._ice)
        launch, receive = raytrace.launch_receive_vectors(geom, sols)
        g = [x[:, None] for x in (geom.x1y, geom.x1z, geom.x2y, geom.x2z)]
        att = raytrace.attenuation_factor(sols.c0, *g, self._ice, self.tensor(ff),
                                          self._att_model, n_steps=self._att_steps)

        n_surf = float(self._ice.index_of_refraction(torch.tensor(-1e-2 * units.m,
                                                                  dtype=torch.float64)))
        refl_zen = torch.arctan(1.0 / torch.sqrt(torch.clamp(
            sols.c0 ** 2 * n_surf ** 2 - 1.0, min=1e-12)))
        is_refl = sols.sol_type == raytrace.SOL_REFLECTED
        one = torch.ones_like(refl_zen).to(torch.complex128)
        r_t = torch.where(is_refl, geometry.fresnel_r_p(refl_zen, n_2=1.0, n_1=n_surf), one)
        r_p = torch.where(is_refl, geometry.fresnel_r_s(refl_zen, n_2=1.0, n_1=n_surf), one)

        # antenna response at the (fixed) receive directions
        zen_r, az_r = geometry.cartesian_to_spherical(receive)
        vel = [get_channel_vel(det, station_id, cid, ff, zen_r[i], az_r[i], self._reps,
                               device=self.device) for i, cid in enumerate(use_channels)]
        zen_l, az_l = geometry.cartesian_to_spherical(launch)
        return dict(launch=launch, mask=sols.mask, travel_time=sols.travel_time,
                    path_length=sols.path_length, att=att, r_t=r_t, r_p=r_p,
                    vel_t=torch.stack([v[0] for v in vel]),
                    vel_p=torch.stack([v[1] for v in vel]), zen_l=zen_l, az_l=az_l)

    @register_run()
    def run(self, evt, station, det, vertex=None, use_channels=(0, 1, 2, 3),
            shower_type="HAD", model="Alvarez2000", passband=None,
            noise_RMS=10 * units.micro * units.V, use_hilbert=False,
            zenith_range=None, azimuth_range=None, energy_range=(15.0, 19.0),
            coarse_steps=(20, 20, 16), n_zoom=2):
        """Fit (nu_zenith, nu_azimuth, log10 E_shower) to the measured traces.

        vertex: interaction vertex (e.g. from the vertex reconstructor or MC).
        zenith_range/azimuth_range default to the full sky; pass narrow
        windows (the reference's use_MC mode) for speed.
        """
        station_id = station.get_id()
        if vertex is None:
            vertex = np.asarray(station[stnp.nu_vertex])
        vertex = np.asarray(vertex, dtype=float)
        ch0 = station.get_channel(use_channels[0])
        fs = ch0.get_sampling_rate()
        n_t = min(station.get_channel(c).get_number_of_samples() for c in use_channels)
        n_t -= n_t % 2
        dt = 1.0 / fs
        ff = np.fft.rfftfreq(n_t, dt)

        fixed = self._fixed_geometry(det, station_id, vertex, use_channels, ff)
        measured = np.array([np.asarray(station.get_channel(c).get_trace())[:n_t]
                             for c in use_channels])
        cable = np.array([det.get_cable_delay(station_id, c) for c in use_channels])
        best_ch = int(np.argmax(np.max(np.abs(measured), axis=-1)))

        band = np.ones(len(ff), dtype=complex)
        if passband is not None:
            band = filters.get_filter_response(ff, passband, "butter", order=5)
        n_index = self._ice.index_of_refraction(torch.tensor(vertex[2], dtype=torch.float64,
                                                             device=self.device))
        tt = fixed["travel_time"]
        tt_rel = tt - torch.min(torch.where(fixed["mask"], tt, torch.inf))
        dT = tt_rel + self.tensor(cable - cable.min())[:, None]        # [A,2]
        arg = (-2 * math.pi) * self.tensor(ff)[None, None, :] * dT[..., None]
        phase_dt = torch.complex(torch.cos(arg), torch.sin(arg)) * self.tensor(band)
        R = torch.clamp(fixed["path_length"], min=1.0)
        measured_t = self.tensor(measured)
        meas_best_f = torch.fft.rfft(measured_t[best_ch], 2 * n_t)
        is_em = torch.tensor(shower_type.upper() == "EM", device=self.device)
        two_noise2 = torch.tensor(2 * noise_RMS ** 2, dtype=torch.float64, device=self.device)
        A = len(use_channels)

        def forward(zen_nu, az_nu, log10_E):
            """Analytic voltage traces for parameter triples (tensors of one
            shape [...]) -> [..., A, n_t]."""
            zen_nu, az_nu, log10_E = (torch.as_tensor(x, dtype=torch.float64,
                                                      device=self.device)
                                      for x in (zen_nu, az_nu, log10_E))
            batch = zen_nu.shape
            nu_dir = -geometry.spherical_to_cartesian(zen_nu, az_nu)[..., None, None, :]
            launch = fixed["launch"]                                    # [A,2,3]
            cosv = torch.sum(nu_dir * launch, dim=-1)                   # [...,A,2]
            view = torch.arccos(torch.clamp(cosv, -1.0, 1.0))
            shape = view.shape
            spec = askaryan.get_frequency_spectrum(
                (10.0 ** log10_E)[..., None, None].expand(shape), view, n_t, dt,
                is_em.expand(shape), n_index.expand(shape), R.expand(shape), model)
            launch_b = launch.expand(*batch, A, 2, 3)
            pol = torch.linalg.cross(launch_b, torch.linalg.cross(
                nu_dir.expand_as(launch_b), launch_b, dim=-1), dim=-1)
            pol = pol / torch.clamp(torch.linalg.vector_norm(pol, dim=-1, keepdim=True),
                                    min=1e-30)
            pol_onsky = geometry.ground_to_onsky(pol, fixed["zen_l"], fixed["az_l"])
            e_t = pol_onsky[..., 1:2] * spec * fixed["att"] * fixed["r_t"][..., None]
            e_p = pol_onsky[..., 2:3] * spec * fixed["att"] * fixed["r_p"][..., None]
            v_spec = (fixed["vel_t"] * e_t + fixed["vel_p"] * e_p) * phase_dt
            v_spec = torch.where(fixed["mask"][..., None], v_spec, 0.0)
            v_spec = torch.sum(v_spec, dim=-2)                          # [...,A,F]
            return torch.fft.irfft(v_spec, n=n_t, dim=-1) * fs / math.sqrt(2.0)

        ramp = torch.arange(n_t, device=self.device)

        def chi2_batch(pts):
            """chi2 of a batch of triples [P, 3] -> [P]."""
            traces = forward(pts[:, 0], pts[:, 1], pts[:, 2])           # [P,A,n_t]
            # global time offset from the best-SNR channel (reference :190-210)
            corr = torch.fft.irfft(meas_best_f * torch.conj(
                torch.fft.rfft(traces[:, best_ch], 2 * n_t)), 2 * n_t)
            toffset = torch.argmax(torch.abs(corr), dim=-1)              # circular lag
            src = torch.remainder(ramp[None, :] - toffset[:, None], n_t)
            rolled = torch.gather(traces, -1, src[:, None, :].expand(traces.shape))
            if use_hilbert:
                d = (trace_ops.hilbert_envelope(measured_t)
                     - trace_ops.hilbert_envelope(rolled))
            else:
                d = measured_t - rolled
            return torch.sum(torch.abs(d) ** 2, dim=(-2, -1)) / two_noise2

        # bytes of one triple: [A, 2, F] complex intermediates and the traces
        row_bytes = A * (2 * (n_t // 2 + 1) * 16 * 12 + n_t * 8 * 8)

        def chi2_grid(pts):
            pts = self.tensor(pts)
            chunk = rows_per_chunk(row_bytes, self.device, pts.shape[0])
            return torch.cat([chi2_batch(pts[i:i + chunk])
                              for i in range(0, pts.shape[0], chunk)])

        if zenith_range is None:
            zenith_range = (0.0, np.pi)
        if azimuth_range is None:
            azimuth_range = (0.0, 2 * np.pi)
        lo = np.array([zenith_range[0], azimuth_range[0], energy_range[0]])
        hi = np.array([zenith_range[1], azimuth_range[1], energy_range[1]])
        center, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
        nz, na, ne = coarse_steps
        self.grids = []
        for _ in range(1 + n_zoom):
            axes = [np.linspace(center[d] - half[d], center[d] + half[d], n)
                    for d, n in zip(range(3), (nz, na, ne))]
            ZZ, AA, EE = np.meshgrid(*axes, indexing="ij")
            pts = np.stack([ZZ.ravel(), AA.ravel(), EE.ravel()], axis=-1)
            chi2 = chi2_grid(pts)
            self.grids.append((pts, host(chi2)))
            k = int(torch.argmin(chi2))
            center = pts[k]
            half = np.array([axes[d][1] - axes[d][0] for d in range(3)]) * 1.5

        zen_fit, az_fit, logE_fit = center
        station[stnp.nu_zenith] = float(zen_fit)
        station[stnp.nu_azimuth] = float(np.mod(az_fit, 2 * np.pi))
        station[stnp.shower_energy] = float(10 ** logE_fit)
        nu_dir = -np.asarray(host(geometry.spherical_to_cartesian(
            torch.tensor(zen_fit), torch.tensor(az_fit))))
        cosv = np.sum(nu_dir * host(fixed["launch"]), axis=-1)
        station[stnp.viewing_angles] = np.arccos(np.clip(cosv, -1, 1))
        self.chi2_min = float(chi2[k])
        self.forward = forward
        self.chi2 = chi2_grid
        return zen_fit, float(np.mod(az_fit, 2 * np.pi)), float(logE_fit)
