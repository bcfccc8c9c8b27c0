"""Further reconstruction modules (torch).

Counterpart of ``nuradiomc_tpu/reco/advanced.py``:

* channelTemplateCorrelation: normalized cross-correlation of channel traces
  against reference templates (modules/channelTemplateCorrelation.py);
* sphericalWaveFitter: source position from relative arrival times, a grid
  chi^2 of every grid point on the device (modules/sphericalWaveFitter.py);
* planeWaveDirectionFitter: direction from arrival-time differences via
  least squares (LOFAR-style planeWaveDirectionFitter semantics);
* cosmicRayEnergyReconstructor: CR energy from the corrected radiation
  fluence (modules/cosmicRayEnergyReconstructor.py);
* channelGalacticNoiseAdder / efieldGalacticNoiseAdder: galactic noise from
  an analytic isotropic sky (Cane 1979, or a callable / pygdsm model) on an
  equal-area pixel grid (modules/channelGalacticNoiseAdder.py:54-508);
* channelIceThermalNoiseAdder: thermal noise from the ice folded through
  the antenna response (modules/channelIceThermalNoiseAdder.py:17-263);
* channelAntennaDedispersion (modules/channelAntennaDedispersion.py:14-54).

The noise adders draw from ``np.random.Generator(np.random.Philox(seed))``
on the host in the order of the JAX package's nested loops, so that the
noise is the same draw: a pixel whose refracted angle is NaN is skipped
before any draw, and each remaining pixel's ``uniform`` calls (its phases,
then each channel's polarisation angles) are one call of their total
length, which consumes the stream exactly as the loop does. Every (pixel,
channel, bin) term is then folded on the device in one batched expression
and summed over the pixels; the VELs come from
``efield_converters.get_channel_vel`` for all pixels at once.
"""

from __future__ import annotations

import numpy as np
import torch

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.reco.base import (Module, correlate_full, host, register_run,
                                           spectrum_tensor, stack_spectra, trace_tensor)
from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils import geometry, units
from nuradiomc_tpu_torch.utils.constants import Z_0, boltzmann, speed_of_light

chp = par.channelParameters
stnp = par.stationParameters
efp = par.electricFieldParameters


class channelTemplateCorrelation(Module):
    def __init__(self, template_provider=None, device=device_util.DEFAULT):
        super().__init__(device)
        self._templates = {}

    def begin(self, templates: dict):
        """templates: channel_id (or 'default') -> 1d trace."""
        self._templates = dict(templates)

    @register_run()
    def run(self, evt, station, det=None, cosmic_ray=True):
        type_str = "cr" if cosmic_ray else "nu"
        xcorr_param = chp.cr_xcorrelations if cosmic_ray else chp.nu_xcorrelations
        for channel in station.iter_channels():
            tpl = self._templates.get(channel.get_id(),
                                      self._templates.get("default"))
            if tpl is None:
                continue
            trace = trace_tensor(channel, self.device)
            tpl = self.tensor(np.asarray(tpl, dtype=float))
            a = trace - trace.mean()
            b = tpl - tpl.mean()
            denom = float(trace.std(correction=0) * tpl.std(correction=0)) * len(tpl)
            xcorr = torch.abs(correlate_full(a, b) / max(denom, 1e-300))
            imax = int(torch.argmax(xcorr))
            # full-mode lag: template start aligned at sample imax-(len(tpl)-1)
            lag = (imax - (len(tpl) - 1)) / channel.get_sampling_rate()
            channel[xcorr_param] = {
                f"{type_str}_max_xcorr": float(xcorr[imax]),
                f"{type_str}_xcorr_time": imax,
                # time of the template arrival within the trace, as consumed
                # by templateDirectionFitter (templateDirectionFitter.py:60)
                f"{type_str}_ref_xcorr_time": float(lag),
            }


class sphericalWaveFitter(Module):
    """Source-position fit from signal arrival times (grid chi^2, every
    candidate of a zoom level at once)."""

    def begin(self, channel_ids=None):
        self._channel_ids = channel_ids

    @register_run()
    def run(self, evt, station, det, start_pulser_position=None, n_index=1.75,
            debug=False):
        cids = self._channel_ids or station.get_channel_ids()
        positions = self.tensor(np.array([det.get_relative_position(station.get_id(), c)
                                          for c in cids]))
        times = self.tensor(np.array([station.get_channel(c)[chp.signal_time]
                                      for c in cids]))

        center = np.asarray(start_pulser_position, dtype=float) \
            if start_pulser_position is not None else np.zeros(3)

        best = None
        for half, n_pts in ((200.0, 21), (20.0, 21), (2.0, 21)):
            xs = np.linspace(center[0] - half, center[0] + half, n_pts)
            ys = np.linspace(center[1] - half, center[1] + half, n_pts)
            zs = np.linspace(center[2] - half, center[2] + half, n_pts)
            XX, YY, ZZ = np.meshgrid(xs, ys, zs, indexing="ij")
            pts_np = np.stack([XX, YY, ZZ], axis=-1).reshape(-1, 3)
            diff = self.tensor(pts_np)[:, None, :] - positions[None, :, :]
            t_pred = torch.sqrt((diff ** 2).sum(-1)) * n_index / speed_of_light
            # chi2 of relative times (remove the mean offset per candidate)
            resid = t_pred - times[None, :]
            resid = resid - resid.mean(1, keepdim=True)
            chi2 = torch.sum(resid ** 2, 1)
            k = int(torch.argmin(chi2))
            center = pts_np[k]
            best = float(chi2[k])
        station[stnp.vertex_2D_fit] = center
        return center, best


class planeWaveDirectionFitter(Module):
    """(zenith, azimuth) least squares from arrival-time differences."""

    @register_run()
    def run(self, evt, station, det, channel_ids=None, n_index=1.0):
        cids = channel_ids or station.get_channel_ids()
        positions = self.tensor(np.array([det.get_relative_position(station.get_id(), c)
                                          for c in cids]))
        times = self.tensor(np.array([station.get_channel(c)[chp.signal_time]
                                      for c in cids]))
        # t_i = t0 - n/c (r_i . u): linear in the direction vector u
        A = torch.cat([-n_index / speed_of_light * positions,
                       torch.ones((len(cids), 1), dtype=positions.dtype, device=self.device)], 1)
        u = host(torch.linalg.lstsq(A, times[:, None]).solution[:3, 0])
        norm = np.linalg.norm(u)
        if norm > 0:
            u = u / norm
        zenith = np.arccos(np.clip(u[2], -1, 1))
        azimuth = np.mod(np.arctan2(u[1], u[0]), 2 * np.pi)
        station[stnp.zenith] = zenith
        station[stnp.azimuth] = azimuth


# copied from nuradiomc_tpu/reco/advanced.py:128-147
# geomagnetic field vectors in Gauss, [East, North, Up] (IGRF values as
# bundled by the public radiotools.helper.get_magnetic_field_vector; the
# reference uses them through radiotools)
MAGNETIC_FIELD_VECTORS = {
    "auger": np.array([0.00871198, 0.19693423, 0.1413841]),
    "mooresbay": np.array([0.058457, -0.09042, 0.61439]),
    "summit": np.array([-0.037467, 0.075575, -0.539887]),
    "southpole": np.array([-0.14390398, 0.08590658, 0.52081228]),
    "lofar": np.array([0.004675, 0.186270, -0.456412]),
}


def get_angle_to_magnetic_field_vector(zenith, azimuth, site):
    """Angle between the shower propagation direction and the geomagnetic
    field (radiotools.helper.get_angle_to_magnetic_field_vector)."""
    v = -np.array([np.sin(zenith) * np.cos(azimuth),
                   np.sin(zenith) * np.sin(azimuth), np.cos(zenith)])
    B = MAGNETIC_FIELD_VECTORS[site]
    return np.arccos(np.clip(np.dot(v, B) / np.linalg.norm(B), -1, 1))


class cosmicRayEnergyReconstructor(Module):
    """CR energy from the unfolded E-field fluence
    (cosmicRayEnergyReconstructor.py:26-168, algorithm of
    JCAP 10 (2019) 075): fluence in the (vxB, vxvxB) shower plane with the
    vxB component corrected by 1/sin(alpha), scaled by the geometric
    distance to an Xmax of 750 g/cm^2 and the site/zenith parametrization,
    with separate coefficients inside/outside the Cherenkov ring (chosen by
    the fitted spectrum quadratic term vs slope). The rotations and the
    fluence run on the module's device.

    Requires: 80-300 MHz 10th-order Butterworth filtering, a reconstructed
    direction (stationParameters.zenith/azimuth) and an analytic-efield fit
    (electricFieldParameters.cr_spectrum_slope / cr_spectrum_quadratic_term),
    as in the reference chain.
    """

    # coefficients from cosmicRayEnergyReconstructor.py:41-65 (exact)
    PARAMETRIZATIONS = {
        "mooresbay": {
            "scale": np.array([(442.46, -281.75, 324.96), (394.08, -308.36, 436.30)]),
            "falloff": np.array([(-.1584, -.07943), (.8070, -1.4098)]),
        },
        "southpole": {
            "scale": np.array([(976.30, -1213.43, 626.98), (643.39, -667.08, 478.06)]),
            "falloff": np.array([(-.2273, .05627), (1.3372, -2.1653)]),
        },
        "auger": {
            "scale": np.array([(229.96, -123.75, 110.51), (214.46, -111.01, 119.18)]),
            "falloff": np.array([(-.1445, -.09820), (.5936, -1.1763)]),
        },
        "summit": {
            "scale": np.array([[404.5, -131.56, 11.7], [428.97, -92.11, 5.94]]),
            "falloff": np.array([[-0.3391, 0.1738], [0.9543, -1.6967]]),
        },
    }
    ELEVATIONS = {"mooresbay": 30., "southpole": 2800., "auger": 1560.,
                  "summit": 3216.}

    def begin(self, site=None):
        if site is not None and site not in self.PARAMETRIZATIONS:
            raise ValueError(f"unsupported site {site}; choose one of "
                             f"{list(self.PARAMETRIZATIONS)}")
        self._site = site
        from nuradiomc_tpu_torch.models.atmosphere import Atmosphere
        self._atmosphere = Atmosphere()

    @register_run()
    def run(self, evt, station, det=None, electric_field=None):
        from nuradiomc_tpu_torch.reco.rit import shower_frame

        zenith = station[stnp.zenith]
        azimuth = station[stnp.azimuth]
        site = self._site
        if site is None:
            site = det.get_site(station.get_id())
        parametrization = self.PARAMETRIZATIONS[site]
        elevation = self.ELEVATIONS[site]

        if electric_field is None:
            efields = station.get_electric_fields()
            if not efields:
                return None
            electric_field = efields[-1]

        spectrum_slope = electric_field[efp.cr_spectrum_slope]
        alpha = get_angle_to_magnetic_field_vector(zenith, azimuth, site)

        # onsky (eR,eTheta,ePhi) -> ground -> (vxB, vxvxB) shower plane
        trace_onsky = trace_tensor(electric_field, self.device)
        basis = geometry.onsky_basis(self.tensor(zenith), self.tensor(azimuth))
        trace_ground = basis.T @ trace_onsky
        frame = self.tensor(np.array(shower_frame(zenith, azimuth,
                                                  MAGNETIC_FIELD_VECTORS[site])))
        trace_vxB = frame @ trace_ground
        trace_vxB[0] /= np.sin(alpha)

        # energy fluence per component: eps0 c sum(E^2) dt
        # (trace_utilities.get_electric_field_energy_fluence)
        dt = 1.0 / electric_field.get_sampling_rate()
        eps0_c = 1.0 / Z_0  # eps0 * c = 1/Z0
        fluence = host(eps0_c * torch.sum(trace_vxB ** 2, 1) * dt)
        energy_fluence = np.abs(fluence[0]) + np.abs(fluence[1])

        xmax_distance = self._atmosphere.get_distance_xmax_geometric(
            zenith, 750.0, elevation)
        xmax_distance = np.abs(xmax_distance)

        quadratic = electric_field[efp.cr_spectrum_quadratic_term]
        branch = 0 if quadratic <= spectrum_slope * 0.1 else 1
        s = parametrization["scale"][branch]
        f = parametrization["falloff"][branch]
        scale = s[0] * zenith ** 2 + s[1] * zenith + s[2]
        falloff = f[0] * zenith + f[1]
        rec_energy = 1e18 * np.sqrt(energy_fluence) * (xmax_distance / units.km) \
            / (scale * np.exp(falloff * np.abs(spectrum_slope) ** 0.8))
        station[stnp.cr_energy_em] = rec_energy
        return rec_energy


# copied from nuradiomc_tpu/reco/advanced.py:267-318
def cane_galactic_temperature(freqs):
    """Isotropic galactic brightness temperature (Cane 1979 parametrization),
    valid ~10 MHz - 1 GHz."""
    f_MHz = np.maximum(np.asarray(freqs) / units.MHz, 1.0)
    # I_g = 2.48e-20, I_eg = 1.06e-20 W m^-2 Hz^-1 sr^-1; tau = 5 (f/MHz)^-2.1
    tau = 5.0 * (f_MHz / 1.0) ** -2.1
    i_nu = (2.48e-20 * f_MHz ** -0.52 * (1 - np.exp(-tau)) / tau
            + 1.06e-20 * f_MHz ** -0.80 * np.exp(-tau))
    # Rayleigh-Jeans: T = I c^2 / (2 k f^2)   (SI)
    c_si = 2.99792458e8
    kb_si = 1.380649e-23
    f_si = f_MHz * 1e6
    return i_nu * c_si ** 2 / (2 * kb_si * f_si ** 2)


def fibonacci_sky(n_pixels):
    """Equal-area full-sky pixelization: (lon, lat) arrays in radians.

    Replaces healpy's pixel grid (same equal-solid-angle property; solid
    angle per pixel = 4 pi / n_pixels)."""
    i = np.arange(n_pixels) + 0.5
    lat = np.arcsin(1.0 - 2.0 * i / n_pixels)
    lon = np.mod(i * np.pi * (3.0 - np.sqrt(5.0)), 2 * np.pi)
    return lon, lat


def galactic_to_equatorial(l, b):
    """Galactic (l, b) -> equatorial J2000 (ra, dec), radians (standard
    rotation; NGP at ra 192.85948 deg, dec 27.12825 deg, l_NCP 122.93192)."""
    ra_gp = np.deg2rad(192.85948)
    dec_gp = np.deg2rad(27.12825)
    l_cp = np.deg2rad(122.93192)
    sin_dec = (np.sin(dec_gp) * np.sin(b)
               + np.cos(dec_gp) * np.cos(b) * np.cos(l_cp - l))
    dec = np.arcsin(np.clip(sin_dec, -1, 1))
    y = np.cos(b) * np.sin(l_cp - l)
    x = np.cos(dec_gp) * np.sin(b) - np.sin(dec_gp) * np.cos(b) * np.cos(l_cp - l)
    ra = np.mod(np.arctan2(y, x) + ra_gp, 2 * np.pi)
    return ra, dec


def equatorial_to_horizontal(ra, dec, lst_hours, lat_deg):
    """(ra, dec) -> (zenith, NRR azimuth East=0 ccw), radians."""
    lat = np.deg2rad(lat_deg)
    H = np.deg2rad(lst_hours * 15.0) - ra
    sin_alt = np.sin(lat) * np.sin(dec) + np.cos(lat) * np.cos(dec) * np.cos(H)
    alt = np.arcsin(np.clip(sin_alt, -1, 1))
    # astronomical azimuth from North, eastward
    y = -np.cos(dec) * np.sin(H)
    x = (np.sin(dec) - sin_alt * np.sin(lat)) / np.maximum(np.cos(lat), 1e-12)
    A = np.arctan2(y, x)
    zenith = np.pi / 2 - alt
    azimuth = np.mod(np.pi / 2 - A, 2 * np.pi)   # NRR convention: East=0, ccw
    return zenith, azimuth


def get_electric_field_from_temperature(frequencies: torch.Tensor, noise_temperature,
                                        solid_angle) -> torch.Tensor:
    """Rayleigh-Jeans E-field amplitude per frequency bin
    (utilities/signal_processing.py:493-533): ``frequencies`` [F] (the bin
    width from its bins 1 and 2), the temperature and solid angle
    broadcasting against it."""
    d_f = frequencies[2] - frequencies[1]
    radiance = 2.0 * boltzmann * frequencies ** 2 * noise_temperature / speed_of_light ** 2
    radiance = torch.nan_to_num(radiance) * d_f * solid_angle
    return torch.sqrt(radiance * Z_0) / d_f


def _sky_directions(adder, det, station):
    """Horizontal (zenith, azimuth) of the adder's pixels at the station's
    time and site, and which are above the horizon (advanced.py:386-396)."""
    from nuradiomc_tpu_torch.reco.lofar import local_apparent_sidereal_time

    lat, lon = det.get_site_coordinates(station.get_id())
    t_station = station.get_station_time()
    if hasattr(t_station, "timestamp"):
        t_station = t_station.timestamp()
    lst = local_apparent_sidereal_time(float(t_station or 0.0), lon)
    ra, dec = galactic_to_equatorial(adder._gal_l, adder._gal_b)
    zenith, azimuth = equatorial_to_horizontal(ra, dec, lst, lat)
    return zenith, azimuth, zenith < np.pi / 2


class channelGalacticNoiseAdder(Module):
    """Galactic noise by folding a directional sky-temperature model with
    the antenna response per sky pixel (channelGalacticNoiseAdder.py:54-408).

    The pixelization is an equal-area Fibonacci grid, the galactic ->
    horizontal chain is closed-form (J2000 rotation + IAU sidereal time). The
    sky model is pluggable:

    * ``None`` (default): isotropic Cane (1979) temperature — works offline.
    * a callable ``T(freq, l, b)`` in internal units/radians.
    * a pygdsm model name ('gsm2008', 'gsm2016', 'lfss', 'haslam', 'lfmap')
      when the optional pygdsm package is installed.
    """

    # copied from nuradiomc_tpu/reco/advanced.py:338-386
    def begin(self, skymodel=None, n_pixels=192, freq_range=None, seed=None,
              antenna_replacements=None, scaling=1.0, n_side=None,
              n_ice=1.35, n_air=1.000293):
        if n_side is not None:            # healpy-style API parity
            n_pixels = 12 * int(n_side) ** 2
        self._rng = np.random.Generator(np.random.Philox(seed))
        self._n_pixels = int(n_pixels)
        self._scaling = scaling
        self._reps = antenna_replacements or {}
        self._n_ice, self._n_air = n_ice, n_air
        if freq_range is None:
            freq_range = np.array([10, 1000]) * units.MHz
        self._interp_freqs = np.logspace(*np.log10(np.asarray(freq_range)), 15)

        lon, lat = fibonacci_sky(self._n_pixels)
        self._gal_l, self._gal_b = lon, lat
        self._solid_angle = 4 * np.pi / self._n_pixels

        if skymodel is None:
            def model(freq, l, b):
                return cane_galactic_temperature(freq) * units.kelvin
        elif callable(skymodel):
            model = skymodel
        else:
            import pygdsm  # noqa: F401 — optional dependency

            name = str(skymodel).lower()
            gsm = {"gsm2008": pygdsm.GlobalSkyModel,
                   "gsm2016": pygdsm.GlobalSkyModel16,
                   "lfss": pygdsm.LowFrequencySkyModel,
                   "haslam": pygdsm.HaslamSkyModel,
                   "lfmap": pygdsm.LFmap}[name](freq_unit="MHz")
            import healpy

            def model(freq, l, b):
                sky = gsm.generate(freq / units.MHz)
                nside = healpy.npix2nside(len(sky))
                return sky[healpy.ang2pix(nside, np.pi / 2 - b, l)]

        # log10(T) at the interpolation frequencies per pixel
        self._log_temps = np.array([
            np.log10(np.broadcast_to(
                np.maximum(model(f, self._gal_l, self._gal_b), 1e-30),
                (self._n_pixels,)))
            for f in self._interp_freqs])                    # [n_interp, P]

    def _pixels(self, det, station, ff_band):
        """The pixels that add noise, in the JAX loop's order: (indices,
        zenith, azimuth, refracted zenith, t_p, t_s, the [P, F_band]
        amplitudes) on the device."""
        zenith, azimuth, up = _sky_directions(self, det, station)
        zen = self.tensor(zenith)
        fr = geometry.fresnel_angle(zen, n_2=self._n_ice, n_1=self._n_air)
        pix = np.nonzero(up & ~np.isnan(host(fr)))[0]
        sel = torch.as_tensor(pix, device=self.device)
        zen = zen[sel]
        logf = np.log10(np.maximum(ff_band, self._interp_freqs[0]))
        logfi = np.log10(self._interp_freqs)
        temps = np.array([10 ** np.interp(logf, logfi, self._log_temps[:, p]) for p in pix])
        amp = get_electric_field_from_temperature(
            self.tensor(ff_band), self.tensor(temps.reshape(len(pix), -1)),
            self._solid_angle)
        return (pix, zen, self.tensor(azimuth)[sel], fr[sel],
                geometry.fresnel_t_p(zen, n_2=self._n_ice, n_1=self._n_air),
                geometry.fresnel_t_s(zen, n_2=self._n_ice, n_1=self._n_air), amp)

    def _draws(self, n_pixels, n_targets, n_band):
        """[P, 1 + n_targets, n_band] uniform(0, 2 pi) draws: per pixel its
        phases, then one polarisation angle set per target, as the JAX
        package's loops draw them."""
        u = np.array([self._rng.uniform(0, 2 * np.pi, n_band * (1 + n_targets))
                      for _ in range(n_pixels)])
        return self.tensor(u.reshape(n_pixels, 1 + n_targets, n_band))

    def _arrival(self, positions, zen, azi, fr, t_p, t_s, f_band):
        """Per (target, pixel): the zenith seen at the target (refracted for
        targets below the surface), the Fresnel factors and the plane-wave
        delay phase [T, P, F_band] wrt the station center."""
        in_ice = torch.as_tensor(np.asarray(positions)[:, 2] < 0, device=self.device)[:, None]
        zen_c = torch.where(in_ice, fr[None, :], zen[None, :])
        one = torch.ones_like(t_p)
        tt = torch.where(in_ice, t_p[None, :], one)
        tp = torch.where(in_ice, t_s[None, :], one)
        n_med = torch.where(in_ice, self.tensor(self._n_ice), self.tensor(self._n_air))
        axis = torch.stack([torch.sin(zen_c) * torch.cos(azi), torch.sin(zen_c) * torch.sin(azi),
                            torch.cos(zen_c)], -1)
        pos = self.tensor(np.asarray(positions, dtype=float))
        dt = -(n_med / speed_of_light) * (axis * pos[:, None, :]).sum(-1)
        delay = torch.exp(-2j * np.pi * f_band * dt[..., None])
        return zen_c, tt, tp, delay

    @register_run()
    def run(self, evt, station, det, passband=None, excluded_channels=None):
        from nuradiomc_tpu_torch.reco.efield_converters import get_channel_vel

        cids = [c for c in station.get_channel_ids()
                if not excluded_channels or c not in excluded_channels]
        ch0 = station.get_channel(cids[0])
        ff = np.asarray(ch0.get_frequencies())
        fs = ch0.get_sampling_rate()
        if passband is None:
            passband = [10 * units.MHz, 1000 * units.MHz]
        band = (ff > passband[0]) & (ff < passband[1])
        n_band = int(band.sum())
        band_t = torch.as_tensor(band, device=self.device)

        pix, zen, azi, fr, t_p, t_s, amp = self._pixels(det, station, ff[band])
        positions = [det.get_relative_position(station.get_id(), c) for c in cids]
        u = self._draws(len(pix), len(cids), n_band)
        f_band = self.tensor(ff[band])
        zen_c, tt, tp, delay = self._arrival(positions, zen, azi, fr, t_p, t_s, f_band)
        vt, vp = zip(*(get_channel_vel(det, station.get_id(), c, ff, zen_c[i], azi,
                                       self._reps, device=self.device)
                       for i, c in enumerate(cids)))
        vt = torch.stack(vt)[..., band_t]                          # [C, P, F_band]
        vp = torch.stack(vp)[..., band_t]
        pol = u[:, 1:].transpose(0, 1)                              # [C, P, F_band]
        phases = torch.exp(1j * u[:, 0])
        terms = self._scaling * amp * phases * delay * (
            vt * torch.cos(pol) * tt[..., None] + vp * torch.sin(pol) * tp[..., None])
        spectra = stack_spectra([station.get_channel(c) for c in cids], self.device)
        spectra[:, band_t] += terms.sum(1)
        for c, spec in zip(cids, host(spectra)):
            station.get_channel(c).set_frequency_spectrum(spec, fs)


class efieldGalacticNoiseAdder(channelGalacticNoiseAdder):
    """Galactic noise added to the station's ``ElectricField`` objects
    instead of channel voltages (modules/efieldGalacticNoiseAdder.py:11-167):
    per pixel the on-sky (eTheta, ePhi) noise spectrum with a random
    polarization and plane-wave delay is summed onto every efield."""

    @register_run()
    def run(self, evt, station, det, passband=None):
        efields = station.get_electric_fields()
        if not efields:
            return
        ff = np.asarray(efields[0].get_frequencies())
        for ef in efields[1:]:
            if not np.allclose(ff, ef.get_frequencies(), rtol=0,
                               atol=0.1 * units.MHz):
                raise ValueError("all efields must share one frequency grid")
        fs = efields[0].get_sampling_rate()
        if passband is None:
            passband = [10 * units.MHz, 1000 * units.MHz]
        band = (ff > passband[0]) & (ff < passband[1])
        n_band = int(band.sum())
        band_t = torch.as_tensor(band, device=self.device)

        pix, zen, azi, fr, t_p, t_s, amp = self._pixels(det, station, ff[band])
        positions = [np.asarray(ef.get_position() if ef.get_position() is not None
                                else (0.0, 0.0, 0.0)) for ef in efields]
        u = self._draws(len(pix), len(efields), n_band)
        _, tt, tp, delay = self._arrival(positions, zen, azi, fr, t_p, t_s,
                                         self.tensor(ff[band]))
        pol = u[:, 1:].transpose(0, 1)                              # [E, P, F_band]
        common = self._scaling * amp * torch.exp(1j * u[:, 0]) * delay
        spectra = stack_spectra(efields, self.device)
        spectra[:, 1][:, band_t] += (common * torch.cos(pol) * tt[..., None]).sum(1)
        spectra[:, 2][:, band_t] += (common * torch.sin(pol) * tp[..., None]).sum(1)
        for ef, spec in zip(efields, host(spectra)):
            ef.set_frequency_spectrum(spec, fs)


class channelIceThermalNoiseAdder(Module):
    """Thermal noise from the ice, folded through the antenna response per
    sky pixel (modules/channelIceThermalNoiseAdder.py:17-263).

    The effective-temperature input is a dict {antenna_depth: (thetas,
    T_eff(theta))} — the content of the reference's JSON files produced by
    NuRadioMC/examples/simulate_effective_ice_temperature. All (phi, theta)
    pixels of one channel are drawn on the host in the JAX loop's order and
    folded in one batched expression on the device.
    """

    def begin(self, eff_temperatures, nr_phi_bins=64,
              channel_depth_matching_error=10.0, seed=None,
              antenna_replacements=None):
        self._temps = {float(k): (np.asarray(v[0], float),
                                  np.asarray(v[1], float))
                       for k, v in eff_temperatures.items()}
        self._phis = np.linspace(0, 2 * np.pi, nr_phi_bins)
        self._depth_tol = channel_depth_matching_error
        self._rng = np.random.Generator(np.random.Philox(seed))
        self._reps = antenna_replacements or {}

    @register_run()
    def run(self, event, station, detector, passband=None):
        from nuradiomc_tpu_torch.reco.efield_converters import get_channel_vel

        if passband is None:
            passband = [10 * units.MHz, 1600 * units.MHz]
        for channel in station.iter_channels():
            ff = np.asarray(channel.get_frequencies())
            band = (ff > passband[0]) & (ff < passband[1])
            n_band = int(band.sum())
            depth = detector.get_relative_position(
                station.get_id(), channel.get_id())[2]
            matches = [k for k in self._temps
                       if abs(k - depth) <= self._depth_tol]
            if len(matches) != 1:
                raise KeyError(
                    f"{len(matches)} effective-temperature entries match "
                    f"depth {depth} within {self._depth_tol}")
            thetas, t_eff = self._temps[matches[0]]
            d_thetas = np.diff(thetas)
            d_phis = np.diff(self._phis)
            n_phi, n_th = len(d_phis), len(d_thetas)

            # the loops' draws: per (phi, theta) its phases, then its angles
            u = self.tensor(self._rng.uniform(0, 2 * np.pi, n_phi * n_th * 2 * n_band)
                            .reshape(n_phi, n_th, 2, n_band))
            omega = np.abs(np.sin(thetas[:-1])[None, :] * np.sin(d_thetas / 2)[None, :]
                           * 2 * d_phis[:, None])
            f_band = self.tensor(ff[band])
            amp = get_electric_field_from_temperature(
                f_band, self.tensor(t_eff[:-1])[None, :, None],
                self.tensor(omega)[..., None])                      # [phi, theta, F]
            zen = self.tensor(np.tile(thetas[:-1], (n_phi, 1)))
            azi = self.tensor(np.tile(self._phis[:-1][:, None], (1, n_th)))
            vt, vp = get_channel_vel(detector, station.get_id(), channel.get_id(), ff,
                                     zen, azi, self._reps, device=self.device)
            band_t = torch.as_tensor(band, device=self.device)
            pol = u[:, :, 1]
            add = ((vt[..., band_t] * torch.cos(pol) + vp[..., band_t] * torch.sin(pol))
                   * amp * torch.exp(1j * u[:, :, 0])).sum((0, 1))
            spec = spectrum_tensor(channel, self.device)
            spec[band_t] += add
            channel.set_frequency_spectrum(host(spec), channel.get_sampling_rate())


class channelAntennaDedispersion(Module):
    """Remove the antenna phase response (group-delay dispersion) from the
    channel traces (modules/channelAntennaDedispersion.py:14-54): divide by
    exp(i*angle(VEL)) evaluated at the antenna's sensitive direction."""

    def begin(self, antenna_replacements=None):
        self._reps = antenna_replacements or {}

    def _response(self, det, station_id, channel_id, ff):
        from nuradiomc_tpu_torch.reco.efield_converters import get_channel_vel
        name = det.get_antenna_model(station_id, channel_id)
        name = self._reps.get(name, name)
        zen_ori, az_ori, _, _ = det.get_antenna_orientation(station_id,
                                                            channel_id)
        if "LPDA" in name:
            zen, az = zen_ori, az_ori   # boresight
        else:   # dipole-like: sensitive perpendicular to the orientation
            zen, az = np.pi / 2 + zen_ori, 0.0
        vt, vp = get_channel_vel(det, station_id, channel_id, ff, zen, az,
                                 self._reps, device=self.device)
        vel = vt if torch.sum(torch.abs(vt)) > torch.sum(torch.abs(vp)) else vp
        return torch.exp(1j * torch.angle(vel))

    @register_run()
    def run(self, evt, station, det, debug=False):
        for channel in station.iter_channels():
            ff = np.asarray(channel.get_frequencies())
            resp = self._response(det, station.get_id(), channel.get_id(), ff)
            channel.set_frequency_spectrum(
                host(spectrum_tensor(channel, self.device) / resp),
                channel.get_sampling_rate())

