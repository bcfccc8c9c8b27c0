"""Electric-field <-> voltage conversion modules (framework-object API, torch).

Counterpart of ``nuradiomc_tpu/reco/efield_converters.py``:

* efieldToVoltageConverter: forward folding of station electric fields with
  the antenna response into channel voltage traces
  (modules/efieldToVoltageConverter.py:111-345);
* voltageToEfieldConverter: unfolding E(f) from >= 2 channels by solving
  V_i(f) = sum_p VEL_i,p(f) E_p(f) in every frequency bin, one batched
  solve over the bins (modules/voltageToEfieldConverter.py:130-242);
* electricFieldSignalReconstructor and the per-efield, per-channel-group
  and per-channel variants.

The antenna responses, the sub-bin shifts, the placement on the common time
base and the per-bin solves run on the module's device; the windows and the
event data model stay on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.framework.event import Channel, ElectricField, SimChannel
from nuradiomc_tpu_torch.ops import antenna as antenna_ops
from nuradiomc_tpu_torch.ops import trace as trace_ops
from nuradiomc_tpu_torch.reco.base import (Module, host, register_run, spectrum_tensor,
                                           trace_tensor)
from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils import fft, geometry, units

efp = par.electricFieldParameters
chp = par.channelParameters
stnp = par.stationParameters


def get_channel_vel(det, station_id, channel_id, freqs, zenith, azimuth,
                    antenna_replacements=None, device=device_util.DEFAULT):
    """(VEL_theta(f), VEL_phi(f)) of one channel for arrival directions
    ``zenith``/``azimuth`` (numbers or tensors of one shape; the frequency
    axis is appended) with the analytic antenna models, as complex tensors on
    ``device`` (efield_converters.py:27)."""
    device = device_util.resolve(device)
    model = det.get_antenna_model(station_id, channel_id)
    if antenna_replacements:
        model = antenna_replacements.get(model, model)
    if model not in antenna_ops.ANALYTIC_MODELS:
        raise NotImplementedError(
            f"antenna model {model} requires tabulated data; provide a replacement")
    kind = antenna_ops.ANALYTIC_MODELS[model][0]
    freqs = np.asarray(host(freqs) if isinstance(freqs, torch.Tensor) else freqs)
    tpl = antenna_ops.build_analytic_template(model, freqs)
    templates = np.zeros((3, len(freqs)), dtype=complex)
    templates[:tpl.shape[0]] = tpl
    if tpl.shape[0] == 1:
        templates[1:] = tpl[0]
    rot = antenna_ops.antenna_rotation_matrix(
        *det.get_antenna_orientation(station_id, channel_id))
    zenith, azimuth = torch.broadcast_tensors(
        torch.as_tensor(zenith, dtype=torch.float64, device=device),
        torch.as_tensor(azimuth, dtype=torch.float64, device=device))
    return antenna_ops.analytic_vel(zenith, azimuth,
                                    torch.as_tensor(rot, device=device),
                                    torch.as_tensor(templates, device=device), kind,
                                    antenna_ops.lpda_sector_host(zenith, azimuth, rot, kind))


class efieldToVoltageConverter(Module):
    """Forward antenna folding: V(f) = VEL_theta E_theta + VEL_phi E_phi on a
    GLOBAL time base shared by all channels, with per-efield integer-bin
    placement + sub-bin time shift and trace_start_time = times_min — the
    reference's exact window semantics (efieldToVoltageConverter.py:111-345)."""

    def begin(self, debug=False, time_resolution=None, pre_pulse_time=200 * units.ns,
              post_pulse_time=400 * units.ns, antenna_replacements=None):
        self._pre = pre_pulse_time
        self._post = post_pulse_time
        self._antenna_replacements = antenna_replacements or {}

    @register_run()
    def run(self, evt, station, det, channel_ids=None):
        sim_station = station.get_sim_station()
        station_id = sim_station.get_id()
        if len(sim_station.get_electric_fields()) == 0:
            raise LookupError(f"station {station.get_id()} has no efields")
        if channel_ids is None:
            channel_ids = det.get_channel_ids(station_id)

        # global window over all (channel, efield) pairs (:121-147)
        times_min, times_max = [], []
        fs = None
        for channel_id in channel_ids:
            cab_delay = det.get_cable_delay(station_id, channel_id)
            pos_ch = np.asarray(det.get_relative_position(station_id, channel_id))
            for ef in sim_station.get_electric_fields_for_channels([channel_id]):
                fs = ef.get_sampling_rate()
                t0 = ef.get_trace_start_time() + cab_delay
                if np.linalg.norm(pos_ch - np.asarray(ef.get_position())) > 0.01 * units.mm:
                    t0 += calculate_time_shift_for_cosmic_ray(det, sim_station, ef, channel_id)
                if not np.isnan(t0):
                    times_min.append(t0)
                    times_max.append(t0 + ef.get_number_of_samples() / ef.get_sampling_rate())
        times_min = np.min(times_min)
        times_max = np.max(times_max)
        max_readout = np.max([
            det.get_number_of_samples(station.get_id(), cid)
            / det.get_sampling_frequency(station.get_id(), cid)
            for cid in channel_ids])
        times_min -= self._pre
        times_max += self._post
        while times_max - times_min < max_readout:
            times_max += self._post
        dt = 1.0 / fs
        n_samples = int(round((times_max - times_min) / dt))
        if n_samples % 2 != 0:
            n_samples += 1
        ff_np = fft.freqs_np(n_samples, fs)
        ff = self.tensor(ff_np)

        for channel_id in channel_ids:
            cab_delay = det.get_cable_delay(station_id, channel_id)
            pos_ch = np.asarray(det.get_relative_position(station_id, channel_id))
            channel_spectrum = None
            for ef in sim_station.get_electric_fields_for_channels([channel_id]):
                new_trace = torch.zeros((3, n_samples), dtype=torch.float64,
                                        device=self.device)
                at_antenna = np.linalg.norm(
                    pos_ch - np.asarray(ef.get_position())) <= 0.01 * units.mm
                if not np.isnan(ef.get_trace_start_time()):
                    shift = 0.0 if at_antenna else \
                        calculate_time_shift_for_cosmic_ray(det, sim_station, ef, channel_id)
                    start_time = ef.get_trace_start_time() - times_min + cab_delay + shift
                    start_bin = int(round(start_time / dt))
                    remainder = start_time - start_bin * dt
                    spec = trace_ops.shift_spectrum(
                        spectrum_tensor(ef, self.device), self.tensor(ef.get_frequencies()),
                        remainder)
                    tr = torch.atleast_2d(fft.freq2time(spec, ef.get_sampling_rate()))
                    stop_bin = start_bin + tr.shape[-1]
                    if stop_bin > n_samples:
                        stop_bin = n_samples
                        tr = tr[:, :stop_bin - start_bin]
                    if start_bin < 0:
                        tr = tr[:, -start_bin:]
                        start_bin = 0
                    new_trace[:, start_bin:stop_bin] = tr
                efield_fft = fft.time2freq(new_trace, fs)

                zenith = ef[efp.zenith]
                azimuth = ef[efp.azimuth]
                # refraction into/out of the firn for displaced efields
                # (fresnel_factors_and_signal_zenith, geometryUtilities.py:266)
                t_theta = t_phi = 1.0
                zenith_antenna = zenith
                if not at_antenna:
                    zenith_antenna, t_theta, t_phi = _fresnel_factors_and_signal_zenith(
                        det, sim_station, channel_id, zenith)
                vt, vp = get_channel_vel(det, station_id, channel_id, ff_np, zenith_antenna,
                                         azimuth, self._antenna_replacements,
                                         device=self.device)
                volt = vt * t_theta * efield_fft[1] + vp * t_phi * efield_fft[2]
                volt_spec = torch.where(ff < 5 * units.MHz, torch.zeros_like(volt), volt)
                channel_spectrum = volt_spec if channel_spectrum is None \
                    else channel_spectrum + volt_spec

            ch = Channel(channel_id)
            if channel_spectrum is None:
                ch.set_trace(np.zeros(n_samples), fs)
            else:
                ch.set_frequency_spectrum(host(channel_spectrum), fs)
            ch.set_trace_start_time(times_min)
            station.add_channel(ch)


def _fresnel_factors_and_signal_zenith(det, sim_station, channel_id, zenith):
    """Refraction at the firn surface for displaced efields
    (geometryUtilities.fresnel_factors_and_signal_zenith:266-330)."""
    z_antenna = det.get_relative_position(sim_station.get_id(), channel_id)[2]
    site = str(det.get_site(sim_station.get_id())).lower()
    n_ice = 1.3 if site not in ("lofar", "auger", "ska") else 1.000293
    is_cr = getattr(sim_station, "is_cosmic_ray", lambda: False)()
    if zenith <= 0.5 * np.pi and z_antenna < 0 and is_cr:
        n_2, n_1 = n_ice, 1.0
    elif zenith > 0.5 * np.pi and z_antenna >= 0:
        n_2, n_1 = 1.0, n_ice
    else:
        return zenith, 1.0, 1.0
    return (float(geometry.fresnel_angle(zenith, n_2=n_2, n_1=n_1)),
            float(geometry.fresnel_t_p(zenith, n_2=n_2, n_1=n_1)),
            float(geometry.fresnel_t_s(zenith, n_2=n_2, n_1=n_1)))


def stacked_lstsq(L, b, rcond=1e-10):
    """Solve L x = b in every frequency bin (voltageToEfieldConverter.py:130-156):
    L [F, C, P], b [F, C] complex tensors -> x [F, P]. Two channels and two
    polarizations take the analytic 2x2 inverse, anything else the SVD
    pseudo-inverse with singular values below rcond * max cut."""
    if L.shape[-2] == L.shape[-1] and L.shape[-1] == 2:
        denom = L[:, 0, 0] * L[:, 1, 1] - L[:, 0, 1] * L[:, 1, 0]
        e_theta = (b[:, 0] * L[:, 1, 1] - b[:, 1] * L[:, 0, 1]) / denom
        e_phi = (b[:, 1] - L[:, 1, 0] * e_theta) / L[:, 1, 1]
        return torch.stack((e_theta, e_phi), dim=-1)
    u, s, vh = torch.linalg.svd(L, full_matrices=False)
    s_max = s.max(dim=-1, keepdim=True).values
    inv_s = torch.where(s >= rcond * s_max, 1.0 / torch.where(s == 0, 1.0, s), 0.0)
    x = torch.einsum("...ji,...j->...i", vh,
                     inv_s * torch.einsum("...ji,...j->...i", u, b.conj()))
    return torch.conj_physical(x)


class voltageToEfieldConverter(Module):
    """Unfold the electric field from channel voltages
    (voltageToEfieldConverter.py:158-242)."""

    def begin(self, antenna_replacements=None):
        self._antenna_replacements = antenna_replacements or {}

    @register_run()
    def run(self, evt, station, det, use_channels=None, use_MC_direction=False,
            force_Polarization=""):
        if use_channels is None:
            use_channels = [0, 1, 2, 3]
        if use_MC_direction:
            zenith = station.get_sim_station()[stnp.zenith]
            azimuth = station.get_sim_station()[stnp.azimuth]
        else:
            zenith = station[stnp.zenith]
            azimuth = station[stnp.azimuth]

        station_id = station.get_id()
        # align channels: undo cable delays, common window
        chans = [station.get_channel(cid) for cid in use_channels]
        fs = chans[0].get_sampling_rate()
        ff_np = chans[0].get_frequencies()
        ff = self.tensor(ff_np)
        t_ref = chans[0].get_trace_start_time() - det.get_cable_delay(station_id,
                                                                      use_channels[0])
        V = []
        for cid, chn in zip(use_channels, chans):
            delay = det.get_cable_delay(station_id, cid)
            dt_shift = chn.get_trace_start_time() - delay - t_ref
            V.append(trace_ops.shift_spectrum(spectrum_tensor(chn, self.device), ff,
                                              -dt_shift))
        V = torch.stack(V)                                          # [C, F]
        factor = torch.stack([torch.stack(get_channel_vel(
            det, station_id, cid, ff_np, zenith, azimuth, self._antenna_replacements,
            device=self.device)) for cid in use_channels])          # [C, 2, F]

        denom = factor[0, 0] * factor[-1, 1] - factor[0, 1] * factor[-1, 0]
        mask = torch.abs(denom) != 0

        efield3_f = torch.zeros((3, V.shape[-1]), dtype=V.dtype, device=self.device)
        b = V[:, mask].T                                            # [F', C]
        if force_Polarization == "eTheta":
            efield3_f[1:2, mask] = stacked_lstsq(factor[:, 0, mask].T[:, :, None], b).T
        elif force_Polarization == "ePhi":
            efield3_f[2:, mask] = stacked_lstsq(factor[:, 1, mask].T[:, :, None], b).T
        else:
            efield3_f[1:, mask] = stacked_lstsq(factor[:, :, mask].permute(2, 0, 1), b).T

        pos = np.mean([det.get_relative_position(station_id, cid)
                       for cid in use_channels], axis=0)
        electric_field = ElectricField(use_channels, pos)
        electric_field.set_frequency_spectrum(host(efield3_f), fs)
        electric_field.set_parameter(efp.zenith, zenith)
        electric_field.set_parameter(efp.azimuth, azimuth)
        electric_field.set_trace_start_time(t_ref)
        station.add_electric_field(electric_field)


class electricFieldSignalReconstructor(Module):
    """Efield observables: signal time, energy fluence, polarization angle
    (modules/electricFieldSignalReconstructor.py:35-150); the envelope on
    the device."""

    def begin(self, signal_window_pre=10 * units.ns, signal_window_post=40 * units.ns):
        self._pre = signal_window_pre
        self._post = signal_window_post

    @register_run()
    def run(self, evt, station, det=None, signal_search_window=None):
        from nuradiomc_tpu_torch.utils.constants import Z_0

        for ef in station.get_electric_fields():
            trace_t = trace_tensor(ef, self.device)
            trace = host(trace_t)
            times = ef.get_times()
            if signal_search_window is not None:
                m = (times > signal_search_window[0]) & (times < signal_search_window[1])
                trace_m, times_m = trace_t[:, self.tensor(m)], times[m]
            else:
                trace_m, times_m = trace_t, times
            env_mag = torch.linalg.vector_norm(trace_ops.hilbert_envelope(trace_m), dim=0)
            signal_time = times_m[int(torch.argmax(env_mag))]
            ef[efp.signal_time] = signal_time

            mask = (times > signal_time - self._pre) & (times < signal_time + self._post)
            dt = 1.0 / ef.get_sampling_rate()
            f_signal = np.sum(trace[:, mask] ** 2, axis=1) * dt
            noise_mask = ~mask
            if np.any(noise_mask):
                rms = np.sum(trace[:, noise_mask] ** 2, axis=1) / np.sum(noise_mask)
                f_signal -= rms * np.sum(mask) * dt
            fluence = f_signal / Z_0  # energy fluence per polarization
            ef[efp.signal_energy_fluence] = fluence
            ef[efp.polarization_angle] = np.arctan2(np.abs(fluence[2]) ** 0.5,
                                                    np.abs(fluence[1]) ** 0.5)


# copied from nuradiomc_tpu/reco/efield_converters.py:323-331
def _refractive_index_for_signal(det, station_id, channel_id, sim_zenith):
    """Medium index at the antenna for a signal from above/below
    (utilities/ice.get_refractive_index semantics)."""
    site = str(det.get_site(station_id)).lower()
    if site in ("lofar", "auger", "ska"):
        return 1.000293
    if sim_zenith is not None and sim_zenith > np.pi / 2:      # from below: ice
        return 1.3
    return 1.000293


def calculate_time_shift_for_cosmic_ray(det, sim_station, efield, channel_id):
    """Plane-wave arrival delay of one efield at a displaced antenna
    (efieldToVoltageConverter.calculate_time_shift_for_cosmic_ray:382-422)."""
    from nuradiomc_tpu_torch.reco.direction import get_time_delay_from_direction

    station_id = sim_station.get_id()
    zen = sim_station[stnp.zenith] if sim_station.has_parameter(stnp.zenith) \
        else efield[efp.zenith]
    n = _refractive_index_for_signal(det, station_id, channel_id, zen)
    rel = (np.asarray(det.get_relative_position(station_id, channel_id))
           - np.asarray(efield.get_position()))
    return get_time_delay_from_direction(efield[efp.zenith], efield[efp.azimuth], rel, n)


class efieldToVoltageConverterPerEfield(Module):
    """Antenna folding per electric field: one SimChannel per (channel,
    efield) so every shower/ray contribution stays separately inspectable
    (modules/efieldToVoltageConverterPerEfield.py:15-108)."""

    def begin(self, antenna_replacements=None):
        self._reps = antenna_replacements or {}

    @register_run()
    def run(self, evt, station, det):
        sim_station = station.get_sim_station() \
            if hasattr(station, "get_sim_station") else station
        if sim_station is None or len(sim_station.get_electric_fields()) == 0:
            raise LookupError(f"station {station.get_id()} has no efields")
        station_id = sim_station.get_id()

        for channel_id in det.get_channel_ids(station_id):
            pos_ch = np.asarray(det.get_relative_position(station_id, channel_id))
            for ef in sim_station.get_electric_fields_for_channels([channel_id]):
                sim_channel = SimChannel(channel_id, shower_id=ef.get_shower_id(),
                                         ray_tracing_id=ef.get_ray_tracing_solution_id())
                if ef.has_parameter(efp.ray_path_type):
                    sim_channel[chp.signal_ray_type] = ef[efp.ray_path_type]

                ff_np = ef.get_frequencies()
                spec = spectrum_tensor(ef, self.device)
                vt, vp = get_channel_vel(det, station_id, channel_id, ff_np,
                                         ef[efp.zenith], ef[efp.azimuth], self._reps,
                                         device=self.device)
                volt = vt * spec[1] + vp * spec[2]
                volt_spec = torch.where(self.tensor(ff_np) < 5 * units.MHz,   # remove DC (:87)
                                        torch.zeros_like(volt), volt)

                # cosmic-ray style: one efield shared by displaced antennas
                if np.linalg.norm(pos_ch - np.asarray(ef.get_position())) > 0.01 * units.mm:
                    shift = calculate_time_shift_for_cosmic_ray(det, sim_station, ef,
                                                                channel_id)
                else:
                    shift = 0.0
                sim_channel.set_frequency_spectrum(host(volt_spec), ef.get_sampling_rate())
                sim_channel.set_trace_start_time(ef.get_trace_start_time() + shift)
                sim_station.add_channel(sim_channel)


# copied from nuradiomc_tpu/reco/efield_converters.py:411-418
def select_channels_per_station(det, station_id, requested_channel_ids):
    """channel_group_id -> [channel ids] mapping
    (modules/io/coreas/readCoREASDetector.select_channels_per_station)."""
    groups = {}
    for cid in requested_channel_ids:
        gid = det.get_channel_group_id(station_id, cid)
        groups.setdefault(gid, []).append(cid)
    return groups


class voltageToEfieldConverterPerChannelGroup(Module):
    """Unfold E(f) per channel *group* — two orthogonally polarized antennas
    in one mechanical structure (LOFAR/Auger style), analytic 2x2 inverse per
    frequency bin (modules/voltageToEfieldConverterPerChannelGroup.py:12-106)."""

    def begin(self, use_MC_direction=False, antenna_replacements=None):
        self._use_mc = use_MC_direction
        self._reps = antenna_replacements or {}

    @register_run()
    def run(self, evt, station, det):
        if self._use_mc:
            sim = station.get_sim_station()
            if sim is None or not sim.has_parameter(stnp.zenith):
                raise ValueError("MC direction requested but no simulation present")
            zenith, azimuth = sim[stnp.zenith], sim[stnp.azimuth]
        else:
            zenith, azimuth = station[stnp.zenith], station[stnp.azimuth]

        station_id = station.get_id()
        all_ids = station.get_channel_ids()
        ch0 = station.get_channel(all_ids[0])
        ff_np = np.asarray(ch0.get_frequencies())
        fs = ch0.get_sampling_rate()

        for gid, use_channels in select_channels_per_station(det, station_id,
                                                             all_ids).items():
            pos = np.mean([det.get_relative_position(station_id, cid)
                           for cid in use_channels], axis=0)
            factor = torch.stack([torch.stack(get_channel_vel(
                det, station_id, cid, ff_np, zenith, azimuth, self._reps,
                device=self.device)) for cid in use_channels])      # (n_ch, 2, F)
            V = torch.stack([spectrum_tensor(station.get_channel(cid), self.device)
                             for cid in use_channels])

            E1 = torch.zeros_like(V[0])
            E2 = torch.zeros_like(V[0])
            # first/second and first/last pairings, as the reference (:86-96)
            for j in (1, -1):
                denom = factor[0, 0] * factor[j, 1] - factor[0, 1] * factor[j, 0]
                mask = torch.abs(denom) != 0
                E1[mask] = (V[0] * factor[j, 1] - V[j] * factor[0, 1])[mask] / denom[mask]
                E2[mask] = (V[j] - factor[j, 0] * E1)[mask] / factor[j, 1][mask]

            efield = ElectricField(use_channels, pos)
            efield.set_frequency_spectrum(host(torch.stack([torch.zeros_like(E1), E1, E2])),
                                          fs)
            efield.set_trace_start_time(
                station.get_channel(use_channels[0]).get_trace_start_time())
            efield[efp.zenith] = zenith
            efield[efp.azimuth] = azimuth
            station.add_electric_field(efield)


class voltageToEfieldConverterPerChannel(Module):
    """Per-channel antenna unfolding assuming a single polarization fraction
    (modules/voltageToEfieldConverterPerChannel.py:28-81): every channel gets
    its own ElectricField with E_theta = sqrt(1-pol) V / VEL_theta and
    E_phi = sqrt(pol) V / VEL_phi (bins with zero response stay zero)."""

    def begin(self, antenna_replacements=None):
        self._reps = antenna_replacements or {}

    @register_run()
    def run(self, evt, station, det, pol=0):
        sim = station.get_sim_station()
        src = sim if (sim is not None and sim.has_parameter(stnp.zenith)) else station
        zenith = src[stnp.zenith]
        azimuth = src[stnp.azimuth]
        station_id = station.get_id()
        for ch in station.iter_channels():
            vt, vp = get_channel_vel(det, station_id, ch.get_id(), ch.get_frequencies(),
                                     zenith, azimuth, self._reps, device=self.device)
            spec = spectrum_tensor(ch, self.device)
            out = torch.zeros((3, spec.shape[-1]), dtype=spec.dtype, device=self.device)
            m1 = torch.abs(vt) != 0
            m2 = torch.abs(vp) != 0
            out[1][m1] = math.sqrt(1.0 - pol) * spec[m1] / vt[m1]
            out[2][m2] = math.sqrt(pol) * spec[m2] / vp[m2]
            ef = ElectricField([ch.get_id()])
            ef.set_frequency_spectrum(host(out), ch.get_sampling_rate())
            ef[efp.zenith] = zenith
            ef[efp.azimuth] = azimuth
            ef.set_trace_start_time(ch.get_trace_start_time())
            station.add_electric_field(ef)
