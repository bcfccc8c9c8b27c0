"""RNO-G specific trigger hardware modules (torch).

Counterpart of ``nuradiomc_tpu/reco/rnog.py``; the filters, the diode, the
majority logic, the gain and the ADC run on the module's device, the noise
estimates (medians of standard deviations) on the host.

* rnogSurfaceTrigger: Schottky-diode envelope trigger on the surface LPDAs
  (modules/trigger/rnog_surface_trigger.py:15-201) — 80-180 MHz cheby1
  bandpass, -10 dB trigger-path attenuator, measured linear diode response
  v_out = a*v_in^2 + b, per-channel threshold, majority-logic coincidence.
* triggerBoardResponse: flower-board gain equalization + ADC
  (modules/RNO_G/triggerBoardResponse.py:19-277) — picks the HMCAD1511 gain
  step that realizes the configured number of noise bits, then quantizes with
  the perfect floor comparator.
* crRNOGTemplateCreator: cosmic-ray voltage templates from gaussian electric
  fields folded through the antenna, the RNO-G surface-amp response
  (``detector/hardware_response.py``) and a band-pass
  (modules/RNO_G/crRNOGTemplateCreator.py:26-289), pickled in the
  Templates-provider layout.
"""

from __future__ import annotations

import numpy as np

import torch

from nuradiomc_tpu_torch.framework.event import Trigger
from nuradiomc_tpu_torch.ops import adc as adc_ops
from nuradiomc_tpu_torch.ops import filters
from nuradiomc_tpu_torch.ops import triggers as trigger_ops
from nuradiomc_tpu_torch.reco.base import Module, host, register_run, trace_tensor
from nuradiomc_tpu_torch.utils import units

# linear fits a*v^2+b to the measured diode response for each (temperature,
# bias voltage) board operating point (rnog_surface_trigger.py:40-80)
SCHOTTKY_DIODE_COEFFS = {
    (300, 2.0): (38.10032, -9.19654194e-08),
    (300, 1.5): (34.6274877, -8.45140238e-05),
    (300, 1.0): (24.6683322, -1.03679002e-03),
    (300, 0.5): (16.0005295, -5.83972425e-04),
    (273, 2.0): (45.9684369, -6.15792586e-06),
    (273, 1.5): (38.80661, -3.01491791e-04),
    (273, 1.0): (29.45406, -7.71227505e-04),
    (273, 0.5): (15.4192195, -5.10530795e-04),
    (250, 2.0): (55.0380132, -2.13447979e-05),
    (250, 1.5): (49.3192486, -1.67121000e-03),
    (250, 1.0): (37.4351427, -9.76368002e-04),
    (250, 0.5): (17.4574667, -5.90216182e-04),
}


def schottky_diode(trace, threshold, temperature=250 * units.kelvin,
                   Vbias=2 * units.volt):
    """Boolean trigger bins of the diode response (rnog_surface_trigger.py:15-84).

    Elementwise on a tensor (a single trace or a batch (..., N)).
    """
    key = (int(round(temperature / units.kelvin)),
           round(Vbias / units.volt, 1))
    if key not in SCHOTTKY_DIODE_COEFFS:
        raise ValueError(f"no diode measurement for T={key[0]}K Vbias={key[1]}V")
    a, b = SCHOTTKY_DIODE_COEFFS[key]
    return a * trace ** 2 + b > threshold


def surface_trigger_bins(traces, sampling_rate, threshold,
                         temperature=250 * units.kelvin, Vbias=2 * units.volt):
    """Trigger bins of (C, N) voltage traces (a tensor, on its device):
    bandpass 80-180 MHz cheby1(order 3, rp 5), -10 dB attenuator, diode
    comparator."""
    traces = torch.atleast_2d(traces)
    n = traces.shape[-1]
    ff = np.fft.rfftfreq(n, 1.0 / sampling_rate)
    resp = filters.get_filter_response(
        ff, [80 * units.MHz, 180 * units.MHz], "cheby1", order=3, rp=5)
    filtered = torch.fft.irfft(torch.fft.rfft(traces, dim=-1)
                               * torch.as_tensor(resp, device=traces.device), n=n, dim=-1)
    filtered = filtered * 10 ** (-10 / 20.0)
    return schottky_diode(filtered, threshold, temperature, Vbias)


class rnogSurfaceTrigger(Module):
    """Station-level module (rnog_surface_trigger.py:86-201)."""

    @register_run()
    def run(self, evt, station, det, threshold, coinc_window=60 * units.ns,
            number_coincidences=1, triggered_channels=(13, 16, 19),
            temperature=250 * units.kelvin, Vbias=2 * units.volt,
            trigger_name="rnog_surface_trigger"):
        triggered_channels = list(triggered_channels)
        fs = station.get_channel(triggered_channels[0]).get_sampling_rate()
        t0 = station.get_channel(triggered_channels[0]).get_trace_start_time()
        dt = 1.0 / fs

        bins_per_channel = []
        passed = []
        for cid in triggered_channels:
            thr = threshold[cid] if isinstance(threshold, dict) else threshold
            bins = surface_trigger_bins(trace_tensor(station.get_channel(cid), self.device),
                                        fs, thr, temperature, Vbias)[0]
            bins_per_channel.append(bins)
            if bool(bins.any()):
                passed.append(cid)

        has_triggered, trig_bins, first_bin = trigger_ops.majority_logic(
            torch.stack(bins_per_channel), number_coincidences, coinc_window, dt)

        trigger = Trigger(trigger_name, triggered_channels,
                          trigger_type="rnog_surface")
        trigger.set_triggered_channels(passed)
        trigger.set_triggered(bool(has_triggered))
        if has_triggered:
            trigger.set_trigger_time(float(first_bin) * dt + t0)
        station.set_trigger(trigger)


# Table 21 of the HMCAD1511 datasheet (triggerBoardResponse.py:42)
TRIGGER_BOARD_AMPLIFICATIONS = np.array(
    [1, 1.25, 2, 2.5, 4, 5, 8, 10, 12.5, 16, 20, 25, 32, 50], dtype=float)


def estimate_noise_vrms(trace, trace_split=20):
    """Median of per-chunk standard deviations
    (triggerBoardResponse.get_noise_vrms_per_trigger_channel:70-102)."""
    trace = np.asarray(trace)
    n = trace_split * (len(trace) // trace_split)
    return float(np.median(np.std(trace[:n].reshape(trace_split, -1), axis=1)))


def select_adc_gain(vrms, ideal_vrms):
    """Smallest HMCAD1511 gain whose amplified vrms exceeds the ideal value
    (triggerBoardResponse.apply_adc_gain:162-171)."""
    amplified = vrms * TRIGGER_BOARD_AMPLIFICATIONS
    mask = amplified > ideal_vrms
    if np.any(mask):
        idx = int(np.argmax(mask))
    else:
        idx = len(TRIGGER_BOARD_AMPLIFICATIONS) - 1
    return TRIGGER_BOARD_AMPLIFICATIONS[idx], amplified[idx]


class triggerBoardResponse(Module):
    """Flower-board response: trigger filter, noise-bit gain equalization,
    perfect-floor-comparator ADC (triggerBoardResponse.py:19-277)."""

    def begin(self, clock_offset=0.0, adc_output="voltage"):
        self._clock_offset = clock_offset
        self.adc_output = adc_output
        self._adc_input_range = None
        self._nbits = None

    def apply_trigger_filter(self, station, trigger_channels, trigger_filter):
        from nuradiomc_tpu_torch.reco.base import spectrum_tensor

        for cid in trigger_channels:
            ch = station.get_channel(cid)
            ff = np.asarray(ch.get_frequencies())
            ch.set_frequency_spectrum(
                host(spectrum_tensor(ch, self.device) * self.tensor(trigger_filter(ff))),
                ch.get_sampling_rate())

    @register_run()
    def run(self, evt, station, det, trigger_channels, vrms=None,
            apply_adc_gain=True, digitize_trace=True):
        if vrms is None:
            vrms = np.array([estimate_noise_vrms(
                np.asarray(station.get_channel(c).get_trace()))
                for c in trigger_channels])
        elif not hasattr(vrms, "__len__"):
            vrms = np.full(len(trigger_channels), float(vrms))

        equalized, ideal_vrms = [], None
        for cid, v in zip(trigger_channels, vrms):
            chd = det.get_channel(station.get_id(), cid)
            noise_count = chd["trigger_adc_noise_count"]
            nbits = chd["trigger_adc_nbits"]
            rng = chd["trigger_adc_max_voltage"] - chd["trigger_adc_min_voltage"]
            self._adc_input_range = rng
            self._nbits = nbits
            volts_per_adc = rng / (2 ** nbits - 1)
            ideal_vrms = volts_per_adc * noise_count
            if apply_adc_gain:
                gain, v_after = select_adc_gain(v, ideal_vrms)
            else:
                gain, v_after = 1.0, v
            equalized.append(v_after)
            ch = station.get_channel(cid)
            trace = trace_tensor(ch, self.device)
            if apply_adc_gain:
                trace = trace * gain
                ch.set_trace(host(trace), ch.get_sampling_rate())
            if digitize_trace:
                digitized = adc_ops.perfect_floor_comparator(
                    trace, nbits,
                    (chd["trigger_adc_min_voltage"], chd["trigger_adc_max_voltage"]),
                    output=self.adc_output)
                ch.set_trace(host(digitized), ch.get_sampling_rate())

        equalized = np.asarray(equalized)
        if digitize_trace and self.adc_output == "counts":
            lsb = self._adc_input_range / (2 ** self._nbits - 1)
            equalized = equalized / lsb
        return equalized


# copied from nuradiomc_tpu/reco/rnog.py:204-205
def _gaussian_func(x, A, mu, sigma):
    return A * np.exp(-(x - mu) ** 2 / (2 * sigma ** 2))


# copied from nuradiomc_tpu/reco/rnog.py:208-335 (the modules it calls are the
# port's, on the module's device)
class crRNOGTemplateCreator(Module):
    """Create cosmic-ray voltage templates from gaussian electric fields
    (modules/RNO_G/crRNOGTemplateCreator.py:26-289): per (zenith, azimuth,
    efield width) a gaussian E-field is folded through the antenna (+
    optionally the RNO-G surface-amp response and a bandpass) and the channel
    traces are pickled in the Templates-provider layout
    ``[{zen_rad: {az_rad: {width: trace}}}]``. The folding (antenna, RNO-G
    hardware response, band-pass) runs on the module's device."""

    def begin(self, detector_source, template_save_path,
              antenna_replacements=None, debug=False):
        self._detector_source = detector_source
        self._save_path = template_save_path
        self._antenna_replacements = antenna_replacements
        self._params = None

    def set_template_parameter(
            self, template_run_id=(0, 0, 0), template_event_id=(0, 1, 2),
            template_station_id=(101, 101, 101), template_channel_id=(0, 0, 0),
            efield_width=(5, 4, 2), antenna_rotation=(160, 160, 160),
            efield_amplitudes=(-0.2, 0.8), cr_zenith=(55, 55, 55),
            cr_azimuth=(0, 0, 0), sampling_rate=3.2, number_of_samples=2048):
        """Template-set parameters (crRNOGTemplateCreator.py:88-136);
        ``efield_amplitudes`` is (E_theta, E_phi)."""
        self._params = dict(
            run_id=list(template_run_id), event_id=list(template_event_id),
            station_id=list(template_station_id),
            channel_id=list(template_channel_id),
            efield_width=list(efield_width),
            antenna_rotation=list(antenna_rotation),
            efield_amplitudes=tuple(efield_amplitudes),
            cr_zenith=list(cr_zenith), cr_azimuth=list(cr_azimuth),
            sampling_rate=sampling_rate, n_samples=int(number_of_samples))

    def _create_efield_event(self, det, rid, eid, cid, sid, width,
                             e_theta, e_phi, zen, az, fs, n):
        from nuradiomc_tpu_torch.framework import parameters as par
        from nuradiomc_tpu_torch.framework.event import (ElectricField, Event,
                                                   SimChannel, SimStation,
                                                   Station)
        efp = par.electricFieldParameters
        stnp = par.stationParameters

        event = Event(rid, eid)
        station = Station(sid)
        event.set_station(station)
        sim_station = SimStation(sid)
        station.set_sim_station(sim_station)
        sim_station.add_channel(SimChannel(cid, 0, 0))

        x = np.arange(n)
        e_field = np.zeros((3, n))
        e_field[1] = _gaussian_func(x, e_theta, 1000, width)
        e_field[2] = _gaussian_func(x, e_phi, 1000, width)
        ef = ElectricField([cid])
        ef.set_trace(e_field, fs)
        sim_station.add_electric_field(ef)
        sim_station.set_is_cosmic_ray()

        sim_station[stnp.zenith] = np.deg2rad(zen)
        sim_station[stnp.azimuth] = np.deg2rad(az)
        ef[efp.ray_path_type] = "direct"
        ef[efp.zenith] = np.deg2rad(zen)
        ef[efp.azimuth] = np.deg2rad(az)
        return event

    def run(self, template_filename="templates_cr_station_101.pickle",
            include_hardware_response=True, return_templates=False,
            bandpass_filter=None):
        import os
        import pickle

        from nuradiomc_tpu_torch.detector.detector import Detector
        from nuradiomc_tpu_torch.detector.hardware_response import (
            rnogHardwareResponseIncorporator)
        from nuradiomc_tpu_torch.reco.channel_processing import channelBandPassFilter
        from nuradiomc_tpu_torch.reco.efield_converters import efieldToVoltageConverter

        if self._params is None:
            self.set_template_parameter()
        p = self._params

        converter = efieldToVoltageConverter(device=self.device)
        converter.begin(antenna_replacements=self._antenna_replacements)
        hardware = rnogHardwareResponseIncorporator(device=self.device)
        hardware.begin()
        bandpass = channelBandPassFilter(device=self.device)

        template_events = []
        save_dic = {}
        for crz in sorted(set(p["cr_zenith"])):
            save_dic_help = {}
            for cra in sorted(set(p["cr_azimuth"])):
                templates = {}
                for rid, eid, sid, cid, width, antrot, zen, az in zip(
                        p["run_id"], p["event_id"], p["station_id"],
                        p["channel_id"], p["efield_width"],
                        p["antenna_rotation"], p["cr_zenith"], p["cr_azimuth"]):
                    if zen != crz or az != cra:
                        continue
                    det = Detector(self._detector_source)
                    det.get_channel(sid, cid)["ant_rotation_phi"] = antrot
                    det.update(None)  # rebuild with the modified rotation

                    evt = self._create_efield_event(
                        det, rid, eid, cid, sid, width,
                        p["efield_amplitudes"][0], p["efield_amplitudes"][1],
                        zen, az, p["sampling_rate"], p["n_samples"])
                    station = evt.get_station(sid)
                    converter.run(evt, station, det)
                    if include_hardware_response:
                        hardware.run(evt, station, det, sim_to_data=True)
                    if bandpass_filter is not None:
                        bandpass.run(evt, station, det, **bandpass_filter)
                    template_events.append(evt)
                    templates[width] = np.asarray(
                        station.get_channel(cid).get_trace())
                if templates:
                    save_dic_help[np.deg2rad(cra)] = templates
            if save_dic_help:
                save_dic[np.deg2rad(crz)] = save_dic_help

        with open(os.path.join(self._save_path, template_filename), "wb") as f:
            pickle.dump([save_dic], f)
        if return_templates:
            return template_events

    def end(self):
        pass
