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


class crRNOGTemplateCreator(Module):
    """Cosmic-ray voltage templates from gaussian electric fields
    (modules/RNO_G/crRNOGTemplateCreator.py:26-289). Not ported yet: it folds
    the templates through the RNO-G hardware response
    (``detector/hardware_response.py``), which the port does not have
    (ROADMAP queue 1 item 8, ``detector/*``)."""

    def begin(self, *args, **kwargs):
        raise NotImplementedError(
            "crRNOGTemplateCreator needs detector/hardware_response.py, which is not "
            "ported yet (ROADMAP queue 1 item 8, detector/*)")

    def run(self, *args, **kwargs):
        self.begin()
