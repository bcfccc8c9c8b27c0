"""Measured hardware (amplifier / cable / filter) responses (host numpy,
the filter multiply on the module's device).

Counterpart of ``nuradiomc_tpu/detector/hardware_response.py``: the
chainable complex ``Response`` (NuRadioReco/detector/response.py:12-624),
the ARIANNA amp 100/200/300 and ARA electronics tables, the LMR cable
parametrisation and the RNO-G signal chains (detector/RNO_G/
analog_components.py:10-108) are host numpy copies, reading the port's own
copy of the measurement tables (``data/hardware_responses/``). The two
incorporator modules (ARIANNA and RNO-G hardwareResponseIncorporator) are
``reco.base.Module``s: the filter comes from the host, the multiply of each
channel's spectrum runs on the module's device.
"""

from __future__ import annotations

import functools
import os

import numpy as np
from scipy.interpolate import interp1d

from nuradiomc_tpu_torch.reco.base import Module, host, spectrum_tensor
from nuradiomc_tpu_torch.utils import units

_DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "data", "hardware_responses")


# copied from nuradiomc_tpu/detector/hardware_response.py:26-73 (Response)
class Response:
    """Chainable complex frequency response (detector/response.py:12-624).

    Multiplying two Response objects composes the chain; calling evaluates
    the total complex response on a frequency grid.
    """

    def __init__(self, frequencies, response, name="response"):
        frequencies = np.asarray(frequencies, dtype=float)
        response = np.asarray(response)
        self._name = name
        self._gain = interp1d(frequencies, np.abs(response),
                              bounds_error=False, fill_value=0.0)
        self._phase = interp1d(frequencies, np.unwrap(np.angle(response)),
                               bounds_error=False, fill_value=0.0)
        self._components = [name]

    @classmethod
    def from_function(cls, frequencies, fn, name="response"):
        return cls(frequencies, fn(np.asarray(frequencies)), name)

    def __call__(self, ff):
        ff = np.asarray(ff, dtype=float)
        return self._gain(ff) * np.exp(1j * self._phase(ff))

    def __mul__(self, other):
        ff = np.linspace(0, 2.5, 10000)  # 0-2.5 GHz composition grid
        if isinstance(other, Response):
            out = Response(ff, self(ff) * other(ff),
                           name=f"{self._name}*{other._name}")
            out._components = self._components + other._components
            return out
        return NotImplemented

    __rmul__ = __mul__

    def get_names(self):
        return list(self._components)

    def calculate_time_delay(self, passband=(0.1, 0.5)):
        """Group delay from the phase slope averaged over the passband
        (response.calculate_time_delay semantics)."""
        ff = np.linspace(passband[0], passband[1], 1000)
        phase = np.unwrap(np.angle(self(ff)))
        slope = np.polyfit(ff, phase, 1)[0]
        return -slope / (2 * np.pi)



# copied from nuradiomc_tpu/detector/hardware_response.py:74-122
@functools.lru_cache(maxsize=8)
def load_amplifier_response(amp_type: str = "100"):
    """ARIANNA series-amp gain/phase (analog_components.load_amplifier_response
    :11-67, including the measurement-circuit attenuation correction)."""
    d = os.path.join(_DATA, "ARIANNA")
    if amp_type == "100":
        gain = np.loadtxt(os.path.join(d, "Amp109_SHP100SLP1000_3L3_60dB.csv"),
                          skiprows=44, delimiter=",")
        phase = np.loadtxt(os.path.join(d, "AMP109_SHP100SLP1000_3L3_PHASE.CSV"),
                           skiprows=3, delimiter=",")
        db_corr = 60.0
    elif amp_type == "200":
        gain = np.loadtxt(os.path.join(d, "amp_200_logmag.csv"), skiprows=3,
                          delimiter=",")
        phase = np.loadtxt(os.path.join(d, "amp_200_phase.csv"), skiprows=3,
                           delimiter=",")
        db_corr = 60.0
    elif amp_type == "300":
        gain = np.loadtxt(os.path.join(d, "amp_300_gain.csv"), skiprows=3,
                          delimiter=",")
        phase = np.loadtxt(os.path.join(d, "amp_300_phase.csv"), skiprows=3,
                           delimiter=",")
        db_corr = 40.0
    else:
        raise NotImplementedError(f"amp type {amp_type} not implemented")

    gain = np.array(gain)
    phase = np.array(phase)
    gain[:, 0] *= units.Hz
    gain[:, 1] += db_corr
    phase[:, 0] *= units.Hz

    gain_f = interp1d(gain[:, 0], gain[:, 1], bounds_error=False, fill_value=0.0)
    phase_f = interp1d(phase[:, 0], np.unwrap(np.deg2rad(phase[:, 1])),
                       bounds_error=False, fill_value=0.0)

    def get_gain(ff):
        return 10 ** (gain_f(ff) / 20.0)

    def get_phase(ff):
        return np.exp(1j * phase_f(ff))

    return {"gain": get_gain, "phase": get_phase}


def get_amplifier_response(ff, amp_type: str):
    """Complex amp response (analog_components.get_amplifier_response:101-110)."""
    amp = load_amplifier_response(amp_type)
    return amp["gain"](ff) * amp["phase"](ff)


# copied from nuradiomc_tpu/detector/hardware_response.py:139-154
@functools.lru_cache(maxsize=2)
def get_ara_system_response():
    """ARA total electronics gain/phase (two filters + amps) from the
    committed measurement table (ARA/analog_components semantics)."""
    path = os.path.join(_DATA, "ARA", "ARA_Electronics_TotalGain_TwoFilters.txt")
    data = np.loadtxt(path, skiprows=3, delimiter=",")
    ff = data[:, 0] * units.MHz
    gain = data[:, 1]          # amplitude gain (unitless)
    phase = data[:, 2]
    gain_f = interp1d(ff, gain, bounds_error=False, fill_value=0.0)
    phase_f = interp1d(ff, np.unwrap(phase), bounds_error=False, fill_value=0.0)

    def response(freqs):
        return gain_f(freqs) * np.exp(1j * phase_f(freqs))

    return response


# copied from nuradiomc_tpu/detector/hardware_response.py:157-173 (the
# second, effective definition of the module)
def get_cable_response_parametrized(frequencies, cable_type, cable_length):
    """LMR cable attenuation from the spec-sheet parametrization
    (detector/ARIANNA/analog_components.get_cable_response_parametrized
    :112-133); amplitude-only (real) response."""
    f_MHz = np.asarray(frequencies) / units.MHz
    if cable_type == "LMR_400":
        attn_db_per_100ft = 0.122290 * f_MHz ** 0.5 + 0.000260 * f_MHz
    elif cable_type == "LMR_240":
        attn_db_per_100ft = 0.242080 * f_MHz ** 0.5 + 0.000330 * f_MHz
    else:
        raise NotImplementedError(f"cable type {cable_type} not defined")
    attn = attn_db_per_100ft / (100 * units.feet) * cable_length
    attn = attn + 0.01  # dB connector loss
    return 1.0 / (10 ** (attn / 10.0)) ** 0.5



def _fold(module, station, filter_of):
    """Each channel's spectrum times its filter, on the module's device."""
    for channel in station.iter_channels():
        filt = filter_of(channel)
        spec = spectrum_tensor(channel, module.device) * module.tensor(filt)
        channel.set_frequency_spectrum(host(spec), channel.get_sampling_rate())


class hardwareResponseIncorporator(Module):
    """Fold (sim_to_data) or unfold (data_to_sim) the measured amp + cable
    chain (ARIANNA/hardwareResponseIncorporator.py:29-110)."""

    def begin(self, debug=False):
        pass

    # copied from nuradiomc_tpu/detector/hardware_response.py:182-201 (get_filter)
    def get_filter(self, ff, station_id, channel_id, det, sim_to_data=True,
                   mode=None):
        amp_type = "100"
        cable = 1.0
        if hasattr(det, "get_station"):
            ch = det.get_station(station_id).channels
            idx = int(np.where(ch.channel_ids == channel_id)[0][0])
            amp_type = ch.amp_type[idx] or "100"
            # parametrized cable loss when the description carries it
            # (ARIANNA get_filter:81)
            try:
                raw = det.get_channel(station_id, channel_id)
                if raw.get("cab_type") and raw.get("cab_length") is not None:
                    cable = get_cable_response_parametrized(
                        ff, raw["cab_type"], float(raw["cab_length"]) * units.m)
            except (KeyError, AttributeError, TypeError):
                pass
        resp = get_amplifier_response(ff, amp_type) * cable
        return resp if sim_to_data else 1.0 / np.where(resp == 0, np.inf, resp)

    def run(self, evt, station, det, sim_to_data=True, **kwargs):
        _fold(self, station, lambda ch: self.get_filter(
            ch.get_frequencies(), station.get_id(), ch.get_id(), det, sim_to_data))

    def end(self):
        pass


# copied from nuradiomc_tpu/detector/hardware_response.py:216-278
# -- RNO-G analog components (detector/RNO_G/analog_components.py:10-108) ----

def _rnog_surface_correction(temp, freqs):
    """Empirical climate-chamber gain correction, surface chain
    (analog_components.py:37-38); temp in K, freqs in GHz-equivalent units."""
    return (1.0377798029 - 0.00135258197 * (temp - 273.15)
            + (0.4788208019 - 0.01790064797 * (temp - 273.15)) * freqs ** 5)


def _rnog_iglu_correction(temp, freqs):
    """Empirical gain correction, IGLU+DRAB chain (analog_components.py:40-41)."""
    return (1.1139014286 - 0.00004392995 * ((temp - 273.15) + 28.8331610295) ** 2
            + (0.6301058083 - 0.0208741539 * (temp - 273.15)) * freqs ** 5)


RNOG_AMPLIFIERS = ("iglu", "deep_impulse", "rno_surface",
                   "rno_surface_impulse", "phased_array", "ULP_216")


@functools.lru_cache(maxsize=8)
def _load_rnog_amp_table(amp_type):
    d = os.path.join(_DATA, "RNO_G")
    files = {"rno_surface": "surface_placeholder.csv",
             "rno_surface_impulse": "surface_impulse_response_placeholder.csv",
             "iglu": "iglu_drab_placeholder.csv",
             "deep_impulse": "deep_impulse_response_placeholder.csv"}
    if amp_type in files:
        ph = os.path.join(d, files[amp_type])
        ff = np.loadtxt(ph, delimiter=",", skiprows=1, usecols=0) * units.Hz
        gain = np.loadtxt(ph, delimiter=",", skiprows=1, usecols=1)
        phase = np.loadtxt(ph, delimiter=",", skiprows=1, usecols=2)
    elif amp_type in ("phased_array", "ULP_216"):
        # Mini-Circuits ULP-216+ S-parameter sheet: S21 in dB / degrees
        ph = os.path.join(d, "ULP-216+_Plus25DegC.s2p")
        cols = np.loadtxt(ph, comments=["#", "!"])
        ff = cols[:, 0] * units.MHz
        gain = 10 ** (cols[:, 3] / 20.0)
        phase = np.deg2rad(cols[:, 4])
    else:
        raise ValueError(f"Amp type `{amp_type}` not recognized; "
                         f"possible values: {RNOG_AMPLIFIERS}")
    return ff, gain, phase


def load_rnog_amp_response(amp_type="rno_surface", temp=293.15):
    """RNO-G signal-chain gain/phase with the empirical temperature
    correction (analog_components.load_amp_response:10-105)."""
    ff, gain, phase = _load_rnog_amp_table(amp_type)
    gain_f = interp1d(ff, gain, bounds_error=False, fill_value=0.0)
    phase_f = interp1d(ff, np.unwrap(phase), bounds_error=False, fill_value=0.0)
    correction = {"rno_surface": _rnog_surface_correction,
                  "iglu": _rnog_iglu_correction}.get(amp_type)

    def get_gain(freqs, temp=temp):
        g = gain_f(freqs)
        if correction is not None:
            g = correction(temp, np.asarray(freqs)) * g
        return g

    def get_phase(freqs):
        return np.exp(1j * phase_f(freqs))

    return {"gain": get_gain, "phase": get_phase}


class rnogHardwareResponseIncorporator(Module):
    """RNO-G hardware response module
    (modules/RNO_G/hardwareResponseIncorporator.py:15-200): amp response from
    the detector's amp type (or an RNOGDetector's composed signal-chain
    Response), optional min-gain clamp for deconvolution, phase-only /
    relative modes."""

    def begin(self, trigger_channels=None):
        self.trigger_channels = trigger_channels

    # copied from nuradiomc_tpu/detector/hardware_response.py:291-326 (get_filter)
    def get_filter(self, frequencies, station_id, channel_id, det,
                   temp=293.15, sim_to_data=False, phase_only=False,
                   mode=None, mingainlin=None, is_trigger=False):
        from nuradiomc_tpu_torch.detector.rnog_detector import RNOGDetector

        if isinstance(det, RNOGDetector):
            resp = det.get_signal_chain_response(station_id, channel_id,
                                                 is_trigger)
            amp_response = np.asarray(resp(frequencies), dtype=complex)
        else:
            try:
                amp_type = det.get_channel(station_id, channel_id).get(
                    "amp_type") or "rno_surface"
            except (AttributeError, KeyError):
                amp_type = "rno_surface"
            amp = load_rnog_amp_response(amp_type, temp=temp)
            amp_response = amp["gain"](frequencies, temp) * \
                amp["phase"](frequencies)

        if mingainlin is not None:
            mingainlin = float(mingainlin)
            ampmax = np.max(np.abs(amp_response))
            low = np.abs(amp_response) < mingainlin * ampmax
            amp_response[low] = (mingainlin * ampmax
                                 * np.exp(1j * np.angle(amp_response[low])))

        if mode == "phase_only" or phase_only:
            amp_response = np.exp(1j * np.angle(amp_response))
        elif mode == "relative":
            ampmax = np.max(np.abs(amp_response))
            if ampmax > 0:
                amp_response = amp_response / ampmax

        if sim_to_data:
            return amp_response
        return 1.0 / np.where(amp_response == 0, np.inf, amp_response)

    def run(self, evt, station, det, sim_to_data=False, phase_only=False,
            mode=None, mingainlin=None, temp=293.15):
        _fold(self, station, lambda ch: self.get_filter(
            ch.get_frequencies(), station.get_id(), ch.get_id(), det, temp=temp,
            sim_to_data=sim_to_data, phase_only=phase_only, mode=mode,
            mingainlin=mingainlin))

    def end(self):
        pass
