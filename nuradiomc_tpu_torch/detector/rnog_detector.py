"""RNO-G detector with full measured signal chains (host numpy).

Counterpart of ``nuradiomc_tpu/detector/rnog_detector.py``, a copy: the
reference's MongoDB detector API (NuRadioReco/detector/RNO_G/
rnog_detector.py) served from its own version-1 export file (``.json`` /
``.json.xz``, rnog_detector.py:223-381: ``data`` / ``periods`` /
``default_values``), with time validity and the signal chain composed as
get_signal_chain_response:883-1008 (per-component responses, gain
calibrations, time delays; the average group delay removed from the phase
and kept apart). Standard library ``json`` and ``lzma`` only.
"""

from __future__ import annotations

import datetime
import json
import lzma

import numpy as np

from nuradiomc_tpu_torch.detector.hardware_response import Response
from nuradiomc_tpu_torch.utils import units

# copied from nuradiomc_tpu/detector/rnog_detector.py:33-343
# site coordinates (reference rnog_detector.get_site_coordinates:1449-1468)
SITE_COORDINATES = {"summit": (72.57, -38.46)}


def _to_datetime(t):
    if isinstance(t, datetime.datetime):
        return t
    return datetime.datetime.fromisoformat(str(t))


def _component_complex(entry):
    """(frequencies [GHz], complex values, time_delay, weight) of one
    response-chain component (rnog_detector.py:945-1001)."""
    collection = entry.get("collection", "")
    weight = entry.get("weight", 1)

    if collection == "gain_calibration":
        g = entry["gain_factor"]
        if entry.get("gain_factor_unit", "mag") == "dB":
            g = 10 ** (g / 20)
        return None, complex(g), 0.0, weight

    if collection == "time_delays":
        t = entry["time_delay"] * getattr(units, entry.get("time_delay_unit", "ns"))
        return None, complex(1.0), t, weight

    mag = np.asarray(entry["mag"], dtype=float)
    phase = np.asarray(entry["phase"], dtype=float)
    ff = np.asarray(entry["frequencies"], dtype=float)  # GHz (response.py:49)
    y_units = entry.get("y-axis_units", ["dB", "deg"])

    attenuator = entry.get("attenuator", 0)
    if attenuator:
        if y_units[0] == "dB":
            mag = mag + attenuator
        else:
            mag = mag * 10 ** (attenuator / 20)

    gain = 10 ** (mag / 20) if y_units[0] == "dB" else mag
    if y_units[1].lower() == "deg" and np.max(np.abs(phase)) >= 2 * np.pi:
        phase = np.deg2rad(phase)

    time_delay = entry.get("time_delay", 0.0)
    # remove the average group delay from the phase (it is re-applied
    # through get_time_delay / readout-window bookkeeping); a delay t
    # contributes exp(-2pi i f t) in the trace convention
    phase = phase + 2 * np.pi * ff * time_delay
    return ff, gain * np.exp(1j * phase), time_delay, weight


class RNOGDetector:
    """Time-dependent RNO-G detector from a version-1 export file.

    Parameters
    ----------
    detector_file : str | dict
        Path to a ``.json`` / ``.json.xz`` export (reference
        ``Detector.export``), or the already-parsed export dict.
    selected_stations : list(int), optional
        Restrict to these station ids (rnog_detector.py:351-353).
    database_connection : any
        Unsupported here — live MongoDB queries need the service; pass an
        export file instead (raises if given without ``detector_file``).
    """

    def __init__(self, detector_file=None, selected_stations=None,
                 database_connection=None, over_write_handset_values=None):
        if detector_file is None:
            raise NotImplementedError(
                "Live MongoDB queries require the RNO-G database service; "
                "load a detector export file instead (reference "
                "rnog_detector.Detector.export / detector_file=...)")
        if isinstance(selected_stations, int):
            selected_stations = [selected_stations]
        self._selected_stations = selected_stations
        self._detector_time = None

        if isinstance(detector_file, dict):
            imp = detector_file
        elif detector_file.endswith(".json.xz"):
            with lzma.open(detector_file, "r") as f:
                imp = json.load(f)
        else:
            with open(detector_file) as f:
                imp = json.load(f)

        if imp.get("version") != 1:
            raise ValueError(f"unknown detector export version {imp.get('version')}")

        self._stations = {}
        self._periods = {}
        for sid, sdata in imp["data"].items():
            sid = int(sid)
            if selected_stations is not None and sid not in selected_stations:
                continue
            sdata["channels"] = {int(c): v for c, v in sdata.get("channels", {}).items()}
            sdata["devices"] = {int(d): v for d, v in sdata.get("devices", {}).items()}
            self._stations[sid] = sdata
        for sid, value in imp.get("periods", {}).items():
            sid = int(sid)
            if selected_stations is not None and sid not in selected_stations:
                continue
            ts = [_to_datetime(v) for v in value["modification_timestamps"]]
            self._periods[sid] = {"commission": ts[0], "decommission": ts[-1]}

        self._default_values = imp.get("default_values", {})
        if over_write_handset_values:
            self._default_values.update(over_write_handset_values)
        self.additional_data = imp.get("additional_data")
        self.comment = imp.get("comment")
        self._response_cache = {}

    # -- time handling (rnog_detector.py:416-560) ----------------------------

    def update(self, time):
        """Set the detector time; raises if the loaded export is not valid
        for it (rnog_detector.update:449-500, file-import branch)."""
        self._detector_time = _to_datetime(time)
        for sid, period in self._periods.items():
            if not (period["commission"] < self._detector_time < period["decommission"]):
                raise ValueError(
                    f"detector description loaded from file is not valid at "
                    f"{time} for station {sid} "
                    f"(valid {period['commission']} .. {period['decommission']})")

    def get_detector_time(self):
        return self._detector_time

    def _check_time(self):
        if self._detector_time is None:
            raise ValueError("detector time not set; call det.update(time)")

    def get_station_ids(self):
        self._check_time()
        return [sid for sid, p in self._periods.items()
                if p["commission"] < self._detector_time < p["decommission"]]

    def has_station(self, station_id):
        self._check_time()
        p = self._periods.get(station_id)
        return p is not None and p["commission"] < self._detector_time < p["decommission"]

    # -- station / channel info ----------------------------------------------

    def _station(self, station_id):
        self._check_time()
        if not self.has_station(station_id):
            raise ValueError(f"station {station_id} not commissioned at "
                             f"{self._detector_time}")
        return self._stations[station_id]

    def _channel(self, station_id, channel_id):
        st = self._station(station_id)
        if channel_id not in st["channels"]:
            raise KeyError(f"no channel {channel_id} in station {station_id}")
        return st["channels"][channel_id]

    def get_station(self, station_id):
        return self._station(station_id)

    def get_channel(self, station_id, channel_id):
        """All channel parameters incl. handset defaults and the station ADC
        configs prefixed ``adc_``/``trigger_adc_`` (rnog_detector.py:662-700)."""
        st = self._station(station_id)
        ch = dict(self._channel(station_id, channel_id))
        for key, value in self._default_values.items():
            ch[key] = value[channel_id] if isinstance(value, dict) else value
        for key, value in st.get("signal_digitizer_config", {}).items():
            ch[f"adc_{key}"] = value
        for key, value in st.get("trigger_digitizer_config", {}).items():
            ch[f"trigger_adc_{key}"] = value
        return ch

    def get_channel_ids(self, station_id):
        return sorted(self._station(station_id)["channels"])

    def get_number_of_channels(self, station_id):
        return len(self._station(station_id)["channels"])

    def get_absolute_position(self, station_id):
        return np.array(self._station(station_id)["station_position"]["position"],
                        dtype=float)

    def get_relative_position(self, station_id, channel_id):
        return np.array(self._channel(station_id, channel_id)
                        ["channel_position"]["position"], dtype=float)

    def get_channel_orientation(self, station_id, channel_id):
        pos = self._channel(station_id, channel_id)["channel_position"]
        o, r = pos["orientation"], pos["rotation"]
        return np.deg2rad([o["theta"], o["phi"], r["theta"], r["phi"]])

    def get_antenna_orientation(self, station_id, channel_id):
        return self.get_channel_orientation(station_id, channel_id)

    def get_antenna_model(self, station_id, channel_id, zenith=None):
        return self._channel(station_id, channel_id)["signal_chain"]["VEL"]

    def get_antenna_type(self, station_id, channel_id):
        return self._channel(station_id, channel_id)["ant_type"]

    def get_devices(self, station_id):
        return {did: d.get("device_name", did) for did, d in
                self._station(station_id)["devices"].items()}

    def get_relative_position_device(self, station_id, device_id):
        return np.array(self._station(station_id)["devices"][device_id]
                        ["device_position"]["position"], dtype=float)

    # -- digitizer / noise ----------------------------------------------------

    def get_number_of_samples(self, station_id, channel_id=None):
        return int(self._station(station_id)
                   ["signal_digitizer_config"]["number_of_samples"])

    def get_sampling_frequency(self, station_id, channel_id=None, trigger=False):
        key = "trigger_digitizer_config" if trigger else "signal_digitizer_config"
        return float(self._station(station_id)[key]["sampling_frequency"])

    def get_noise_temperature(self, station_id, channel_id):
        return self.get_channel(station_id, channel_id)["noise_temperature"]

    def is_channel_noiseless(self, station_id, channel_id):
        return self.get_channel(station_id, channel_id)["is_noiseless"]

    # -- signal chain ----------------------------------------------------------

    def get_channel_signal_chain(self, station_id, channel_id):
        return self._channel(station_id, channel_id)["signal_chain"]

    def get_signal_chain_components(self, station_id, channel_id, trigger=False):
        key = "trigger_response_chain" if trigger else "response_chain"
        return [e.get("collection", "?") for e in
                self.get_channel_signal_chain(station_id, channel_id)[key]]

    def get_signal_chain_response(self, station_id, channel_id, trigger=False):
        """Composed complex response of the full chain
        (rnog_detector.get_signal_chain_response:883-1008)."""
        cache_key = (station_id, channel_id, trigger)
        if cache_key in self._response_cache:
            return self._response_cache[cache_key]

        chain = self.get_channel_signal_chain(station_id, channel_id)
        key = "trigger_response_chain" if trigger else "response_chain"
        if key not in chain:
            raise KeyError(f"no {'trigger ' if trigger else ''}response for "
                           f"station.channel {station_id}.{channel_id}")

        ff_grid = None
        for entry in chain[key]:
            if "frequencies" in entry:
                ff = np.asarray(entry["frequencies"], dtype=float)
                if ff_grid is None or len(ff) > len(ff_grid):
                    ff_grid = ff
        if ff_grid is None:
            ff_grid = np.linspace(0.0, 2.5, 1001)

        total = np.ones(len(ff_grid), dtype=complex)
        total_delay = 0.0
        names = []
        for entry in chain[key]:
            ff, values, t_delay, weight = _component_complex(entry)
            if ff is None:
                comp = np.full(len(ff_grid), values)
            else:
                r = Response(ff, values, name=entry.get("name", "component"))
                comp = r(ff_grid)
            if weight < 0:
                # deconvolution component: floor the gain to avoid div-by-0
                # outside the measured band
                mag = np.abs(comp)
                comp = np.where(mag < 1e-12, 1e-12, comp)
            total = total * comp ** weight
            total_delay += weight * t_delay
            names.append(f"{entry.get('collection', '?')}:{entry.get('name', '?')}")

        resp = Response(ff_grid, total, name="*".join(names))
        resp._components = names
        resp.time_delay = total_delay
        self._response_cache[cache_key] = resp
        return resp

    def get_amplifier_response(self, station_id, channel_id, frequencies):
        """Complex chain response on a frequency grid
        (rnog_detector.py:850-881)."""
        return self.get_signal_chain_response(station_id, channel_id)(frequencies)

    def get_time_delay(self, station_id, channel_id, use_stored=True, trigger=False):
        """Sum of the stored per-component time delays
        (rnog_detector._get_time_delay:1288-1362)."""
        chain = self.get_channel_signal_chain(station_id, channel_id)
        key = "trigger_response_chain" if trigger else "response_chain"
        return float(sum(e.get("weight", 1) * e.get("time_delay", 0.0)
                         * (getattr(units, e["time_delay_unit"])
                            if "time_delay_unit" in e else 1.0)
                         for e in chain[key]))

    def get_cable_delay(self, station_id, channel_id, use_stored=True, trigger=False):
        return self.get_time_delay(station_id, channel_id, use_stored, trigger)

    def get_site(self, station_id):
        return "summit"

    def get_site_coordinates(self, station_id=None):
        return SITE_COORDINATES["summit"]

    def export_as_string(self):
        return json.dumps({"version": 1,
                           "data": {str(k): v for k, v in self._stations.items()},
                           "default_values": self._default_values},
                          indent=4, default=str)
