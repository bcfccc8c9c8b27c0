# copied from nuradiomc_tpu/detector/ska.py:1-127 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""Ideal SKA-Low station description (detector/SKA/detector.py:10-260).

Every receiver unit is a dual-polarized SKALA antenna; the two channels of
one unit share a position and a ``channel_group_id`` (the antenna id), and
channel ids are ``antenna_id * 10 + pol``. Channel electrical properties
come from the bundled ``ska_channels.json`` (copied from the reference's
detector/SKA data); positions are added programmatically or read from the
SKA layout.txt directory structure.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nuradiomc_tpu_torch.utils import units

_CHANNEL_FILE = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                             "data", "detectors", "ska_channels.json")


class SKADetector:
    """Ideal SKA detector (reference detector/SKA/detector.py API)."""

    def __init__(self, position_path=None, channel_file=None,
                 detector_altitude=460 * units.m,
                 maximum_radius=600 * units.m,
                 n_samples=1024, sampling_frequency=0.8 * units.GHz):
        self.detector_altitude = detector_altitude
        self.maximum_radius = maximum_radius
        self._n_samples = n_samples
        self._sampling_frequency = sampling_frequency

        with open(channel_file or _CHANNEL_FILE) as f:
            channels = json.load(f)["channels"]
        self.channel_data = {c["channel_id"]: c for c in channels.values()}
        self.ref_channel_ids = sorted(self.channel_data)

        self._antenna_positions = {}
        self._station_positions = {}
        if position_path is not None:
            self.read_antenna_positions(position_path, maximum_radius)

    # ---- layout ----------------------------------------------------------
    def read_antenna_positions(self, base_path, maximum_radius=600 * units.m):
        """Read the SKA layout.txt directory structure: a station list at
        <base>/layout.txt and per-station antenna layouts at
        <base>/<station>/layout.txt (detector.py:107-151)."""
        stations = np.loadtxt(os.path.join(base_path, "layout.txt"))
        stations = np.atleast_2d(stations)
        names = sorted(d for d in os.listdir(base_path)
                       if os.path.isdir(os.path.join(base_path, d)))
        for sid, (name, pos) in enumerate(zip(names, stations)):
            r = np.linalg.norm(pos[:2])
            if r > maximum_radius:
                continue
            self.add_station_position(sid, np.append(
                pos[:2], self.detector_altitude))
            ant = np.atleast_2d(np.loadtxt(
                os.path.join(base_path, name, "layout.txt")))
            for aid, apos in enumerate(ant):
                self.add_antenna_position(sid, aid, np.append(apos[:2], 0.0))

    def add_station_position(self, station_id, position):
        self._station_positions[int(station_id)] = np.asarray(position, float)

    def add_antenna_position(self, station_id, antenna_id, position):
        self._antenna_positions.setdefault(int(station_id), {})[
            int(antenna_id)] = np.asarray(position, float)

    # ---- reference-compatible accessors -----------------------------------
    def get_station_ids(self):
        return sorted(self._antenna_positions)

    def get_channel_ids(self, station_id):
        antenna_ids = np.array(sorted(self._antenna_positions[station_id]))
        return sorted(np.concatenate(
            [antenna_ids * 10 + pol for pol in self.ref_channel_ids]).tolist())

    def get_channel_group_id(self, station_id, channel_id):
        """antenna id = all but the last digit (detector.py:116-139)."""
        s = str(int(channel_id))
        return int(s[:-1]) if len(s) > 1 else 0

    def _ref_channel(self, channel_id):
        return self.channel_data[int(str(int(channel_id))[-1])]

    def get_channel(self, station_id, channel_id):
        ch = dict(self._ref_channel(channel_id))
        ch["channel_group_id"] = self.get_channel_group_id(station_id,
                                                           channel_id)
        return ch

    def get_absolute_position(self, station_id):
        return self._station_positions.get(
            station_id, np.array([0.0, 0.0, self.detector_altitude]))

    def get_relative_position(self, station_id, channel_id):
        aid = self.get_channel_group_id(station_id, channel_id)
        return self._antenna_positions[station_id][aid]

    def get_antenna_model(self, station_id=None, channel_id=None,
                          zenith_antenna=None):
        return self._ref_channel(channel_id)["ant_type"]

    def get_antenna_orientation(self, station_id=None, channel_id=None):
        c = self._ref_channel(channel_id)
        return np.deg2rad([c["ant_orientation_theta"],
                           c["ant_orientation_phi"],
                           c["ant_rotation_theta"], c["ant_rotation_phi"]])

    def get_cable_delay(self, station_id=None, channel_id=None):
        return self._ref_channel(channel_id).get("cab_time_delay", 0.0)

    def get_number_of_samples(self, station_id=None, channel_id=None):
        return self._n_samples

    def get_sampling_frequency(self, station_id=None, channel_id=None):
        return self._sampling_frequency

    def get_site(self, station_id=None):
        return "ska"

    def get_site_coordinates(self, station_id=None):
        return (-26.825, 116.764)   # Murchison site (detector.py:231-233)
