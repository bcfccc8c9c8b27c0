"""SQL detector backend on sqlite3 (host, standard library).

Counterpart of ``nuradiomc_tpu/detector/detector_sql.py``, a copy: the
reference's MySQL detector (NuRadioReco/detector/detector_sql.py:13-555,
normalized stations/channels/antennas/cables/positions/amps/adcs tables
joined by *_uid keys, channel validity by commission and decommission time)
on a single sqlite file; ``SQLDetector.buffer()`` gives the dict the port's
:class:`nuradiomc_tpu_torch.detector.detector.Detector` reads
(detector_base.py:39-130 buffer_db), ``export_detector_to_sql`` the inverse.
"""

from __future__ import annotations

import datetime
import sqlite3

# copied from nuradiomc_tpu/detector/detector_sql.py:22-293
SQL_SCHEMA = """
CREATE TABLE IF NOT EXISTS positions (
    position TEXT, measurement_time TEXT,
    easting REAL, northing REAL, altitude REAL, zone TEXT, site TEXT);
CREATE TABLE IF NOT EXISTS stations (
    station_uid INTEGER PRIMARY KEY, station_id INTEGER,
    commission_time TEXT, decommission_time TEXT, station_type TEXT,
    position TEXT, board_number INTEGER, MAC_address TEXT, MBED_type TEXT);
CREATE TABLE IF NOT EXISTS antennas (
    antenna_uid INTEGER PRIMARY KEY, antenna_type TEXT,
    orientation_theta REAL, orientation_phi REAL,
    rotation_theta REAL, rotation_phi REAL,
    position_x REAL, position_y REAL, position_z REAL,
    deployment_time TEXT, comment TEXT);
CREATE TABLE IF NOT EXISTS cables (
    cable_uid INTEGER PRIMARY KEY, cable_type TEXT, cable_length REAL,
    reference_measurement TEXT, time_delay REAL, cable_id INTEGER,
    comment TEXT);
CREATE TABLE IF NOT EXISTS amps (
    amp_uid INTEGER PRIMARY KEY, amp_type TEXT, reference_measurement TEXT);
CREATE TABLE IF NOT EXISTS adcs (
    adc_uid INTEGER PRIMARY KEY, adc_id INTEGER, time_delay REAL,
    nbits INTEGER, sampling_frequency REAL, n_samples INTEGER,
    noise_temperature REAL);
CREATE TABLE IF NOT EXISTS channels (
    channel_uid INTEGER PRIMARY KEY, station_uid INTEGER, channel_id INTEGER,
    commission_time TEXT, decommission_time TEXT,
    antenna_uid INTEGER, cable_uid INTEGER, amp_uid INTEGER,
    adc_uid INTEGER);
"""

_FAR_FUTURE = "2100-01-01 00:00:00"
_FAR_PAST = "1970-01-01 00:00:00"


def _iso(t):
    if t is None:
        return None
    if isinstance(t, datetime.datetime):
        return t.strftime("%Y-%m-%d %H:%M:%S")
    return str(t)


class SQLDetector:
    """sqlite3-backed detector with the reference SQL-detector API
    (detector_sql.py:13-470).

    Parameters
    ----------
    database : str | sqlite3.Connection
        Path to the sqlite file (or ``":memory:"``), or an open connection.
    """

    def __init__(self, database):
        if isinstance(database, sqlite3.Connection):
            self._conn = database
        else:
            self._conn = sqlite3.connect(database)
        self._conn.row_factory = sqlite3.Row
        self._conn.executescript(SQL_SCHEMA)
        self._current_time = datetime.datetime.now()

    def update(self, timestamp):
        """Set the evaluation time for commission/decommission filtering
        (detector_sql.update:51-53)."""
        if isinstance(timestamp, str):
            timestamp = datetime.datetime.fromisoformat(timestamp)
        self._current_time = timestamp

    # -- bulk queries (reference get_everything* family) ---------------------

    def _channel_rows(self, station_id=None):
        query = """
        SELECT st.station_id AS station_id,
               st.station_type, st.position AS station_position,
               ch.channel_id AS channel_id,
               ch.commission_time, ch.decommission_time,
               ant.antenna_type, ant.orientation_theta, ant.orientation_phi,
               ant.rotation_theta, ant.rotation_phi,
               ant.position_x, ant.position_y, ant.position_z,
               ant.deployment_time, ant.comment AS ant_comment,
               cab.cable_type, cab.cable_length, cab.time_delay AS cab_time_delay,
               cab.cable_id, cab.reference_measurement AS cab_reference_measurement,
               amps.amp_type, amps.reference_measurement AS amp_reference_measurement,
               adcs.adc_id, adcs.time_delay AS adc_time_delay, adcs.nbits,
               adcs.sampling_frequency, adcs.n_samples, adcs.noise_temperature
        FROM stations AS st
            JOIN channels AS ch USING(station_uid)
            JOIN antennas AS ant USING(antenna_uid)
            JOIN cables AS cab USING(cable_uid)
            JOIN amps USING(amp_uid)
            JOIN adcs USING(adc_uid)
        WHERE ? BETWEEN ch.commission_time AND ch.decommission_time
          AND ? BETWEEN st.commission_time AND st.decommission_time
        """
        t = _iso(self._current_time)
        params = [t, t]
        if station_id is not None:
            query += " AND st.station_id = ?"
            params.append(int(station_id))
        return self._conn.execute(query, params).fetchall()

    def get_everything(self, station_id):
        return [dict(r) for r in self._channel_rows(station_id)]

    def get_everything_channels(self):
        return [dict(r) for r in self._channel_rows()]

    def get_everything_stations(self):
        t = _iso(self._current_time)
        rows = self._conn.execute("""
            SELECT st.*, pos.measurement_time, pos.easting, pos.northing,
                   pos.altitude, pos.zone, pos.site
            FROM stations AS st JOIN positions AS pos USING(position)
            WHERE ? BETWEEN st.commission_time AND st.decommission_time
            """, [t]).fetchall()
        return [dict(r) for r in rows]

    def get_everything_positions(self):
        return [dict(r) for r in self._conn.execute(
            "SELECT * FROM positions").fetchall()]

    # -- per-field accessors (detector_sql.py:222-470) -----------------------

    def _one(self, station_id, channel_id):
        for r in self._channel_rows(station_id):
            if r["channel_id"] == channel_id:
                return r
        raise KeyError(f"no channel {channel_id} in station {station_id} "
                       f"commissioned at {self._current_time}")

    def get_relative_position(self, station_id, channel_id):
        r = self._one(station_id, channel_id)
        return [r["position_x"], r["position_y"], r["position_z"]]

    def get_cable_delay(self, station_id, channel_id):
        return self._one(station_id, channel_id)["cab_time_delay"]

    def get_antenna_type(self, station_id, channel_id):
        return self._one(station_id, channel_id)["antenna_type"]

    get_antenna_model = get_antenna_type

    def get_antenna_orientation(self, station_id, channel_id):
        r = self._one(station_id, channel_id)
        return [r["orientation_theta"], r["orientation_phi"],
                r["rotation_theta"], r["rotation_phi"]]

    def get_amplifier_type(self, station_id, channel_id):
        return self._one(station_id, channel_id)["amp_type"]

    def get_sampling_frequency(self, station_id, channel_id):
        return self._one(station_id, channel_id)["sampling_frequency"]

    def get_number_of_samples(self, station_id, channel_id):
        return self._one(station_id, channel_id)["n_samples"]

    def get_number_of_channels(self, station_id):
        return len(self._channel_rows(station_id))

    # -- buffering into the dict/JSON detector format ------------------------

    def buffer(self):
        """Return the detector description dict (stations/channels keyed
        tables) — the reference's buffer_db (detector_base.py:39-130)."""
        channels, stations = {}, {}
        for i, r in enumerate(self.get_everything_stations()):
            stations[str(i)] = {
                "station_id": r["station_id"],
                "station_type": r["station_type"],
                "pos_easting": r["easting"], "pos_northing": r["northing"],
                "pos_altitude": r["altitude"], "pos_site": r["site"],
                "commission_time": r["commission_time"],
                "decommission_time": r["decommission_time"],
            }
        for i, r in enumerate(self.get_everything_channels()):
            channels[str(i)] = {
                "station_id": r["station_id"],
                "channel_id": r["channel_id"],
                "ant_type": r["antenna_type"],
                "ant_orientation_theta": r["orientation_theta"],
                "ant_orientation_phi": r["orientation_phi"],
                "ant_rotation_theta": r["rotation_theta"],
                "ant_rotation_phi": r["rotation_phi"],
                "ant_position_x": r["position_x"],
                "ant_position_y": r["position_y"],
                "ant_position_z": r["position_z"],
                "cab_time_delay": r["cab_time_delay"],
                "cab_length": r["cable_length"],
                "cab_type": r["cable_type"],
                "amp_type": r["amp_type"],
                "adc_nbits": r["nbits"],
                "adc_n_samples": r["n_samples"],
                "adc_sampling_frequency": r["sampling_frequency"],
                "noise_temperature": r["noise_temperature"],
                "commission_time": r["commission_time"],
                "decommission_time": r["decommission_time"],
            }
        return {"channels": channels, "stations": stations}

    def to_detector(self, default_station=None):
        """Buffer the database and return a ready
        :class:`nuradiomc_tpu_torch.detector.detector.Detector`."""
        from nuradiomc_tpu_torch.detector.detector import Detector
        return Detector(self.buffer(), default_station=default_station)

    def close(self):
        self._conn.close()


def export_detector_to_sql(detector_dict, database):
    """Create/fill a sqlite detector database from a JSON detector dict.

    The inverse of :meth:`SQLDetector.buffer`; channels missing fields
    inherit nothing here (export what is present; the JSON reader's
    GenericDetector defaulting still applies after re-buffering missing
    values as NULL).
    """
    det = SQLDetector(database)
    conn = det._conn
    cur = conn.cursor()

    cur.execute("DELETE FROM stations"); cur.execute("DELETE FROM channels")
    cur.execute("DELETE FROM antennas"); cur.execute("DELETE FROM cables")
    cur.execute("DELETE FROM amps"); cur.execute("DELETE FROM adcs")
    cur.execute("DELETE FROM positions")

    station_uid = {}
    for i, st in enumerate(detector_dict.get("stations", {}).values()):
        pos_key = f"pos_station_{st['station_id']}"
        cur.execute("INSERT INTO positions VALUES (?,?,?,?,?,?,?)",
                    (pos_key, _FAR_PAST,
                     st.get("pos_easting") or 0.0, st.get("pos_northing") or 0.0,
                     st.get("pos_altitude") or 0.0, st.get("pos_zone"),
                     st.get("pos_site")))
        cur.execute(
            "INSERT INTO stations VALUES (?,?,?,?,?,?,?,?,?)",
            (i, st["station_id"],
             _iso(st.get("commission_time")) or _FAR_PAST,
             _iso(st.get("decommission_time")) or _FAR_FUTURE,
             st.get("station_type"), pos_key,
             st.get("board_number"), st.get("MAC_address"),
             st.get("MBED_type")))
        station_uid[int(st["station_id"])] = i

    for i, ch in enumerate(detector_dict.get("channels", {}).values()):
        cur.execute("INSERT INTO antennas VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                    (i, ch.get("ant_type"),
                     ch.get("ant_orientation_theta"), ch.get("ant_orientation_phi"),
                     ch.get("ant_rotation_theta"), ch.get("ant_rotation_phi"),
                     ch.get("ant_position_x"), ch.get("ant_position_y"),
                     ch.get("ant_position_z"),
                     _iso(ch.get("ant_deployment_time")), ch.get("ant_comment")))
        cur.execute("INSERT INTO cables VALUES (?,?,?,?,?,?,?)",
                    (i, ch.get("cab_type"), ch.get("cab_length"),
                     ch.get("cab_reference_measurement"),
                     ch.get("cab_time_delay"), ch.get("cab_id"),
                     ch.get("cab_comment")))
        cur.execute("INSERT INTO amps VALUES (?,?,?)",
                    (i, ch.get("amp_type"), ch.get("amp_reference_measurement")))
        cur.execute("INSERT INTO adcs VALUES (?,?,?,?,?,?,?)",
                    (i, ch.get("adc_id"), ch.get("adc_time_delay"),
                     ch.get("adc_nbits"), ch.get("adc_sampling_frequency"),
                     ch.get("adc_n_samples"), ch.get("noise_temperature")))
        cur.execute("INSERT INTO channels VALUES (?,?,?,?,?,?,?,?,?)",
                    (i, station_uid[int(ch["station_id"])], ch["channel_id"],
                     _iso(ch.get("commission_time")) or _FAR_PAST,
                     _iso(ch.get("decommission_time")) or _FAR_FUTURE,
                     i, i, i, i))

    conn.commit()
    return det
