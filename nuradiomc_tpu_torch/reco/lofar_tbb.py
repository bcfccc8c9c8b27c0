# copied from nuradiomc_tpu/reco/lofar_tbb.py:1-849, the logger renamed (the port keeps its own copy)
"""LOFAR TBB raw-data reader: transient-buffer-board HDF5 (DAL1) files to
framework Events (port).

Counterpart of ``nuradiomc_tpu/reco/lofar_tbb.py``, host I/O as it is: h5py
is imported by the readers, and the traces it reads go to the port's LOFAR
modules (``reco/lofar.py``) on their device.

Format-level re-implementation of the reference's LOFAR raw IO family
(NuRadioReco/modules/io/LOFAR/_rawTBBio.py:189-984,
_rawTBBio_metadata.py, _rawTBBio_utilities.py, readLOFARData.py) with a
batch-first design: instead of the reference's per-antenna ``get_data``
loops, a station's dipoles are read in one pass into a single
``[n_dipoles, n_samples]`` array ready for the vectorized LOFAR pipeline
modules in `reco.lofar` (stationRFIFilter operates on exactly that layout).

TBB DAL1 layout (the interop contract, _rawTBBio.py:209-316):

* file root attrs: ``ANTENNA_SET`` (e.g. ``LBA_OUTER``),
  ``FILTER_SELECTION`` (e.g. ``LBA_10_90``) — both length-1 arrays;
* one ``Station<NAME>`` group per file containing one int16 dataset per
  dipole, named by the 9-digit RCU id (station-id*1e6 + group*1e3 + rcu);
* per-dipole attrs: ``STATION_ID``, ``SAMPLE_FREQUENCY_VALUE`` +
  ``SAMPLE_FREQUENCY_UNIT``, ``TIME`` (POSIX second), ``SAMPLE_NUMBER``
  (sample of that second at which recording started), ``DATA_LENGTH``,
  and optionally ``ANTENNA_POSITION_VALUE`` (ITRF metres) and
  ``DIPOLE_CALIBRATION_DELAY_VALUE`` (seconds).

Like the reference module this file keeps LOFAR-internal units
(seconds / Hz); `readLOFARData` converts to framework units at the
Event boundary.

The reference additionally consults an external StaticMetaData directory
(antenna-position tables, phase-calibration CalTables, clock parsets) that
is not distributed with the code; files that carry their own metadata —
the normal case, _rawTBBio.py:269-272 — need none of it. The
``metadata_dir`` hooks here accept the same directory layout when present.
"""

from __future__ import annotations

import datetime
import glob as _glob
import json
import logging
import math
import os
import re

import numpy as np

from ..framework import event as fw
from ..framework.parameters import showerParameters, stationParameters
from ..utils import units

logger = logging.getLogger("nuradiomc_tpu_torch.lofar_tbb")

# --------------------------------------------------------------------------
# Station id <-> name mapping (_rawTBBio_utilities.py:1-86; the gappy
# numbering IS the interop contract — RCU ids encode the station id)
# --------------------------------------------------------------------------

_CORE = {1: "CS001", 2: "CS002", 3: "CS003", 4: "CS004", 5: "CS005",
         6: "CS006", 7: "CS007", 11: "CS011", 13: "CS013", 17: "CS017",
         21: "CS021", 24: "CS024", 26: "CS026", 28: "CS028", 30: "CS030",
         31: "CS031", 32: "CS032", 101: "CS101", 103: "CS103",
         121: "CS201", 141: "CS301", 142: "CS302", 161: "CS401",
         181: "CS501"}
_REMOTE = {106: "RS106", 125: "RS205", 128: "RS208", 130: "RS210",
           145: "RS305", 146: "RS306", 147: "RS307", 150: "RS310",
           166: "RS406", 167: "RS407", 169: "RS409", 183: "RS503",
           188: "RS508", 189: "RS509"}
_INTERNATIONAL = {201: "DE601", 202: "DE602", 203: "DE603", 204: "DE604",
                  205: "DE605", 206: "FR606", 207: "SE607", 208: "UK608"}

SID_TO_SNAME = {**_CORE, **_REMOTE, **_INTERNATIONAL}
SNAME_TO_SID = {name: sid for sid, name in SID_TO_SNAME.items()}

#: CS002 phase center in ITRF metres and the reference latitude/longitude
#: (deg) defining local "up" (_rawTBBio_metadata.py:314-318; the position is
#: the LOFAR core value from CS002-AntennaField.conf).
CS002_ITRF = np.array([3826577.066, 461022.948, 5064892.786])
CS002_LAT_LON = (52.91512249, 6.869837540)

#: Speed of radio waves in air, m/s (_rawTBBio_utilities.py v_air).
V_AIR = 299792458.0 / 1.000293

_FREQ_UNIT = {"": 1.0, "kHz": 1e3, "MHz": 1e6, "GHz": 1e9, "THz": 1e12}


def _scalar(attr):
    """TBB attrs are length-1 arrays; some writers store plain scalars."""
    a = np.asarray(attr)
    val = a.flat[0] if a.ndim else a[()]
    return val.decode() if isinstance(val, bytes) else val


def even_name_to_odd(even_ant_name):
    """'003001092' -> '003001093' (_rawTBBio_utilities.py:89-93)."""
    return str(int(even_ant_name) + 1).zfill(9)


def ant_name_is_even(ant_name):
    return int(ant_name) % 2 == 0


def convert_itrf_to_local(itrfpos, phase_center=None, ref_lat_lon=None):
    """ITRF metres -> local ENU-like frame about CS002
    (_rawTBBio_metadata.py:291-345): one [3,3] rotation applied to the
    whole antenna batch at once."""
    itrfpos = np.atleast_2d(np.asarray(itrfpos, dtype=np.float64))
    if phase_center is None:
        phase_center = CS002_ITRF
    if ref_lat_lon is None:
        ref_lat_lon = CS002_LAT_LON
    lat, lon = np.deg2rad(ref_lat_lon[0]), np.deg2rad(ref_lat_lon[1])
    rot = np.array([
        [-np.sin(lon), -np.sin(lat) * np.cos(lon), np.cos(lat) * np.cos(lon)],
        [np.cos(lon), -np.sin(lat) * np.sin(lon), np.cos(lat) * np.sin(lon)],
        [0.0, np.cos(lat), np.sin(lat)]])
    return (itrfpos - phase_center) @ rot


# --------------------------------------------------------------------------
# Correction files (plain-text; _rawTBBio.py:95-187)
# --------------------------------------------------------------------------

def read_antenna_pol_flips(fname):
    """One even-antenna name per line."""
    with open(fname) as fin:
        return [line.split()[0] for line in fin if line.strip()]


def read_bad_antennas(fname):
    """Either 'name pol' pairs (v1) or odd/even-encoded names (v2, marked
    by a 'version 2' line); returns [(even_name, pol)]."""
    out = []
    with open(fname) as fin:
        lines = [ln for ln in fin if ln.strip()]
    version = 2 if any("version 2" in ln for ln in lines) else 1
    for line in lines:
        if "version" in line:
            continue
        if version == 1:
            name, pol = line.split()[0:2]
            out.append((name, int(pol)))
        else:
            name = line.split()[0]
            if ant_name_is_even(name):
                out.append((name, 0))
            else:
                out.append((str(int(name) - 1).zfill(9), 1))
    return out


def read_antenna_delays(fname):
    """'even_name even_delay odd_delay' rows -> {even_name: (dE, dO)}."""
    out = {}
    with open(fname) as fin:
        for line in fin:
            parts = line.split()
            if len(parts) >= 3 and not parts[0].startswith("#"):
                out[parts[0]] = (float(parts[1]), float(parts[2]))
    return out


def read_station_delays(fname):
    """'station_name delay' rows -> {name: seconds}."""
    out = {}
    with open(fname) as fin:
        for line in fin:
            parts = line.split()
            if len(parts) >= 2 and not parts[0].startswith("#"):
                out[parts[0]] = float(parts[1])
    return out


def get_clock_corrections(antenna_set="LBA", time=1383264000 - 1000,
                          metadata_dir=None):
    """Static superterp station clock offsets in seconds
    (_rawTBBio_metadata.py:509-588). For LBA data after 1 Nov 2013 the
    reference reads a StationCalibration.parset from the metadata
    directory and applies per-station fine-tuning; that path is kept
    behind ``metadata_dir``."""
    if "LBA" in antenna_set:
        if time < 1383264000:
            cc = {"CS002": 8.32233e-06,
                  "CS003": 6.921444e-06 + 0.35e-9,
                  "CS004": 7.884847e-06 + 1.0e-9,
                  "CS005": 8.537828e-06 + 0.14e-9,
                  "CS006": 7.880705e-06 - 0.24e-9,
                  "CS007": 7.916458e-06 - 0.22e-9,
                  "CS001": 4.755947e-06,
                  "CS011": 7.55500e-06 - 0.3e-9,
                  "CS013": 9.47910e-06,
                  "CS017": 1.540812e-05 - 0.87e-9,
                  "CS021": 6.044335e-06 + 1.12e-9,
                  "CS024": 4.66335e-06 - 1.24e-9,
                  "CS026": 1.620482e-05 - 1.88e-9,
                  "CS028": 1.6967048e-05 + 1.28e-9,
                  "CS030": 9.7110576e-06 + 3.9e-9,
                  "CS031": 6.375533e-06 + 1.87e-9,
                  "CS032": 8.541675e-06 + 1.1e-9,
                  "CS101": 1.5155471e-05,
                  "CS103": 3.5503206e-05,
                  "CS201": 1.745439e-05,
                  "CS301": 7.685249e-06,
                  "CS302": 1.2317004e-05,
                  "CS401": 8.052200e-06,
                  "CS501": 1.65797e-05}
        else:
            cc = _clock_corrections_from_parset(metadata_dir)
            for name, adj in (("CS003", -1.7e-9 + 2.0e-9),
                              ("CS004", -9.5e-9 + 4.2e-9),
                              ("CS005", -6.9e-9 + 0.4e-9),
                              ("CS006", -8.3e-9 + 3.8e-9),
                              ("CS007", -3.6e-9 + 3.4e-9),
                              ("CS011", -18.7e-9 + 0.6e-9)):
                if name in cc:
                    cc[name] += adj
        return cc
    if "HBA" in antenna_set:
        return {"CS001": 4.759754e-06, "CS002": 8.318834e-06,
                "CS003": 6.917926e-06, "CS004": 7.889961e-06,
                "CS005": 8.542093e-06, "CS006": 7.882892e-06,
                "CS007": 7.913020e-06, "CS011": 7.55852e-06,
                "CS013": 9.47910e-06, "CS017": 1.541095e-05,
                "CS021": 6.04963e-06, "CS024": 4.65857e-06,
                "CS026": 1.619948e-05, "CS028": 1.6962571e-05,
                "CS030": 9.7160576e-06, "CS031": 6.370090e-06,
                "CS032": 8.546255e-06, "CS101": 1.5157971e-05,
                "CS103": 3.5500922e-05, "CS201": 1.744924e-05,
                "CS301": 7.690431e-06, "CS302": 1.2321604e-05,
                "CS401": 8.057504e-06, "CS501": 1.65842e-05}
    raise ValueError(f"no clock offsets for antenna set {antenna_set}")


def _clock_corrections_from_parset(metadata_dir):
    """StationCalibration.parset LBA_OUTER/LBA_30_90 delays, averaged over
    X/Y polarisations (_rawTBBio_metadata.py:468-506)."""
    if metadata_dir is None:
        raise FileNotFoundError(
            "post-2013 LOFAR clock corrections need a metadata_dir with "
            "lofar/station_clock_offsets/StationCalibration.parset "
            "(_rawTBBio_metadata.py:468); pass metadata_dir= or use "
            "station_delays= directly")
    fname = os.path.join(metadata_dir, "lofar", "station_clock_offsets",
                         "StationCalibration.parset")
    x, y = {}, {}
    with open(fname) as fin:
        for line in fin:
            if "=" not in line:
                continue
            key, value = line.split("=")
            params = key.split(".")
            station, aset, filt, vtype, pol = (params[2][0:5], params[3],
                                               params[4], params[5],
                                               params[6][0])
            if aset == "LBA_OUTER" and filt == "LBA_30_90" \
                    and vtype == "delay":
                (x if pol == "X" else y)[station] = float(value)
    return {k: 0.5 * (x[k] + y[k]) for k in x if k in y}


def convert_phase_to_timing(phase_calibration, sample_time=5.0e-9):
    """512-subband phase calibration -> per-antenna delay in seconds
    (_rawTBBio_metadata.py:454-464)."""
    phases = np.angle(phase_calibration)
    return (phases[:, 1] - phases[:, 0]) * (1024 / (2 * np.pi)) * sample_time


# --------------------------------------------------------------------------
# Single-file reader (TBBData_Dal1, _rawTBBio.py:189-445)
# --------------------------------------------------------------------------

class TBBFile:
    """One station from one TBB HDF5 file."""

    def __init__(self, filename, metadata_dir=None):
        import h5py

        self.filename = filename
        self.metadata_dir = metadata_dir
        self.file = h5py.File(filename, "r")

        station_keys = [s for s in self.file if s.startswith("Station")]
        if len(station_keys) != 1:
            logger.warning("%s holds %d stations; using the first",
                           filename, len(station_keys))
        self.station_key = station_keys[0]
        grp = self.file[self.station_key]

        self.antenna_set = _scalar(self.file.attrs["ANTENNA_SET"])
        self.filter_selection = _scalar(self.file.attrs["FILTER_SELECTION"])
        self.dipole_names = list(grp.keys())
        d0 = grp[self.dipole_names[0]]
        self.station_id = int(_scalar(d0.attrs["STATION_ID"]))
        self.station_name = SID_TO_SNAME[self.station_id]
        self.sample_frequency = (
            float(_scalar(d0.attrs["SAMPLE_FREQUENCY_VALUE"]))
            * _FREQ_UNIT[_scalar(d0.attrs["SAMPLE_FREQUENCY_UNIT"])])

        # all dipoles must share the trigger second; start sample varies
        times = np.array([int(_scalar(grp[d].attrs["TIME"]))
                          for d in self.dipole_names])
        if not (times == times[0]).all():
            raise IOError(f"antennas do not start at the same second "
                          f"in {filename}")
        self.time = int(times[0])
        self.data_lengths = np.array(
            [int(_scalar(grp[d].attrs["DATA_LENGTH"]))
             for d in self.dipole_names])
        self.sample_numbers = np.array(
            [int(_scalar(grp[d].attrs["SAMPLE_NUMBER"]))
             for d in self.dipole_names])

        self.have_metadata = \
            "DIPOLE_CALIBRATION_DELAY_VALUE" in d0.attrs
        if "ANTENNA_POSITION_VALUE" in d0.attrs:
            self.itrf_positions = np.array(
                [np.asarray(grp[d].attrs["ANTENNA_POSITION_VALUE"],
                            dtype=np.float64).reshape(3)
                 for d in self.dipole_names])
        else:
            self.itrf_positions = self._metadata_positions()
        self.calibration_delays = np.array(
            [float(_scalar(grp[d].attrs["DIPOLE_CALIBRATION_DELAY_VALUE"]))
             if self.have_metadata else 0.0 for d in self.dipole_names])

        self.nominal_sample_number = int(np.max(self.sample_numbers))
        self.sample_offsets = self.nominal_sample_number - self.sample_numbers
        self.nominal_data_lengths = self.data_lengths - self.sample_offsets

    def _metadata_positions(self):
        """Fallback ITRF positions from a StaticMetaData AntennaFields
        table when the writer 'forgot' them (_rawTBBio.py:42-43,277)."""
        if self.metadata_dir is None:
            raise FileNotFoundError(
                f"{self.filename} carries no ANTENNA_POSITION_VALUE and no "
                "metadata_dir was given (reference behavior: read "
                "StaticMetaData/AntennaFields, _rawTBBio_metadata.py:91)")
        fname = os.path.join(self.metadata_dir, "lofar", "StaticMetaData",
                             "AntennaFields",
                             f"{self.station_name}-AntennaField.conf")
        raise FileNotFoundError(
            f"AntennaFields parsing requires the LOFAR StaticMetaData "
            f"distribution ({fname})")

    def close(self):
        self.file.close()

    close_file = close  # reference-compatible alias

    def get_data(self, start_index, num_points, antenna_index=None,
                 antenna_ID=None):
        """Raw int16 samples; index 0 is the nominal (aligned) start
        (_rawTBBio.py:418-445)."""
        if antenna_index is None:
            antenna_index = self.dipole_names.index(antenna_ID)
        name = self.dipole_names[antenna_index]
        initial = self.sample_offsets[antenna_index] + start_index
        ds = self.file[self.station_key][name]
        if initial + num_points > len(ds):
            raise IndexError(f"data point {initial + num_points} is off the "
                             f"end of {name} (length {len(ds)})")
        return ds[initial:initial + num_points]


# --------------------------------------------------------------------------
# Multi-file station view (MultiFile_Dal1, _rawTBBio.py:448-984)
# --------------------------------------------------------------------------

class TBBStation:
    """One station assembled from its TBB files: polarization pairing,
    bad-antenna masking, polarization flips, sample alignment, and a
    batched trace read."""

    def __init__(self, filenames, metadata_dir=None,
                 polarization_flips=None, bad_antennas=None,
                 additional_ant_delays=None, station_delay=0.0,
                 only_complete_pairs=True):
        if isinstance(filenames, str):
            filenames = [filenames]
        self.files = [TBBFile(f, metadata_dir) for f in filenames]
        self.metadata_dir = metadata_dir

        if isinstance(polarization_flips, str):
            polarization_flips = read_antenna_pol_flips(polarization_flips)
        if isinstance(bad_antennas, str):
            bad_antennas = read_bad_antennas(bad_antennas)
        if isinstance(additional_ant_delays, str):
            additional_ant_delays = read_antenna_delays(additional_ant_delays)
        bad_antennas = list(bad_antennas or [])

        first = self.files[0]
        for f in self.files[1:]:
            for attr in ("antenna_set", "station_id", "filter_selection",
                         "time"):
                if getattr(f, attr) != getattr(first, attr):
                    raise IOError(
                        f"{attr} differs between files of station "
                        f"{first.station_name}")
        self.antenna_set = first.antenna_set
        self.station_id = first.station_id
        self.station_name = first.station_name
        self.sample_frequency = first.sample_frequency
        self.filter_selection = first.filter_selection
        self.time = first.time
        self.station_delay = (
            read_station_delays(station_delay)[self.station_name]
            if isinstance(station_delay, str) else station_delay)
        self.odd_pol_additional_timing_delay = 0.0

        # pair even/odd dipoles across files (_rawTBBio.py:570-661)
        bad_even = {a for a, p in bad_antennas if p == 0}
        bad_odd = {a for a, p in bad_antennas if p == 1}  # even NAME, odd bad
        available = {}       # name -> (file, index-in-file)
        for f in self.files:
            for i, name in enumerate(f.dipole_names):
                available.setdefault(name, (f, i))

        self.dipole_names, self.antenna_to_file = [], []
        for name in sorted(available):
            if not ant_name_is_even(name):
                continue
            odd = even_name_to_odd(name)
            even_ok = name not in bad_even and name in available
            odd_ok = name not in bad_odd and odd in available
            if even_ok and odd_ok:
                self.dipole_names += [name, odd]
                self.antenna_to_file += [available[name], available[odd]]
            elif not only_complete_pairs:
                if even_ok:
                    self.dipole_names += [name, odd]
                    self.antenna_to_file += [available[name], None]
                elif odd_ok:
                    self.dipole_names += [name, odd]
                    self.antenna_to_file += [None, available[odd]]
        # odd dipoles whose even partner never appears in any file
        if not only_complete_pairs:
            for name in sorted(available):
                if ant_name_is_even(name) or name in self.dipole_names:
                    continue
                even = str(int(name) - 1).zfill(9)
                if even in available or even in bad_even or name in bad_odd:
                    continue
                self.dipole_names += [even, name]
                self.antenna_to_file += [None, available[name]]

        self.index_adjusts = np.arange(len(self.dipole_names))
        self.even_ant_pol_flips = []
        if polarization_flips:
            self.set_polarization_flips(polarization_flips)
        self.additional_ant_delays = additional_ant_delays

        def _per_antenna(attr):
            return np.array([getattr(tf[0], attr)[tf[1]]
                             if tf is not None else 0
                             for tf in self.antenna_to_file], dtype=int)

        self.sample_numbers = _per_antenna("sample_numbers")
        self.data_lengths = _per_antenna("data_lengths")
        self.nominal_sample_number = int(np.max(self.sample_numbers)) \
            if len(self.sample_numbers) else 0
        self.sample_offsets = self.nominal_sample_number - self.sample_numbers
        self.nominal_data_lengths = self.data_lengths - self.sample_offsets

    # -- mutators ----------------------------------------------------------
    def set_polarization_flips(self, even_antenna_names):
        """Swap data locations of even/odd dipoles for flipped antennas
        (_rawTBBio.py:687-695)."""
        self.even_ant_pol_flips = list(even_antenna_names)
        for name in even_antenna_names:
            if name in self.dipole_names:
                i = self.dipole_names.index(name)
                self.index_adjusts[i] += 1
                self.index_adjusts[i + 1] -= 1

    def set_odd_polarization_delay(self, new_delay):
        self.odd_pol_additional_timing_delay = new_delay

    # -- getters (reference-compatible names where they matter) ------------
    def get_antenna_names(self):
        return self.dipole_names

    def get_nominal_sample_number(self):
        return self.nominal_sample_number

    def get_all_sample_numbers(self):
        return self.sample_numbers

    def get_full_data_lengths(self):
        return self.data_lengths

    def get_timestamp(self):
        return self.time

    def get_timestamp_as_datetime(self):
        return datetime.datetime.fromtimestamp(
            self.time, tz=datetime.timezone.utc)

    def get_itrf_antenna_positions(self):
        out = np.zeros((len(self.dipole_names), 3))
        for i, tf in enumerate(self.antenna_to_file):
            if tf is not None:
                out[i] = tf[0].itrf_positions[tf[1]]
        return out

    def get_lofar_centered_positions(self):
        """Positions relative to CS002 (local frame), [n_dipoles, 3]."""
        return convert_itrf_to_local(self.get_itrf_antenna_positions())

    def get_timing_calibration_delays(self, force_file_delays=False):
        """Per-dipole calibration delay in seconds, polarization flips and
        additional per-antenna/odd-pol delays applied
        (_rawTBBio.py:862-900)."""
        out = np.zeros(len(self.dipole_names))
        for i, adjust in enumerate(self.index_adjusts):
            tf = self.antenna_to_file[adjust]
            if tf is not None:
                out[i] = tf[0].calibration_delays[tf[1]]
            if self.additional_ant_delays:
                pol = i % 2
                even_name = self.dipole_names[i - pol]
                if even_name in self.additional_ant_delays:
                    if even_name in self.even_ant_pol_flips:
                        pol = 1 - pol
                    out[i] += self.additional_ant_delays[even_name][pol]
        out[1::2] += self.odd_pol_additional_timing_delay
        return out

    def get_total_delays(self):
        """Calibration + station clock - trigger alignment, seconds
        (_rawTBBio.py:902-914)."""
        return (self.get_timing_calibration_delays() + self.station_delay
                - self.nominal_sample_number / self.sample_frequency)

    def get_geometric_delays(self, source_location, antenna_locations=None):
        """Air travel time (s) from an XYZ point to each antenna, batched
        (_rawTBBio.py:923-949)."""
        if antenna_locations is None:
            antenna_locations = self.get_lofar_centered_positions()
        return np.linalg.norm(
            antenna_locations - np.asarray(source_location), axis=-1) / V_AIR

    def has_antenna(self, antenna_name):
        if antenna_name not in self.dipole_names:
            return False
        idx = self.index_adjusts[self.dipole_names.index(antenna_name)]
        return self.antenna_to_file[idx] is not None

    def get_data(self, start_index, num_points, antenna_index=None,
                 antenna_ID=None):
        """Raw int16 samples for one dipole, aligned to the nominal start."""
        if antenna_index is None:
            antenna_index = self.dipole_names.index(antenna_ID)
        antenna_index = self.index_adjusts[antenna_index]
        tf = self.antenna_to_file[antenna_index]
        if tf is None:
            raise LookupError("no data for this antenna")
        tbb_file, file_index = tf
        name = self.dipole_names[antenna_index]
        initial = self.sample_offsets[antenna_index] + start_index
        ds = tbb_file.file[tbb_file.station_key][name]
        if initial + num_points > len(ds):
            raise IndexError(f"data point {initial + num_points} is off the "
                             f"end of {name} (length {len(ds)})")
        return ds[initial:initial + num_points]

    def get_all_data(self, start_index, num_points):
        """Batched read: ``(traces [n_dipoles, num_points] float64, ok
        mask)`` — dipoles whose window falls off the recorded range get
        ``ok=False`` and zeros rather than raising, so one pass suffices
        for the whole station."""
        n = len(self.dipole_names)
        out = np.zeros((n, num_points))
        ok = np.zeros(n, dtype=bool)
        for i in range(n):
            try:
                out[i] = self.get_data(start_index, num_points,
                                       antenna_index=i)
                ok[i] = True
            except (LookupError, IndexError):
                pass
        return out, ok

    def close(self):
        for f in self.files:
            f.close()

    close_file = close


# --------------------------------------------------------------------------
# Event-building helpers (readLOFARData.py:89-266)
# --------------------------------------------------------------------------

def lora_timestamp_to_blocknumber(lora_seconds, lora_nanoseconds, start_time,
                                  sample_number,
                                  clock_offset=1e4 * units.ns,
                                  block_size=2 ** 16,
                                  sampling_frequency=200 * units.MHz):
    """(block index, sample within block) of a LORA trigger timestamp
    (readLOFARData.py:89-135). Framework units throughout."""
    lora_samplenumber = ((lora_nanoseconds - clock_offset / units.ns)
                         * sampling_frequency / units.MHz * 1e-3)
    value = (lora_samplenumber - sample_number
             + (lora_seconds - start_time) * (sampling_frequency / units.Hz))
    if value < 0:
        raise ValueError("event not in file")
    return int(value / block_size), int(value % block_size)


def lofar_event_id_to_unix(event_id):
    """Event ids count seconds since 2010-01-01 (readLOFARData.py:138)."""
    return event_id + 1262304000


def tbb_filetag_from_unix(timestamp):
    """'D20230414T120846' style tag in TBB filenames
    (readLOFARData.py:143-185)."""
    dt = datetime.datetime.fromtimestamp(int(timestamp),
                                         tz=datetime.timezone.utc)
    return (f"D{dt.year}{dt.month:02d}{dt.day:02d}"
            f"T{dt.hour:02d}{dt.minute:02d}{dt.second:02d}")


def tbbid_to_nrrid(channel_id, mode):
    """TBB channel id -> NRR detector channel id: LBA_INNER antennas carry
    a '9' as the 4th digit in the LOFAR.json convention
    (readLOFARData.py:188-234)."""
    cid = str(channel_id).zfill(9) if isinstance(channel_id, int) \
        else channel_id
    if mode.lower() == "lba_outer":
        return cid[:3] + "0" + cid[4:]
    if mode.lower() == "lba_inner":
        return cid[:3] + "9" + cid[4:]
    logger.warning("%s is not a valid antenna mode", mode)
    return cid


def nrrid_to_tbbid(channel_id):
    cid = str(channel_id).zfill(9) if isinstance(channel_id, int) \
        else channel_id
    return cid[:3] + "0" + cid[4:]


class getLOFARtraces:
    """Windowed trace extraction around a LORA trigger
    (readLOFARData.py:269-431)."""

    def __init__(self, tbb_h5_filename, metadata_dir, time_unix, time_ns,
                 trace_length_nbins, station_delay=0.0):
        self.tbb_file = TBBStation(tbb_h5_filename, metadata_dir,
                                   station_delay=station_delay)
        self.trace_length_nbins = trace_length_nbins

        sample_number = self.tbb_file.get_nominal_sample_number()
        timestamp = self.tbb_file.get_timestamp()
        try:
            offsets = get_clock_corrections(metadata_dir=metadata_dir,
                                            time=timestamp)
            clock_offset = offsets[self.tbb_file.station_name] * units.s
        except (FileNotFoundError, KeyError):
            clock_offset = 1e4 * units.ns
            logger.warning("no clock correction for %s; using 1e4 ns",
                           self.tbb_file.station_name)
        self.block_number, self.sample_number_in_block = \
            lora_timestamp_to_blocknumber(
                time_unix, time_ns, timestamp, sample_number,
                clock_offset=clock_offset,
                block_size=trace_length_nbins)
        self.alignment_shift = -(trace_length_nbins // 2
                                 - self.sample_number_in_block)

    def check_trace_quality(self):
        """(deviating dipoles, dipoles missing their counterpart) — the
        three start/length criteria of readLOFARData.py:338-400."""
        names = np.array(self.tbb_file.get_antenna_names())
        sample_number = self.tbb_file.get_all_sample_numbers()
        data_length = self.tbb_file.get_full_data_lengths()
        med_sn = np.median(sample_number)
        med_dl = np.median(data_length)
        deviating = (np.abs(sample_number - med_sn) > med_dl / 4) \
            | (sample_number > med_sn) \
            | (np.abs(data_length - med_dl) > med_dl / 10)
        dipoles = np.array([int(x) % 100 for x in names])
        missing = np.array([(d + (1 - 2 * (d % 2))) not in dipoles
                            for d in dipoles])
        return set(names[deviating]), set(names[missing])

    def get_trace(self, dipole_id):
        start = (self.trace_length_nbins * self.block_number
                 + self.alignment_shift)
        return self.tbb_file.get_data(start, self.trace_length_nbins,
                                      antenna_ID=dipole_id)

    def get_all_traces(self):
        """Batched variant: (names, traces [n, L], ok mask)."""
        start = (self.trace_length_nbins * self.block_number
                 + self.alignment_shift)
        traces, ok = self.tbb_file.get_all_data(start,
                                                self.trace_length_nbins)
        return self.tbb_file.get_antenna_names(), traces, ok

    def close_file(self):
        self.tbb_file.close()


class readLOFARData:
    """TBB + LORA -> framework Event (readLOFARData.py:434-810).

    Parameters mirror the reference: a TBB directory that is globbed by
    event tag, a LORA json directory, and the optional static-metadata
    directory. Station clock delays may also be passed directly
    (``station_delays={name: seconds}``) which sidesteps the metadata
    distribution entirely.
    """

    def __init__(self, restricted_station_set=None, tbb_directory=None,
                 json_directory=None, metadata_directory=None,
                 station_delays=None):
        self.tbb_dir = tbb_directory
        self.json_dir = json_directory
        self.meta_dir = metadata_directory
        self.station_delays = station_delays or {}
        self._restricted = restricted_station_set
        self._event_id = None
        self._stations = {}
        self._lora_timestamp = None
        self._lora_timestamp_ns = None
        self._hybrid_shower = None

    def get_stations(self):
        return dict(self._stations)

    def begin(self, event_id, logger_level=logging.NOTSET):
        """Locate the event's TBB files and LORA parameters
        (readLOFARData.py:567-650)."""
        if logger_level:
            logger.setLevel(logger_level)
        self._event_id = int(event_id)
        self._stations = {}

        with open(os.path.join(self.json_dir,
                               f"{self._event_id}.json")) as f:
            lora = json.load(f)["LORA"]
        self._lora_timestamp = lora["utc_time_stamp"]
        self._lora_timestamp_ns = lora["time_stamp_ns"]
        if self._lora_timestamp != lofar_event_id_to_unix(self._event_id):
            logger.error("LORA timestamp %s does not match event id %s",
                         self._lora_timestamp, self._event_id)

        shower = fw.HybridShower("LORA")
        shower.set_parameter(showerParameters.magnetic_field_vector,
                             np.array([0.004675, 0.186270, -0.456412]))
        shower.set_parameter(
            showerParameters.zenith,
            math.remainder(lora["zenith_rad"], 2 * np.pi) * units.radian)
        shower.set_parameter(
            showerParameters.azimuth,
            math.remainder(lora["azimuth_rad"], 2 * np.pi) * units.radian)
        shower.set_parameter(showerParameters.core, np.array(
            [lora["core_x_m"] * units.m, lora["core_y_m"] * units.m,
             7.6 * units.m]))
        shower.set_parameter(showerParameters.energy,
                             lora["energy_GeV"] * units.GeV)
        self._hybrid_shower = shower

        tag = tbb_filetag_from_unix(self._lora_timestamp)
        for fname in sorted(_glob.glob(
                os.path.join(self.tbb_dir, f"*{tag}*.h5"))):
            m = re.findall(r"CS\d\d\d", os.path.basename(fname))
            name = next(iter(m), None)
            if name is None:
                logger.info("%s is a remote station; skipping", fname)
                continue
            if self._restricted and name not in self._restricted:
                continue
            self._stations.setdefault(name, {"files": []})
            self._stations[name]["files"].append(fname)

    def run(self, detector, trace_length=65536):
        """Yield one Event holding every station's calibrated voltage
        traces (readLOFARData.py:652-807)."""
        evt = fw.Event(1, self._event_id)
        evt.get_hybrid_information().add_hybrid_shower(self._hybrid_shower)

        for name, info in self._stations.items():
            if not info["files"]:
                continue
            station_id = int(name[2:])
            loader = getLOFARtraces(
                info["files"], self.meta_dir, self._lora_timestamp,
                self._lora_timestamp_ns, trace_length,
                station_delay=self.station_delays.get(name, 0.0))
            tbb = loader.tbb_file
            antenna_set = tbb.antenna_set
            fs = tbb.sample_frequency * units.Hz
            cal_delays = dict(zip(
                (int(tbbid_to_nrrid(d, antenna_set))
                 for d in tbb.get_antenna_names()),
                tbb.get_timing_calibration_delays() * units.s))

            deviating, missing = loader.check_trace_quality()
            names, traces, ok = loader.get_all_traces()

            station = fw.Station(station_id)
            flagged = {}
            flagged_groups = set()
            kept = []
            for i, tbb_id in enumerate(names):
                cid = int(tbbid_to_nrrid(tbb_id, antenna_set))
                if tbb_id in deviating:
                    flagged.setdefault(cid, []).append(
                        "reader_deviating_channel")
                elif tbb_id in missing:
                    flagged.setdefault(cid, []).append(
                        "reader_channel_missing_counterpart")
                elif not ok[i]:
                    flagged.setdefault(cid, []).append("reader_trace_error")
                else:
                    kept.append((i, cid))
                    continue
                flagged_groups.add(
                    detector.get_channel_group_id(station_id, cid))

            for i, cid in kept:
                group = detector.get_channel_group_id(station_id, cid)
                if group in flagged_groups:
                    flagged.setdefault(cid, []).append(
                        "reader_removed_group_id")
                    continue
                ch = fw.Channel(cid, channel_group_id=group)
                ch.set_trace(traces[i], fs)
                ch.apply_time_shift(-cal_delays[cid])
                station.add_channel(ch)

            station.set_parameter(stationParameters.flagged_channels,
                                  flagged)
            evt.set_station(station)
            loader.close_file()

        shower = fw.Shower(shower_id=evt.get_id())
        shower.set_parameter(showerParameters.observation_level,
                             760 * units.cm)
        from .advanced import MAGNETIC_FIELD_VECTORS
        shower.set_parameter(showerParameters.magnetic_field_vector,
                             MAGNETIC_FIELD_VECTORS["lofar"])
        evt.add_shower(shower)
        yield evt

    def end(self):
        pass
