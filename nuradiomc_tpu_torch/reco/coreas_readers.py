"""CoREAS reader modules: per-observer events, per-shower events, and
detector-folded interpolated events (port).

Counterpart of ``nuradiomc_tpu/reco/coreas_readers.py``
(NuRadioReco/modules/io/coreas/readCoREASStation.py,
readCoREASShower.py:13-170, readCoREASDetector.py:24-312,
simulationSelector.py:9-99). The readers build framework Event objects on the
host; :class:`readCoREASDetector` interpolates the star-shape observers onto
every requested core and channel group in one batch on its device (the
interpolation weights from scipy on the host, the gather, scale and Hann
window of the pulses on the device) and takes a CoREAS file or an
h5py-shaped mapping of one (``sim.io_coreas.coreas_event``).
:class:`readCoREASStation` and :class:`readCoREASShower` read files (h5py).
"""

from __future__ import annotations

import collections
import copy
import os

import numpy as np

import torch

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.framework.event import Event, SimStation, Station
from nuradiomc_tpu_torch.reco.base import (Module, host, register_run, rows_per_chunk,
                                           spectrum_tensor)
from nuradiomc_tpu_torch.reco.channel_processing import half_hann_window
from nuradiomc_tpu_torch.sim import io_coreas
from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils import units

# copied from nuradiomc_tpu/reco/coreas_readers.py:28-207 (the detector reader
# windows all of its pulses in one batch; apply_hanning windows one efield)
efp = par.electricFieldParameters
shp = par.showerParameters
stnp = par.stationParameters

# a CoREAS HDF5 below this size is observed to be corrupt
# (readCoREASShower.py:86)
_MIN_FILESIZE = 18456 * 2


def get_random_core_positions(xmin, xmax, ymin, ymax, n_cores, seed=None):
    """Uniform random 2D core positions in a rectangle
    (readCoREASDetector.get_random_core_positions:24-56)."""
    rng = np.random.RandomState(seed)
    return np.array([rng.uniform(xmin, xmax, n_cores),
                     rng.uniform(ymin, ymax, n_cores)]).T


def apply_hanning(efield):
    """Half-Hann window (10%) along the time axis of a (n_samples, n_pol)
    efield, a tensor on its device or a numpy array
    (readCoREASDetector.apply_hanning:59-78)."""
    window = half_hann_window(efield.shape[0], half_percent=0.1)
    if isinstance(efield, torch.Tensor):
        window = torch.as_tensor(window, dtype=efield.dtype, device=efield.device)
    return efield * window[:, None]


def select_channels_per_station(det, station_id, requested_channel_ids):
    """Group the requested channel ids of one station by channel group id
    (readCoREASDetector.select_channels_per_station:81-105)."""
    channel_ids = collections.defaultdict(list)
    for channel_id in requested_channel_ids:
        if channel_id in det.get_channel_ids(station_id):
            group = det.get_channel_group_id(station_id, channel_id)
            channel_ids[group].append(channel_id)
    return channel_ids


class readCoREASStation:
    """One simulated event per CoREAS observer, each placed at the position
    of a single detector station (readCoREASStation.py:12-119). Useful for
    per-efield studies (fluence vs SNR, polarization)."""

    def begin(self, input_files, station_id, debug=False, site="summit"):
        self.__input_files = list(input_files)
        self.__station_id = station_id
        self.__site = site
        self.__current_input_file = 0
        self.__current_event = 0

    def run(self, detector):
        for input_file in self.__input_files:
            self.__current_event = 0
            corsika_evt = io_coreas.read_CORSIKA7(input_file)
            coreas_sim_station = corsika_evt.get_station(0).get_sim_station()
            corsika_efields = coreas_sim_station.get_electric_fields()
            coreas_shower = corsika_evt.get_first_sim_shower()

            efield_pos = np.array([ef.get_position() for ef in corsika_efields])
            weights = io_coreas.calculate_simulation_weights(
                efield_pos, coreas_shower[shp.zenith],
                coreas_shower[shp.azimuth], site=self.__site)

            for i, corsika_efield in enumerate(corsika_efields):
                evt = Event(self.__current_input_file, self.__current_event)
                station = Station(self.__station_id)
                sim_station = io_coreas.create_sim_station(
                    self.__station_id, corsika_evt, weights[i])

                channel_ids = detector.get_channel_ids(self.__station_id)
                efield_trace = np.asarray(corsika_efield.get_trace())
                fs = corsika_efield.get_sampling_rate()

                # prepend zeros so the pulse is not at the trace start
                # (readCoREASStation.py:87-95)
                n_prepend = efield_trace.shape[1]
                efield_cor = np.concatenate(
                    [np.zeros((3, n_prepend)), efield_trace], axis=1)
                t0 = 0.0

                io_coreas.add_electric_field_to_sim_station(
                    sim_station, list(channel_ids), efield_cor, t0,
                    sim_station[stnp.zenith], sim_station[stnp.azimuth], fs)
                station.set_sim_station(sim_station)

                # shift the core so this observer lands on the station
                station_position = detector.get_absolute_position(self.__station_id)
                observer_position = corsika_efield.get_position()
                sim_shower = io_coreas.create_sim_shower(
                    corsika_evt, core_shift=station_position - observer_position)

                evt.add_sim_shower(sim_shower)
                evt.set_station(station)
                self.__current_event += 1
                yield evt
            self.__current_input_file += 1

    def end(self):
        pass


class readCoREASShower:
    """One event per CoREAS file with every simulated observer as its own
    station (readCoREASShower.py:13-170) — the natural input for air-shower
    array studies (Auger/LOFAR/SKA)."""

    def begin(self, input_files, det=None, set_ascending_run_and_event_number=False):
        self.__input_files = list(input_files)
        self.__current_input_file = 0
        self.__det = det
        self.__ascending = 1 if set_ascending_run_and_event_number else 0

    def run(self, declination=0.0):
        while self.__current_input_file < len(self.__input_files):
            filename = self.__input_files[self.__current_input_file]
            if os.path.getsize(filename) < _MIN_FILESIZE:
                self.__current_input_file += 1
                continue

            corsika_evt = io_coreas.read_CORSIKA7(filename, declination=declination)

            if self.__ascending:
                evt = Event(self.__ascending, self.__ascending)
                self.__ascending += 1
            else:
                evt = Event(corsika_evt.get_run_number(), corsika_evt.get_id())

            sim_shower = io_coreas.create_sim_shower(corsika_evt)
            evt.set_event_time(corsika_evt.get_event_time())
            evt.add_sim_shower(sim_shower)

            corsika_efields = corsika_evt.get_station(0).get_sim_station() \
                .get_electric_fields()
            for station_id, corsika_efield in enumerate(corsika_efields):
                station = Station(station_id)
                sim_station = io_coreas.create_sim_station(station_id, corsika_evt)
                efield_trace = np.asarray(corsika_efield.get_trace())
                fs = corsika_efield.get_sampling_rate()
                t0 = corsika_efield.get_trace_start_time()

                if self.__det is None:
                    channel_ids = [0, 1]
                elif self.__det.has_station(station_id):
                    channel_ids = self.__det.get_channel_ids(station_id)
                else:
                    channel_ids = self.__det.get_channel_ids(
                        self.__det.get_reference_station_ids()[0])

                io_coreas.add_electric_field_to_sim_station(
                    sim_station, list(channel_ids), efield_trace, t0,
                    sim_shower[shp.zenith], sim_shower[shp.azimuth], fs)
                station.set_sim_station(sim_station)
                evt.set_station(station)

                if self.__det is not None:
                    efield_pos = corsika_efield.get_position()
                    if not self.__det.has_station(station_id):
                        self.__det.add_generic_station({
                            "station_id": station_id,
                            "pos_easting": efield_pos[0],
                            "pos_northing": efield_pos[1],
                            "pos_altitude": efield_pos[2],
                            "reference_station":
                                self.__det.get_reference_station_ids()[0],
                        })
                    else:
                        self.__det.add_station_properties_for_event({
                            "pos_easting": efield_pos[0],
                            "pos_northing": efield_pos[1],
                            "pos_altitude": efield_pos[2],
                        }, station_id, evt.get_run_number(), evt.get_id())

            self.__current_input_file += 1
            if self.__det is None:
                yield evt
            else:
                self.__det.set_event(evt.get_run_number(), evt.get_id())
                yield evt, self.__det

    def end(self):
        pass


class readCoREASDetector(Module):
    """Interpolate the star-shape observers of ONE CoREAS file onto the
    antenna positions of a detector for a list of core positions
    (readCoREASDetector.py:108-312) — the default CR-input module. The
    (core, station, channel group) pulses of a chunk of cores (as many as
    ``rows_per_chunk`` allows, kept as ``last_chunk``) are one batch on the
    module's device."""

    def __init__(self, device=device_util.DEFAULT):
        super().__init__(device)
        self.__corsika_evt = None
        self.coreas_interpolator = None

    def begin(self, input_file, interp_lowfreq=30 * units.MHz,
              interp_highfreq=1000 * units.MHz, declination=0.0):
        """``input_file``: a CoREAS HDF5 path (needs h5py) or an h5py-shaped
        mapping of one (``convert.make_coreas_star``)."""
        self.__corsika_evt = io_coreas.read_coreas(input_file, declination=declination)
        self.coreas_interpolator = io_coreas.coreasInterpolator(self.__corsika_evt)
        self.coreas_interpolator.initialize_efield_interpolator(
            interp_lowfreq, interp_highfreq)

    def run(self, detector, core_position_list, selected_station_channel_ids=None):
        if selected_station_channel_ids is None:
            selected_station_channel_ids = {
                sid: None for sid in detector.get_station_ids()}
        selected_station_ids = list(selected_station_channel_ids.keys())

        corsika_sim_stn = self.__corsika_evt.get_station(0).get_sim_station()

        # (station, channel group ids, relative position) of every group
        layout = []
        for station_id in selected_station_ids:
            det_station_position = detector.get_absolute_position(station_id)
            if selected_station_channel_ids[station_id] is None:
                selected_channel_ids = detector.get_channel_ids(station_id)
            else:
                selected_channel_ids = selected_station_channel_ids[station_id]
            groups = select_channels_per_station(
                detector, station_id, selected_channel_ids)
            for _, channel_ids_for_group in groups.items():
                antenna_position_rel = detector.get_relative_position(
                    station_id, channel_ids_for_group[0])
                layout.append((station_id, channel_ids_for_group, antenna_position_rel,
                               det_station_position + antenna_position_rel))
        cores = [np.asarray(core, dtype=float) for core in core_position_list]
        n = len(self.coreas_interpolator._efields[0].get_trace()[0])
        window = half_hann_window(n, half_percent=0.1)
        # the pulses of a chunk of cores in one batch, its events yielded
        # before the next chunk is made: memory stays bounded in the core list
        per_core = max(len(layout), 1) * 3 * n * 8 * 3
        self.last_chunk = rows_per_chunk(per_core, self.device, max(len(cores), 1))
        for first in range(0, len(cores), self.last_chunk):
            chunk = cores[first:first + self.last_chunk]
            queries = [pos[:len(core)] - core for core in chunk for *_, pos in layout]
            if queries:
                traces, starts = self.coreas_interpolator.get_interp_efields(
                    queries, window, device=self.device)
                traces = host(traces)
            for c, core in enumerate(chunk):
                yield self._event(first + c, core, layout, selected_station_ids,
                                  corsika_sim_stn, traces[c * len(layout):],
                                  starts[c * len(layout):])

    def _event(self, iCore, core, layout, selected_station_ids, corsika_sim_stn,
               traces, starts):
        """The event of one core, its groups' efields ``traces`` [len(layout),
        3, n] starting at ``starts``."""
        evt = Event(self.__corsika_evt.get_run_number(), iCore)
        sim_shower = copy.deepcopy(self.__corsika_evt.get_first_sim_shower())
        new_core = np.array(sim_shower[shp.core]
                            if shp.core in sim_shower.get_parameters()
                            else np.zeros(3), dtype=float)
        new_core[:len(core)] = core
        sim_shower[shp.core] = new_core
        evt.add_sim_shower(sim_shower)

        sim_stations = {}
        for station_id in selected_station_ids:
            sim_station = SimStation(station_id)
            for key, value in corsika_sim_stn.get_parameters().items():
                sim_station[key] = value
            sim_station.set_magnetic_field_vector(
                sim_shower[shp.magnetic_field_vector])
            sim_station.set_is_cosmic_ray()
            sim_stations[station_id] = sim_station
        for k, (station_id, channel_ids_for_group, antenna_position_rel, _) in \
                enumerate(layout):
            io_coreas.add_electric_field_to_sim_station(
                sim_stations[station_id], channel_ids_for_group, traces[k], starts[k],
                sim_shower[shp.zenith], sim_shower[shp.azimuth],
                self.coreas_interpolator.sampling_rate,
                efield_position=antenna_position_rel)
        for station_id, sim_station in sim_stations.items():
            sim_station[stnp.zenith] = sim_shower[shp.zenith]
            sim_station[stnp.azimuth] = sim_shower[shp.azimuth]
            station = Station(station_id)
            station.set_sim_station(sim_station)
            evt.set_station(station)
        return evt

    def end(self):
        pass


class simulationSelector(Module):
    """Select CoREAS simulations with any in-band signal above n_std sigma of
    the out-of-band noise floor (simulationSelector.py:9-99); each efield's
    spectrum statistics on the module's device."""

    def begin(self, debug=False):
        pass

    @register_run()
    def run(self, evt, sim_station, det,
            frequency_window=(100 * units.MHz, 500 * units.MHz), n_std=8):
        for efield in sim_station.get_electric_fields():
            fft = torch.abs(spectrum_tensor(efield, self.device))
            freq = np.asarray(efield.get_frequencies())

            max_pol = int(torch.argmax(torch.sum(fft, 1)))

            sel = freq > 1.5 * units.GHz
            for floor in (1.0 * units.GHz, 800 * units.MHz):
                if sel.any() and float(fft[max_pol][self.tensor(sel)].mean()) > 0:
                    break
                sel = freq > floor
            noise_region = fft[max_pol][self.tensor(sel)]
            if not sel.any() or float(noise_region.mean()) == 0:
                continue

            noise = noise_region.mean() + n_std * noise_region.std(correction=0)
            mask = (freq >= min(frequency_window)) & (freq <= max(frequency_window))
            if bool(torch.any(fft[:, self.tensor(mask)] > noise)):
                return True
        return False
