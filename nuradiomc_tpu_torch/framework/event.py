# copied from nuradiomc_tpu/framework/event.py:1-541; ElectricField.get_stokes_parameters runs on the
# port's utils/trace_stats.py (the port keeps its own copy; it imports nothing of the JAX package)
"""Event data model: Event / Station / SimStation / Channel / SimChannel /
ElectricField / Shower / Particle / Trigger.

Compact re-implementation of the reference framework layer
(NuRadioReco/framework/{event,station,base_station,sim_station,channel,
sim_channel,electric_field,base_shower,particle,trigger}.py) with the same
public accessor names. Serialization is pickle-based (Event.serialize,
event.py:676-744) via the .nur-style writer in sim.io_nur.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np

from nuradiomc_tpu_torch.framework.base_trace import BaseTrace
from nuradiomc_tpu_torch.framework.parameter_storage import ParameterStorage
from nuradiomc_tpu_torch.framework import parameters as par


class Channel(BaseTrace, ParameterStorage):
    def __init__(self, channel_id: int, channel_group_id: Optional[int] = None):
        BaseTrace.__init__(self)
        ParameterStorage.__init__(self, (par.channelParameters,))
        self._id = channel_id
        self._group_id = channel_group_id

    def get_id(self):
        return self._id

    def get_group_id(self):
        return self._group_id if self._group_id is not None else self._id


class SimChannel(Channel):
    """Per-(channel, shower, ray-solution) simulated channel
    (sim_channel.py:1-66)."""

    def __init__(self, channel_id, shower_id, ray_tracing_id):
        super().__init__(channel_id)
        self._shower_id = shower_id
        self._ray_tracing_id = ray_tracing_id

    def get_shower_id(self):
        return self._shower_id

    def get_ray_tracing_solution_id(self):
        return self._ray_tracing_id

    def get_unique_identifier(self):
        return (self._id, self._shower_id, self._ray_tracing_id)


class ElectricField(BaseTrace, ParameterStorage):
    """(3, N) trace (eR, eTheta, ePhi) + position (electric_field.py)."""

    def __init__(self, channel_ids, position=None, shower_id=None,
                 ray_tracing_id=None):
        BaseTrace.__init__(self)
        ParameterStorage.__init__(self, (par.electricFieldParameters,))
        self._channel_ids = list(channel_ids)
        self._position = position if position is not None else np.zeros(3)
        self._shower_id = shower_id
        self._ray_tracing_id = ray_tracing_id

    def get_channel_ids(self):
        return self._channel_ids

    def get_stokes_parameters(self, window_samples=None):
        """Stokes parameters in the stored (eTheta, ePhi) components
        (electric_field.get_stokes_parameters:86-140; shape (4,) for
        window_samples=None, else a running average over the window)."""
        import torch

        from nuradiomc_tpu_torch.utils.trace_stats import get_stokes
        trace = torch.as_tensor(np.asarray(self.get_trace(), dtype=float))
        return get_stokes(trace[1], trace[2], window_samples=window_samples).numpy()

    def has_channel_ids(self, ids):
        return all(i in self._channel_ids for i in ids)

    def get_position(self):
        return self._position

    def set_position(self, pos):
        self._position = pos

    def get_shower_id(self):
        return self._shower_id

    def get_ray_tracing_solution_id(self):
        return self._ray_tracing_id

    def get_unique_identifier(self):
        return (tuple(self._channel_ids), self._shower_id, self._ray_tracing_id)


class Trigger:
    """Trigger record (framework/trigger.py:40-226)."""

    def __init__(self, name, triggered_channels=None, trigger_type="default",
                 pre_trigger_times=55.0):
        self._name = name
        self._type = trigger_type
        self._triggered_channels = triggered_channels or []
        self._triggered = False
        self._trigger_time = None
        self._trigger_times = None
        self._pre_trigger_times = pre_trigger_times

    def get_name(self):
        return self._name

    def get_type(self):
        return self._type

    def has_triggered(self):
        return self._triggered

    def set_triggered(self, triggered=True):
        self._triggered = triggered

    def set_trigger_time(self, time):
        self._trigger_time = time

    def get_trigger_time(self):
        return self._trigger_time

    def set_trigger_times(self, times):
        self._trigger_times = times

    def get_trigger_times(self):
        return self._trigger_times if self._trigger_times is not None else \
            np.atleast_1d(self._trigger_time)

    def get_triggered_channels(self):
        return self._triggered_channels

    def set_triggered_channels(self, channels):
        self._triggered_channels = channels

    def get_pre_trigger_times(self):
        return self._pre_trigger_times

    def get_pre_trigger_time_channel(self, channel_id):
        if isinstance(self._pre_trigger_times, dict):
            return self._pre_trigger_times[channel_id]
        return self._pre_trigger_times


class SimpleThresholdTrigger(Trigger):
    def __init__(self, name, threshold, triggered_channels=None,
                 number_of_coincidences=1, **kwargs):
        super().__init__(name, triggered_channels, "simple_threshold", **kwargs)
        self._threshold = threshold
        self._number_of_coincidences = number_of_coincidences


class HighLowTrigger(Trigger):
    def __init__(self, name, threshold_high, threshold_low, high_low_window,
                 channel_coincidence_window, channels=None, number_of_coincidences=1,
                 **kwargs):
        super().__init__(name, channels, "high_low", **kwargs)
        self._threshold_high = threshold_high
        self._threshold_low = threshold_low
        self._high_low_window = high_low_window
        self._coinc_window = channel_coincidence_window
        self._number_of_coincidences = number_of_coincidences


class SimplePhasedTrigger(Trigger):
    def __init__(self, name, threshold, channels=None, primary_angles=None,
                 **kwargs):
        super().__init__(name, channels, "simple_phased", **kwargs)
        self._threshold = threshold
        self._primary_angles = primary_angles


class Shower(ParameterStorage):
    """Base shower (base_shower.py + radio_shower.py)."""

    def __init__(self, shower_id=0):
        super().__init__((par.showerParameters,))
        self._id = shower_id

    def get_id(self):
        return self._id

    def get_axis(self):
        zen = self[par.showerParameters.zenith]
        az = self[par.showerParameters.azimuth]
        return np.array([np.sin(zen) * np.cos(az), np.sin(zen) * np.sin(az),
                         np.cos(zen)])


class Particle(ParameterStorage):
    def __init__(self, particle_id=0):
        super().__init__((par.particleParameters,))
        self._id = particle_id

    def get_id(self):
        return self._id


class BaseStation(ParameterStorage):
    def __init__(self, station_id: int):
        super().__init__((par.stationParameters, par.stationParametersRNOG,
                          par.ARIANNAParameters))
        self._station_id = station_id
        self._station_time = None
        self._triggers = collections.OrderedDict()
        self._triggered = False
        self._electric_fields = []

    def get_id(self):
        return self._station_id

    def get_station_time(self):
        return self._station_time

    def set_station_time(self, time):
        self._station_time = time

    def set_trigger(self, trigger: Trigger):
        self._triggers[trigger.get_name()] = trigger
        self._triggered |= trigger.has_triggered()

    def get_trigger(self, name):
        return self._triggers[name]

    def get_triggers(self):
        return self._triggers

    def get_first_trigger(self):
        """Earliest trigger that fired (station.get_first_trigger)."""
        fired = [t for t in self._triggers.values() if t.has_triggered()]
        if not fired:
            return None
        def key(t):
            tt = t.get_trigger_time()
            return np.inf if tt is None else tt
        return min(fired, key=key)

    def has_trigger(self, name):
        return name in self._triggers

    def has_triggered(self, trigger_name=None):
        if trigger_name is not None:
            return self._triggers[trigger_name].has_triggered()
        return any(t.has_triggered() for t in self._triggers.values())

    def set_triggered(self, triggered=True):
        """Convenience setter for a single 'default' trigger
        (base_station.py:194-203); set_trigger() is the full interface."""
        if len(self._triggers) > 1:
            raise ValueError("more than one trigger was set. "
                             "Request is ambiguous")
        trigger = Trigger("default")
        trigger.set_triggered(triggered)
        self.set_trigger(trigger)

    def get_electric_fields(self):
        return self._electric_fields

    def set_electric_fields(self, efields):
        self._electric_fields = list(efields)

    def add_electric_field(self, efield: ElectricField):
        self._electric_fields.append(efield)

    def get_electric_fields_for_channels(self, channel_ids=None, ray_path_type=None):
        for ef in self._electric_fields:
            if channel_ids is None or ef.has_channel_ids(channel_ids):
                yield ef


class SimStation(BaseStation):
    """Simulated station holding per-(channel, shower, ray) SimChannels
    (sim_station.py:12-191)."""

    def __init__(self, station_id):
        super().__init__(station_id)
        self._sim_channels = collections.OrderedDict()
        self._candidate = None
        self._is_neutrino = False
        self._is_cosmic_ray = False
        self._simulation_weight = None
        self._magnetic_field_vector = None

    def set_simulation_weight(self, weight):
        """Area (or probability) weight of this simulated station
        (sim_station.py set_simulation_weight)."""
        self._simulation_weight = weight

    def get_simulation_weight(self):
        return self._simulation_weight

    def set_magnetic_field_vector(self, magnetic_field_vector):
        self._magnetic_field_vector = magnetic_field_vector

    def get_magnetic_field_vector(self):
        return self._magnetic_field_vector

    def is_candidate(self):
        return self._candidate

    def set_candidate(self, flag):
        self._candidate = flag

    def set_is_neutrino(self):
        self._is_neutrino = True

    def is_neutrino(self):
        return self._is_neutrino

    def set_is_cosmic_ray(self):
        self._is_cosmic_ray = True

    def is_cosmic_ray(self):
        return self._is_cosmic_ray

    def add_channel(self, channel: SimChannel):
        self._sim_channels[channel.get_unique_identifier()] = channel

    def get_channel(self, unique_id):
        return self._sim_channels[unique_id]

    def iter_channels(self):
        return iter(self._sim_channels.values())

    def get_channels_by_channel_id(self, channel_id):
        for ch in self._sim_channels.values():
            if ch.get_id() == channel_id:
                yield ch

    def get_channel_ids(self):
        return sorted({ch.get_id() for ch in self._sim_channels.values()})


class Station(BaseStation):
    def __init__(self, station_id: int):
        super().__init__(station_id)
        self._channels = collections.OrderedDict()
        self._sim_station = None

    def set_sim_station(self, sim_station: SimStation):
        self._sim_station = sim_station

    def get_sim_station(self):
        return self._sim_station

    def has_sim_station(self):
        return self._sim_station is not None

    def add_channel(self, channel: Channel):
        self._channels[channel.get_id()] = channel

    def get_channel(self, channel_id):
        return self._channels[channel_id]

    def get_trigger_channel(self, channel_id):
        return self._channels[channel_id]

    def has_channel(self, channel_id):
        return channel_id in self._channels

    def iter_channels(self, use_channels=None):
        for cid, ch in self._channels.items():
            if use_channels is None or cid in use_channels:
                yield ch

    def iter_trigger_channels(self):
        return self.iter_channels()

    def iter_channel_group(self, channel_group_id):
        """Channels sharing a group id (station.iter_channel_group);
        channels without an explicit group fall back to their own id."""
        for ch in self._channels.values():
            gid = ch.get_group_id()
            if (gid if gid is not None else ch.get_id()) == channel_group_id:
                yield ch

    def get_channel_group_ids(self):
        return sorted({(ch.get_group_id() if ch.get_group_id() is not None
                        else ch.get_id()) for ch in self._channels.values()})

    def get_channel_ids(self):
        return sorted(self._channels.keys())

    def get_number_of_channels(self):
        return len(self._channels)

    def remove_channel(self, channel_id):
        self._channels.pop(channel_id, None)


class HybridShower(Shower):
    """Named shower measured by a companion (hybrid) detector
    (framework/hybrid_shower.py:6-46)."""

    def __init__(self, name):
        super().__init__()
        self._name = name
        self._hybrid_detector = None

    def get_name(self):
        return self._name

    def set_hybrid_detector(self, det):
        self._hybrid_detector = det

    def get_hybrid_detector(self):
        return self._hybrid_detector


class HybridInformation:
    """Container for hybrid-detector showers on an event
    (framework/hybrid_information.py:6-40)."""

    def __init__(self):
        self._showers = collections.OrderedDict()

    def add_hybrid_shower(self, shower: HybridShower):
        if shower.get_name() in self._showers:
            raise ValueError(
                f"hybrid shower {shower.get_name()} already present")
        self._showers[shower.get_name()] = shower

    def get_hybrid_showers(self):
        return list(self._showers.values())

    def get_hybrid_shower(self, name):
        return self._showers[name]


class Event:
    """Event container with module provenance (event.py:28-872)."""

    def __init__(self, run_number: int, event_id: int):
        self._run_number = run_number
        self._id = event_id
        self._stations = collections.OrderedDict()
        self._sim_showers = collections.OrderedDict()
        self._showers = collections.OrderedDict()
        self._particles = collections.OrderedDict()
        self._sim_emitters = collections.OrderedDict()
        self._modules = []  # (level, name, instance-or-None, kwargs)
        self._generator_info = {}
        self._parameters = {}
        self._hybrid_information = HybridInformation()

    def get_hybrid_information(self):
        return self._hybrid_information

    def set_event_time(self, event_time):
        """Wall-clock time of the event (event.py set_event_time); stored
        as-is (datetime / astropy Time / float are all accepted)."""
        self._event_time = event_time

    def get_event_time(self):
        return getattr(self, "_event_time", None)

    def get_run_number(self):
        return self._run_number

    def get_id(self):
        return self._id

    # -- stations ------------------------------------------------------------

    def set_station(self, station: Station):
        self._stations[station.get_id()] = station

    def get_station(self, station_id=None):
        if station_id is None:
            if len(self._stations) != 1:
                raise ValueError("station_id required when event has != 1 station")
            return next(iter(self._stations.values()))
        return self._stations[station_id]

    def get_stations(self):
        return self._stations.values()

    def get_station_ids(self):
        return list(self._stations.keys())

    def has_station(self, station_id):
        return station_id in self._stations

    # -- showers / particles --------------------------------------------------

    def add_sim_shower(self, shower: Shower):
        self._sim_showers[shower.get_id()] = shower

    def get_sim_shower(self, shower_id):
        return self._sim_showers[shower_id]

    def get_sim_showers(self):
        return self._sim_showers.values()

    def has_sim_shower(self, shower_id=None):
        if shower_id is None:
            return len(self._sim_showers) > 0
        return shower_id in self._sim_showers

    def get_first_sim_shower(self):
        return next(iter(self._sim_showers.values()), None)

    def add_shower(self, shower: Shower):
        self._showers[shower.get_id()] = shower

    def get_showers(self):
        return self._showers.values()

    def add_particle(self, particle: Particle):
        self._particles[particle.get_id()] = particle

    def get_particles(self):
        return self._particles.values()

    def get_primary(self):
        return next(iter(self._particles.values()), None)

    # -- module provenance (base/module.py:34-118 register_run) ---------------

    def register_module_event(self, instance, name, kwargs):
        self._modules.append((None, name, instance, kwargs))

    def register_module_station(self, station_id, instance, name, kwargs):
        self._modules.append((station_id, name, instance, kwargs))

    def iter_modules(self, station_id=None):
        for sid, name, instance, kwargs in self._modules:
            if sid is None or station_id is None or sid == station_id:
                yield name, instance, kwargs

    def get_generator_info(self):
        return self._generator_info

    def set_generator_info(self, info):
        self._generator_info = dict(info)
