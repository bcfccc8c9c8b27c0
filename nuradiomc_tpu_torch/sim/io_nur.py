# copied from nuradiomc_tpu/sim/io_nur.py:1-221 (the port keeps its own copy; it imports
# nothing of the JAX package)
""".nur-style event file I/O.

The reference persists events as length-prefixed byte blocks, each a pickled
representation of the Event tree (modules/io/eventWriter.py:100-330,
NuRadioRecoio.py:19-404). This implements the same container format — a magic
header, then [4-byte big-endian length][payload] blocks — with a
dict-serialized event payload (stations/channels/efields/showers/triggers/
provenance) that does not require unpickling framework classes, making the
format robust across versions.
"""

from __future__ import annotations

import pickle
import struct

import numpy as np

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.framework.event import (Channel, ElectricField, Event,
                                           SimChannel, SimStation, Shower,
                                           Station, Trigger, Particle)

MAGIC = b"NURTPU01"


def _trace_state(bt):
    return {
        "trace": np.asarray(bt.get_trace()) if bt.get_trace() is not None else None,
        "sampling_rate": bt.get_sampling_rate(),
        "trace_start_time": bt.get_trace_start_time(),
    }


def _params_state(ps):
    return [(type(k).__name__, k.name, v) for k, v in ps.get_parameters().items()]


_PARAM_ENUMS = {c.__name__: c for c in (
    par.stationParameters, par.channelParameters, par.electricFieldParameters,
    par.showerParameters, par.emitterParameters, par.particleParameters,
    par.generatorAttributes, par.eventParameters)}


def _restore_params(obj, state):
    for enum_name, key_name, value in state:
        enum = _PARAM_ENUMS[enum_name]
        obj.set_parameter(enum[key_name], value)


def event_to_dict(event: Event) -> dict:
    stations = {}
    for st in event.get_stations():
        channels = {}
        for ch in st.iter_channels():
            channels[ch.get_id()] = {**_trace_state(ch), "params": _params_state(ch),
                                     "group_id": ch.get_group_id()}
        efields = []
        for ef in st.get_electric_fields():
            efields.append({**_trace_state(ef), "params": _params_state(ef),
                            "channel_ids": ef.get_channel_ids(),
                            "position": np.asarray(ef.get_position()),
                            "shower_id": ef.get_shower_id(),
                            "ray_id": ef.get_ray_tracing_solution_id()})
        triggers = {}
        for name, trig in st.get_triggers().items():
            triggers[name] = {"type": trig.get_type(),
                              "triggered": trig.has_triggered(),
                              "time": trig.get_trigger_time(),
                              "channels": trig.get_triggered_channels()}
        sim_station = None
        if isinstance(st, Station) and st.has_sim_station():
            ss = st.get_sim_station()
            sim_channels = []
            for sc in ss.iter_channels():
                sim_channels.append({**_trace_state(sc), "params": _params_state(sc),
                                     "uid": sc.get_unique_identifier()})
            sim_efields = []
            for ef in ss.get_electric_fields():
                sim_efields.append({**_trace_state(ef), "params": _params_state(ef),
                                    "channel_ids": ef.get_channel_ids(),
                                    "position": np.asarray(ef.get_position()),
                                    "shower_id": ef.get_shower_id(),
                                    "ray_id": ef.get_ray_tracing_solution_id()})
            sim_station = {"id": ss.get_id(), "channels": sim_channels,
                           "efields": sim_efields,
                           "params": _params_state(ss)}
        stations[st.get_id()] = {"channels": channels, "efields": efields,
                                 "triggers": triggers, "params": _params_state(st),
                                 "sim_station": sim_station}

    return {
        "run_number": event.get_run_number(),
        "id": event.get_id(),
        "stations": stations,
        "sim_showers": {s.get_id(): _params_state(s) for s in event.get_sim_showers()},
        "showers": {s.get_id(): _params_state(s) for s in event.get_showers()},
        "particles": {p.get_id(): _params_state(p) for p in event.get_particles()},
        "modules": [(sid, name, None, kwargs) for sid, name, _, kwargs
                    in event._modules],
        "generator_info": event.get_generator_info(),
    }


def dict_to_event(d: dict) -> Event:
    event = Event(d["run_number"], d["id"])
    for sid, sd in d["stations"].items():
        st = Station(sid)
        _restore_params(st, sd["params"])
        for cid, cd in sd["channels"].items():
            ch = Channel(cid, cd.get("group_id"))
            if cd["trace"] is not None:
                ch.set_trace(cd["trace"], cd["sampling_rate"], cd["trace_start_time"])
            _restore_params(ch, cd["params"])
            st.add_channel(ch)
        for ed in sd["efields"]:
            ef = ElectricField(ed["channel_ids"], ed["position"],
                               ed["shower_id"], ed["ray_id"])
            if ed["trace"] is not None:
                ef.set_trace(ed["trace"], ed["sampling_rate"], ed["trace_start_time"])
            _restore_params(ef, ed["params"])
            st.add_electric_field(ef)
        for name, td in sd["triggers"].items():
            trig = Trigger(name, td["channels"], td["type"])
            trig.set_triggered(td["triggered"])
            trig.set_trigger_time(td["time"])
            st.set_trigger(trig)
        if sd.get("sim_station") is not None:
            ssd = sd["sim_station"]
            ss = SimStation(ssd["id"])
            _restore_params(ss, ssd["params"])
            for cd in ssd["channels"]:
                sc = SimChannel(*cd["uid"])
                if cd["trace"] is not None:
                    sc.set_trace(cd["trace"], cd["sampling_rate"], cd["trace_start_time"])
                _restore_params(sc, cd["params"])
                ss.add_channel(sc)
            for ed in ssd["efields"]:
                ef = ElectricField(ed["channel_ids"], ed["position"],
                                   ed["shower_id"], ed["ray_id"])
                if ed["trace"] is not None:
                    ef.set_trace(ed["trace"], ed["sampling_rate"], ed["trace_start_time"])
                _restore_params(ef, ed["params"])
                ss.add_electric_field(ef)
            st.set_sim_station(ss)
        event.set_station(st)
    for shid, ps in d["sim_showers"].items():
        sh = Shower(shid)
        _restore_params(sh, ps)
        event.add_sim_shower(sh)
    for shid, ps in d["showers"].items():
        sh = Shower(shid)
        _restore_params(sh, ps)
        event.add_shower(sh)
    for pid, ps in d["particles"].items():
        p = Particle(pid)
        _restore_params(p, ps)
        event.add_particle(p)
    event._modules = [tuple(m) for m in d.get("modules", [])]
    event.set_generator_info(d.get("generator_info", {}))
    return event


class EventWriter:
    """Length-prefixed block writer (eventWriter.py semantics)."""

    def __init__(self, filename: str):
        self._f = open(filename, "wb")
        self._f.write(MAGIC)
        self._n = 0

    def run(self, event: Event):
        payload = pickle.dumps(event_to_dict(event), protocol=4)
        self._f.write(struct.pack(">I", len(payload)))
        self._f.write(payload)
        self._n += 1

    def end(self):
        self._f.close()
        return self._n


class EventReader:
    """Sequential event reader (NuRadioRecoio semantics).

    Reads both the container above (MAGIC header) and files NuRadioReco
    wrote (version 2.x block format), the latter through
    ``sim/io_nur_reference.NuRadioRecoio``."""

    def __init__(self, filename: str):
        self._ref_io = None
        self._f = open(filename, "rb")
        magic = self._f.read(len(MAGIC))
        if magic != MAGIC:
            version = int.from_bytes(magic[:6], "little")
            self._f.close()
            self._f = None
            if version == 2:
                from nuradiomc_tpu_torch.sim import io_nur_reference
                self._ref_io = io_nur_reference.NuRadioRecoio(filename)
            else:
                raise IOError(f"{filename} is not a .nur event file")

    def run(self):
        if self._ref_io is not None:
            yield from self._ref_io.get_events()
            return
        while True:
            head = self._f.read(4)
            if len(head) < 4:
                return
            (length,) = struct.unpack(">I", head)
            payload = self._f.read(length)
            yield dict_to_event(pickle.loads(payload))

    def get_events(self):
        return self.run()

    def end(self):
        if self._f is not None:
            self._f.close()
