# copied from nuradiomc_tpu/sim/io_nur_reference.py:1-748 (the port keeps its own copy; it imports nothing of the JAX package)
"""Reader for REFERENCE-written .nur event files.

The reference persists events as `[6-byte version][6-byte minor]` followed by
length-prefixed blocks (NuRadioRecoio.py:19-404, event_parser_factory.py:
5-214): v2.0 = `[6B len][header pickle][6B len][event pickle]` per event;
v2.2 adds a `[6B object_type]` prefix per block (0=event, 1=detector,
2=event-specific detector changes).

The event payload itself is a pickled dict of plain python/numpy values with
*nested* pickled byte strings for stations/channels/efields/triggers/showers
(framework/event.py:676-800) — parameter keys are stored as STRINGS
("stationParameters.zenith", parameter_storage.py:107-119), so events carry
no framework class references. Only the small header block pickles real
parameter-enum objects; those are remapped onto our enums through a
value->name table of the reference's (gappy, deprecation-preserving) enum
numbering via a restricted Unpickler.
"""

from __future__ import annotations

import pickle
import warnings

import numpy as np

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.framework.event import (Channel, ElectricField, Event,
                                           Particle, Shower, SimChannel,
                                           SimStation, Station, Trigger)

# ---------------------------------------------------------------------------
# reference enum numbering (value -> member name). The reference keeps gaps
# for deprecated members, so our own (renumbered) enums cannot be matched by
# value — this table is the interop contract for header parsing.
# Source: NuRadioReco/framework/parameters.py (reference checkout).
# ---------------------------------------------------------------------------
REF_ENUM_VALUE_NAMES = {
    "stationParameters": {
        1: "nu_zenith", 2: "nu_azimuth", 3: "nu_energy", 4: "nu_flavor",
        5: "ccnc", 6: "nu_vertex", 7: "inelasticity", 8: "triggered",
        9: "cr_energy", 10: "cr_zenith", 11: "cr_azimuth",
        12: "channels_max_amplitude", 13: "zenith", 14: "azimuth",
        15: "zenith_cr_templatefit", 16: "zenith_nu_templatefit",
        19: "cr_xcorrelations", 20: "nu_xcorrelations", 21: "station_time",
        24: "cr_energy_em", 25: "nu_inttype",
        26: "chi2_efield_time_direction_fit", 27: "ndf_efield_time_direction_fit",
        28: "cr_xmax", 29: "vertex_2D_fit", 30: "distance_correlations",
        31: "shower_energy", 32: "viewing_angles", 60: "flagged_channels",
        61: "cr_dominant_polarisation", 62: "dirty_fft_channels",
        63: "channels_max_amplitude_norm",
    },
    "channelParameters": {
        1: "zenith", 2: "azimuth", 4: "maximum_amplitude", 5: "SNR",
        6: "maximum_amplitude_envelope", 7: "P2P_amplitude",
        8: "cr_xcorrelations", 9: "nu_xcorrelations", 10: "signal_time",
        11: "noise_rms", 12: "signal_regions", 13: "noise_regions",
        14: "signal_time_offset", 15: "signal_receiving_zenith",
        16: "signal_ray_type", 17: "signal_receiving_azimuth",
        18: "block_offsets", 19: "Vrms_NuRadioMC_simulation",
        20: "bandwidth_NuRadioMC_simulation",
        21: "Vrms_trigger_NuRadioMC_simulation", 22: "root_power_ratio",
        23: "impulsivity", 24: "entropy", 25: "kurtosis",
    },
    "electricFieldParameters": {
        1: "ray_path_type", 2: "polarization_angle",
        3: "polarization_angle_expectation", 4: "signal_energy_fluence",
        5: "cr_spectrum_slope", 7: "zenith", 8: "azimuth", 9: "signal_time",
        10: "nu_vertex_distance", 11: "nu_viewing_angle", 12: "max_amp_antenna",
        13: "max_amp_antenna_envelope", 14: "reflection_coefficient_theta",
        15: "reflection_coefficient_phi", 16: "cr_spectrum_quadratic_term",
        17: "energy_fluence_ratios", 18: "nu_vertex_propagation_time",
        19: "raytracing_solution", 20: "launch_vector",
    },
    "showerParameters": {
        1: "zenith", 2: "azimuth", 3: "core", 4: "energy",
        5: "electromagnetic_energy", 6: "radiation_energy",
        7: "electromagnetic_radiation_energy", 8: "primary_particle",
        9: "shower_maximum", 10: "distance_shower_maximum_geometric",
        11: "distance_shower_maximum_grammage", 12: "parent_id",
        100: "refractive_index_at_ground", 101: "atmospheric_model",
        102: "magnetic_field_rotation", 103: "magnetic_field_vector",
        104: "observation_level", 105: "charge_excess_profile_id",
        106: "type", 107: "vertex", 108: "vertex_time",
        109: "interaction_type", 110: "k_L", 111: "flavor",
        112: "n_interaction", 120: "interferometric_shower_maximum",
        121: "interferometric_shower_axis", 122: "interferometric_core",
    },
    "particleParameters": {
        1: "parent_id", 2: "zenith", 3: "azimuth", 4: "energy", 5: "flavor",
        6: "vertex", 9: "vertex_time", 10: "weight", 11: "inelasticity",
        12: "interaction_type", 13: "n_interaction", 14: "shower_id",
        101: "cr_energy", 102: "cr_zenith", 103: "cr_azimuth",
        104: "cr_energy_em",
    },
    "emitterParameters": {
        1: "position", 2: "model", 3: "amplitude", 4: "polarization",
        5: "half_width", 6: "frequency", 7: "orientation_phi",
        8: "orientation_theta", 9: "rotation_phi", 10: "rotation_theta",
        11: "realization_id", 12: "antenna_type", 13: "time",
    },
    "eventParameters": {1: "sim_config", 2: "hash_NuRadioReco",
                        3: "hash_NuRadioMC"},
    "generatorAttributes": {
        1: "Emax", 2: "Emin", 3: "deposited", 4: "fiducial_rmin",
        5: "fiducial_rmax", 6: "fiducial_xmin", 7: "fiducial_xmax",
        8: "fiducial_ymin", 9: "fiducial_ymax", 10: "fiducial_zmin",
        11: "fiducial_zmax", 12: "rmin", 13: "rmax", 14: "xmin", 15: "xmax",
        16: "ymin", 17: "ymax", 18: "zmin", 19: "zmax", 20: "volume",
        21: "area", 22: "phimax", 23: "phimin", 24: "thetamax",
        25: "thetamin", 26: "flavors", 27: "dt", 28: "Tnoise", 29: "Vrms",
        30: "bandwidth", 100: "n_events", 101: "n_samples",
        102: "start_event_id", 103: "total_number_of_events",
        200: "NuRadioMC_EvtGen_version", 201: "NuRadioMC_EvtGen_version_hash",
        202: "NuRadioMC_version", 203: "NuRadioMC_version_hash",
    },
}

_MY_ENUMS = {c.__name__: c for c in (
    par.stationParameters, par.channelParameters, par.electricFieldParameters,
    par.showerParameters, par.emitterParameters, par.particleParameters,
    par.generatorAttributes, par.eventParameters)}


class RefParameter:
    """Opaque token for a reference parameter with no counterpart here."""

    def __init__(self, enum_name, member, value=None):
        self.enum_name = enum_name
        self.name = member
        self.value = value

    def __repr__(self):
        return f"<ref {self.enum_name}.{self.name}>"

    def __hash__(self):
        return hash((self.enum_name, self.name))

    def __eq__(self, other):
        return (isinstance(other, RefParameter)
                and (self.enum_name, self.name) == (other.enum_name, other.name))


def map_param_name(enum_name: str, member: str):
    """Reference 'enumClass', 'member' -> our enum member (or RefParameter)."""
    enum = _MY_ENUMS.get(enum_name)
    if enum is not None and member in enum.__members__:
        return enum[member]
    return RefParameter(enum_name, member)


def _map_param_string(s: str):
    """'stationParameters.zenith' (parameter_storage str(key)) -> key."""
    enum_name, _, member = s.partition(".")
    return map_param_name(enum_name, member)


def _enum_shim(enum_name: str):
    """Callable standing in for a reference enum class during unpickling:
    enums pickle as (cls, (value,)), so calling the shim with the reference
    VALUE reconstructs our member through the value->name table."""
    table = REF_ENUM_VALUE_NAMES.get(enum_name, {})

    def construct(value):
        member = table.get(value)
        if member is None:
            return RefParameter(enum_name, f"unknown_{value}", value)
        return map_param_name(enum_name, member)

    construct.__name__ = enum_name
    return construct


_ALLOWED_MODULE_PREFIXES = ("numpy", "builtins", "collections", "datetime",
                            "fractions", "decimal")


class _RefUnpickler(pickle.Unpickler):
    """Unpickler that maps reference framework/astropy classes onto local
    equivalents and refuses anything else non-standard (no arbitrary code)."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("numpy",) or \
                module.split(".", 1)[0] in _ALLOWED_MODULE_PREFIXES:
            return super().find_class(module, name)
        if module == "NuRadioReco.framework.parameters":
            return _enum_shim(name)
        if module == "NuRadioReco.utilities.io_utilities" \
                and name == "_unpickle_numpy_array":
            return _unpack_fastnumpyio
        if module.startswith("astropy.time"):
            return _AstropyTimeShim
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} from a .nur file")


def _unpack_fastnumpyio(data: bytes) -> np.ndarray:
    """Decode the reference's compact array-bytes format
    (utilities/_fastnumpyio.py:41-67 pack / :82-91 unpack): 2 utf-8 bytes
    byteorder+kind, 1 byte itemsize, 1 byte ndim, ndim uint32 shape, raw."""
    import struct

    dtype = data[:2].decode("utf-8") + str(data[2])
    ndim = data[3]
    shape = struct.unpack_from(f"<{ndim}I", data, 4)
    count = int(np.prod(shape)) if ndim else 1
    start = 4 + ndim * 4
    flat = np.frombuffer(data, dtype=dtype, count=count, offset=start)
    return flat.reshape(shape).copy()


class _AstropyTimeShim:
    """Tolerates astropy.time.Time objects in old files: keeps the raw
    reconstruction state and exposes unix/jd when derivable."""

    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs

    def __setstate__(self, state):
        self.state = state


def _loads(data: bytes):
    import io
    return _RefUnpickler(io.BytesIO(data)).load()


# ---------------------------------------------------------------------------
# payload -> framework objects
# ---------------------------------------------------------------------------

def _restore_parameters(obj, data):
    for key_str, value in data.get("_parameters", {}).items():
        key = _map_param_string(key_str)
        obj._parameters[key] = value
    for (k1, k2), value in data.get("_parameter_covariances", {}).items():
        obj._parameter_covariances[
            (_map_param_string(k1), _map_param_string(k2))] = value


def _restore_trace(obj, base_trace_pkl):
    if base_trace_pkl is None:
        return
    data = _loads(base_trace_pkl)
    obj.set_trace(np.asarray(data["time_trace"]), data["sampling_rate"])
    if "trace_start_time" in data:
        obj.set_trace_start_time(data["trace_start_time"])


def _station_time_value(d):
    """_astropy_to_dict dicts -> unix seconds (float) or None."""
    if d is None or not isinstance(d, dict):
        return None
    if "value" in d and d.get("format") in ("jd", None) \
            and isinstance(d["value"], (tuple, list)):
        jd1, jd2 = d["value"]
        return (float(jd1) - 2440587.5 + float(jd2)) * 86400.0
    if "value" in d and isinstance(d["value"], (int, float)):
        return float(d["value"])
    return None


def _channel_from_pkl(data_pkl, cls=Channel):
    data = _loads(data_pkl)
    if cls is SimChannel:
        # SimChannel wraps the channel pickle (sim_channel.py:51-59)
        inner = _loads(data["channel"])
        ch = SimChannel(inner["id"], data.get("shower_id"),
                        data.get("ray_tracing_id"))
        data = inner
    else:
        ch = Channel(data["id"], channel_group_id=data.get("group_id"))
    _restore_parameters(ch, data)
    _restore_trace(ch, data.get("base_trace"))
    return ch


def _efield_from_pkl(data_pkl):
    data = _loads(data_pkl)
    ef = ElectricField(list(data["channel_ids"]),
                       position=data.get("position"),
                       shower_id=data.get("_shower_id"),
                       ray_tracing_id=data.get("_ray_tracing_id"))
    _restore_parameters(ef, data)
    _restore_trace(ef, data.get("base_trace"))
    return ef


def _trigger_from_pkl(data_pkl):
    data = _loads(data_pkl)
    trig = Trigger(data.get("_name"),
                   triggered_channels=data.get("_triggered_channels"),
                   trigger_type=data.get("_trigger_type", "default"))
    for key, value in data.items():
        if key == "_trigger_type":
            trig._type = value
        setattr(trig, key, value)
    return trig


def _base_station_restore(st, data):
    _restore_parameters(st, data)
    st._station_id = data.get("_station_id", st.get_id())
    t = _station_time_value(data.get("_station_time"))
    if t is not None and hasattr(st, "set_station_time"):
        st.set_station_time(t)
    for trig_pkl in data.get("triggers", []):
        st.set_trigger(_trigger_from_pkl(trig_pkl))
    for ef_pkl in data.get("electric_fields", []):
        st.add_electric_field(_efield_from_pkl(ef_pkl))


def _sim_station_from_pkl(data_pkl):
    data = _loads(data_pkl)
    base = _loads(data["base_station"])          # sim_station.py:151-160
    sim = SimStation(base.get("_station_id", 0))
    _base_station_restore(sim, base)
    for ch_pkl in data.get("channels", []):
        sim.add_channel(_channel_from_pkl(ch_pkl, cls=SimChannel))
    return sim


def _station_from_pkl(data_pkl):
    data = _loads(data_pkl)
    base = _loads(data["base_station"])
    st = Station(base.get("_station_id", 0))
    _base_station_restore(st, base)
    for ch_pkl in data.get("channels", []):
        st.add_channel(_channel_from_pkl(ch_pkl))
    if data.get("sim_station") is not None:
        st.set_sim_station(_sim_station_from_pkl(data["sim_station"]))
    return st


def _shower_from_pkl(data_pkl):
    data = _loads(data_pkl)
    base = _loads(data["base_shower"]) if "base_shower" in data else data
    sh = Shower(base.get("_id"))
    _restore_parameters(sh, base)
    return sh


def _particle_from_pkl(data_pkl):
    data = _loads(data_pkl)
    p = Particle(data.get("_id"))
    _restore_parameters(p, data)
    return p


def event_from_reference_pkl(evtstr: bytes) -> Event:
    """Rebuild one Event from a reference event payload
    (framework/event.py:745-800 deserialize semantics)."""
    data = _loads(evtstr)
    evt = Event(data.get("__run_number", 0), data.get("_id", 0))
    _restore_parameters(evt, data)
    for st_pkl in data.get("stations", []):
        evt.set_station(_station_from_pkl(st_pkl))
    for sh_pkl in data.get("showers", []):
        evt.add_shower(_shower_from_pkl(sh_pkl))
    for sh_pkl in data.get("sim_showers", []):
        evt.add_sim_shower(_shower_from_pkl(sh_pkl))
    for p_pkl in data.get("particles", []):
        evt.add_particle(_particle_from_pkl(p_pkl))
    if data.get("__modules_event"):
        evt._modules_event = data["__modules_event"]
    return evt


# ---------------------------------------------------------------------------
# container scanning (NuRadioRecoio block format)
# ---------------------------------------------------------------------------

class NuRadioRecoio:
    """Read reference-written .nur files (v2.0 - v2.2 block formats)."""

    def __init__(self, filenames, parse_header: bool = True,
                 parse_detector: bool = True):
        if not isinstance(filenames, (list, tuple)):
            filenames = [filenames]
        self._filenames = list(filenames)
        self._event_positions = []      # (filename, byte offset of payload len)
        self._event_headers = []
        self._detector_dicts = []
        self._parse_header = parse_header
        self._parse_detector = parse_detector
        for fn in self._filenames:
            self._scan(fn)

    def _scan(self, fn):
        with open(fn, "rb") as f:
            version = int.from_bytes(f.read(6), "little")
            minor = int.from_bytes(f.read(6), "little")
            if version != 2:
                raise IOError(f"{fn}: unsupported .nur version {version}.{minor}")
            has_type = minor >= 2
            while True:
                if has_type:
                    ot_raw = f.read(6)
                    if len(ot_raw) < 6:
                        break
                    object_type = int.from_bytes(ot_raw, "little")
                else:
                    object_type = 0
                ln_raw = f.read(6)
                if len(ln_raw) < 6:
                    break
                length = int.from_bytes(ln_raw, "little")
                if length == 0:
                    break
                if object_type == 0:
                    header_bytes = f.read(length)
                    if self._parse_header:
                        try:
                            self._event_headers.append(_loads(header_bytes))
                        except Exception as e:    # tolerate odd header content
                            warnings.warn(f"{fn}: could not parse header: {e}")
                            self._event_headers.append(None)
                    ev_len = int.from_bytes(f.read(6), "little")
                    self._event_positions.append((fn, f.tell(), ev_len))
                    f.seek(ev_len, 1)
                elif object_type == 1:
                    blob = f.read(length)
                    if self._parse_detector:
                        self._detector_dicts.append(_loads(blob))
                else:
                    f.seek(length, 1)

    def get_n_events(self) -> int:
        return len(self._event_positions)

    def get_event_ids(self):
        return [h["event_id"] if h else None for h in self._event_headers]

    def get_header(self):
        return self._event_headers

    def get_detector_dicts(self):
        return self._detector_dicts

    def get_event_i(self, i: int) -> Event:
        fn, off, ln = self._event_positions[i]
        with open(fn, "rb") as f:
            f.seek(off)
            return event_from_reference_pkl(f.read(ln))

    def get_event(self, event_id) -> Event:
        for i, h in enumerate(self._event_headers):
            if h and tuple(h["event_id"]) == tuple(event_id):
                return self.get_event_i(i)
        raise KeyError(event_id)

    def get_events(self):
        for i in range(self.get_n_events()):
            yield self.get_event_i(i)


class eventReader:
    """Reference-compatible module API (modules/io/eventReader.py)."""

    def begin(self, filenames, read_detector=False):
        self._io = NuRadioRecoio(filenames, parse_detector=read_detector)

    def run(self):
        return self._io.get_events()

    def get_header(self):
        return self._io.get_header()

    def end(self):
        pass


# ---------------------------------------------------------------------------
# WRITING reference-format .nur files (modules/io/eventWriter.py block
# layout + framework serialize payloads), so files produced here are readable
# by the reference's own NuRadioRecoio.
# ---------------------------------------------------------------------------

_REF_NAME_VALUES = {enum_name: {m: v for v, m in table.items()}
                    for enum_name, table in REF_ENUM_VALUE_NAMES.items()}


@__import__("functools").lru_cache(maxsize=1)
def _ref_compat_enums():
    """Enum classes with the REFERENCE numbering registered under the module
    path 'NuRadioReco.framework.parameters', so pickled header enums load in
    the reference by value. No-op passthrough when the real reference is
    importable."""
    import enum as _enum
    import sys
    import types

    try:
        import NuRadioReco.framework.parameters as ref_par  # noqa: F401
        return {name: getattr(ref_par, name)
                for name in REF_ENUM_VALUE_NAMES
                if hasattr(ref_par, name)}
    except ImportError:
        pass

    mod_name = "NuRadioReco.framework.parameters"
    out = {}
    mod = sys.modules.get(mod_name)
    if mod is None:
        pkg_root = types.ModuleType("NuRadioReco")
        pkg_fw = types.ModuleType("NuRadioReco.framework")
        mod = types.ModuleType(mod_name)
        pkg_root.framework = pkg_fw
        pkg_fw.parameters = mod
        sys.modules.setdefault("NuRadioReco", pkg_root)
        sys.modules.setdefault("NuRadioReco.framework", pkg_fw)
        sys.modules[mod_name] = mod
    for enum_name, table in REF_ENUM_VALUE_NAMES.items():
        cls = _enum.Enum(enum_name, {m: v for v, m in table.items()},
                         module=mod_name)
        setattr(mod, enum_name, cls)
        out[enum_name] = cls
    return out


def _to_ref_key(key):
    """Our enum member (or RefParameter token) -> reference enum member."""
    enums = _ref_compat_enums()
    if isinstance(key, RefParameter):
        cls = enums.get(key.enum_name)
        return cls[key.name] if cls is not None and \
            key.name in cls.__members__ else None
    enum_name = type(key).__name__
    cls = enums.get(enum_name)
    if cls is not None and key.name in cls.__members__:
        return cls[key.name]
    return None


def _param_key_str(key):
    if isinstance(key, RefParameter):
        return f"{key.enum_name}.{key.name}"
    return str(key)


def _params_blob(obj):
    """ParameterStorage.serialize equivalent (string keys,
    parameter_storage.py:107-119)."""
    raw = (obj.get_parameters() if hasattr(obj, "get_parameters")
           else getattr(obj, "_parameters", {}))
    params = {_param_key_str(k): v for k, v in raw.items()}
    covs = {(_param_key_str(k1), _param_key_str(k2)): v
            for (k1, k2), v in getattr(obj, "_parameter_covariances",
                                       {}).items()}
    types = sorted({_param_key_str(k).split(".")[0] for k in raw}
                   & set(REF_ENUM_VALUE_NAMES))
    return {"_parameters": params, "_parameter_covariances": covs,
            "_parameter_types": types}


def _trace_blob(bt):
    """Pickled BaseTrace.serialize payload (base_trace.py:292-300)."""
    tr = bt.get_trace()
    if tr is None:
        return None
    return _dump({"sampling_rate": bt.get_sampling_rate(),
                  "time_trace": np.asarray(tr),
                  "trace_start_time": bt.get_trace_start_time()})


def _dump(obj) -> bytes:
    import pickle as _p
    return _p.dumps(obj, protocol=4)


def _serialize_channel(ch) -> bytes:
    data = _params_blob(ch)
    data.update({"id": ch.get_id(),
                 "group_id": getattr(ch, "_group_id", None),
                 "base_trace": _trace_blob(ch),
                 "trigger_channel_pkl": None})
    return _dump(data)


def _serialize_sim_channel(ch) -> bytes:
    return _dump({"shower_id": ch.get_shower_id(),
                  "ray_tracing_id": ch.get_ray_tracing_solution_id(),
                  "channel": _serialize_channel(ch)})


def _serialize_efield(ef) -> bytes:
    data = _params_blob(ef)
    data.update({"channel_ids": list(ef.get_channel_ids()),
                 "_shower_id": ef.get_shower_id(),
                 "_ray_tracing_id": ef.get_ray_tracing_solution_id(),
                 "position": ef.get_position(),
                 "base_trace": _trace_blob(ef)})
    return _dump(data)


def _serialize_trigger(trig) -> bytes:
    data = dict(trig.__dict__)
    data["_trigger_type"] = data.pop("_type", "default")
    data.setdefault("_channels", data.get("_triggered_channels"))
    data.setdefault("_primary_trigger", False)
    return _dump(data)


def _time_dict(t):
    """Seconds-since-epoch float -> the reference's jd-tuple time dict
    (io_utilities._astropy_to_dict)."""
    if t is None:
        return None
    unix = float(t.timestamp() if hasattr(t, "timestamp") else t)
    jd1 = 2440587.5 + unix // 86400
    jd2 = (unix % 86400) / 86400.0
    return {"value": (jd1, jd2), "format": "jd"}


def _serialize_base_station(st, save_efield_traces=True) -> bytes:
    data = _params_blob(st)
    t = getattr(st, "get_station_time", lambda: None)()
    data.update({
        "_station_id": st.get_id(),
        "_station_time": _time_dict(t),
        "_particle_type": getattr(st, "_particle_type", ""),
        "triggers": [_serialize_trigger(t2) for t2 in
                     getattr(st, "get_triggers", dict)().values()]
        if hasattr(st, "get_triggers") else [],
        "_triggered": bool(getattr(st, "has_triggered", lambda: False)()),
        "electric_fields": [_serialize_efield(ef)
                            for ef in st.get_electric_fields()],
    })
    return _dump(data)


def _serialize_sim_station(sim) -> bytes:
    return _dump({"__magnetic_field_vector": None,
                  "__simulation_weight": None,
                  "channels": [_serialize_sim_channel(c)
                               for c in sim.iter_channels()],
                  "base_station": _serialize_base_station(sim)})


def _serialize_station(st) -> bytes:
    sim = st.get_sim_station() if hasattr(st, "get_sim_station") else None
    return _dump({
        "__reference_reconstruction": "RD",
        "channels": [_serialize_channel(c) for c in st.iter_channels()],
        "base_station": _serialize_base_station(st),
        "sim_station": _serialize_sim_station(sim) if sim is not None else None,
    })


def _serialize_shower(sh) -> bytes:
    base = _params_blob(sh)
    base["_id"] = sh.get_id() if hasattr(sh, "get_id") else getattr(sh, "_id", None)
    return _dump({"base_shower": _dump(base), "station_ids": None})


def _serialize_particle(p) -> bytes:
    data = _params_blob(p)
    data["_id"] = getattr(p, "_id", None)
    return _dump(data)


def serialize_event_reference(evt) -> bytes:
    """Event payload in the reference's serialize() layout
    (framework/event.py:676-744)."""
    data = _params_blob(evt)
    data.update({
        "__run_number": evt.get_run_number(),
        "_id": evt.get_id(),
        "__event_time": None,
        "stations": [_serialize_station(st) for st in evt.get_stations()],
        "showers": [_serialize_shower(s) for s in evt.get_showers()],
        "sim_showers": [_serialize_shower(s) for s in evt.get_sim_showers()],
        "sim_emitters": [],
        "particles": [_serialize_particle(p) for p in evt.get_particles()],
        "hybrid_info": _dump({"shower_pickles": []}),
        "__modules_event": [],
        "__modules_station": {},
    })
    return _dump(data)


def event_header_reference(evt) -> dict:
    """get_header equivalent (eventWriter.py:14-24) with REFERENCE-numbered
    enum keys (headers pickle real enum objects)."""
    header = {"stations": {}}
    for st in evt.get_stations():
        entry = {}
        for k, v in st.get_parameters().items():
            rk = _to_ref_key(k)
            if rk is not None:
                entry[rk] = v
        enums = _ref_compat_enums()
        st_time = getattr(st, "get_station_time", lambda: None)()
        entry[enums["stationParameters"]["station_time"]] = _time_dict(st_time)
        sim = st.get_sim_station() if hasattr(st, "get_sim_station") else None
        if sim is not None:
            entry["sim_station"] = {
                rk: v for k, v in sim.get_parameters().items()
                if (rk := _to_ref_key(k)) is not None}
        header["stations"][st.get_id()] = entry
    header["event_id"] = (evt.get_run_number(), evt.get_id())
    return header


class ReferenceEventWriter:
    """Write reference-format (v2.2) .nur files readable by the reference's
    NuRadioRecoio (eventWriter.py block layout)."""

    def __init__(self, filename: str):
        self._f = open(filename, "wb")
        self._f.write((2).to_bytes(6, "little"))
        self._f.write((2).to_bytes(6, "little"))
        self._n = 0

    def begin(self, filename=None):
        return self

    def run(self, evt, det=None, mode=None):
        header = _dump(event_header_reference(evt))
        payload = serialize_event_reference(evt)
        b = bytearray()
        b.extend((0).to_bytes(6, "little"))
        b.extend(len(header).to_bytes(6, "little"))
        b.extend(header)
        b.extend(len(payload).to_bytes(6, "little"))
        b.extend(payload)
        self._f.write(b)
        self._n += 1

    def end(self):
        self._f.close()
        return self._n


class eventWriter:
    """Reference-compatible module API (modules/io/eventWriter.py):
    begin(filename) / run(evt) / end(), writing reference-format files."""

    def begin(self, filename, **kwargs):
        if not filename.endswith(".nur"):
            filename = filename + ".nur"
        self._writer = ReferenceEventWriter(filename)

    def run(self, evt, det=None, mode=None):
        self._writer.run(evt, det=det, mode=mode)

    def end(self):
        return self._writer.end()
