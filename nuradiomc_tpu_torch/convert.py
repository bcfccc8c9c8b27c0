"""Parameters from the JAX package to the port, and the headline inputs.

:func:`from_jax` maps the JAX package's ``PipelineSettings`` /
``ChannelParams`` / ``ShowerBatch`` / ``IceModelSimple`` onto the port's
types by field name (``_asdict()`` / ``dataclasses.fields``), without
importing them, so the port never imports jax.

:func:`make_headline_inputs` reproduces ``__graft_entry__.
_make_settings_and_inputs`` (the headline workload of ``bench.py``) bit for
bit, with the same ``default_rng(0)`` draw order, so the card can build it
without jax. :func:`make_pa_inputs` builds the phased-array workload of
``bench._pa_setup`` and :func:`make_gen2_inputs` the Gen2 composed workload
of ``bench._gen2_setup`` through the port's ``Simulation`` on the ``.npz``
export of their inputs, so the card builds them without jax and without
h5py. :func:`make_mooresbay_inputs` builds the reflective-bottom (Moore's
Bay) workload from numpy alone: its event list is drawn from a seed in
memory. :func:`emitter_from_jax` and :func:`library_from_jax` carry the JAX
package's ``EmitterParams`` and ARZ ``ShowerLibrary`` over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nuradiomc_tpu_torch.ops import filters
from nuradiomc_tpu_torch.utils import config as config_util
from nuradiomc_tpu_torch.utils import units
from nuradiomc_tpu_torch.models import ice as ice_models
from nuradiomc_tpu_torch.ops import antenna
from nuradiomc_tpu_torch.ops.arz import ShowerLibrary
from nuradiomc_tpu_torch.sim.pipeline import (AntennaTableParams, ChannelParams,
                                              EmitterParams, PipelineSettings,
                                              ShowerBatch, TriggerSettings)
from nuradiomc_tpu_torch.utils import device as device_util

# JAX PipelineSettings fields that select TPU lowerings or profiling modes;
# they have no counterpart in the port
_TPU_ONLY = ("stop_after", "placement_phase", "matmul_dtype", "trigger_irfft",
             "placement_impl", "trigger_impl")
_COMPLEX_FIELDS = ("templates", "filter_response", "filter_response_int",
                   "trigger_filter_response")


def _ctype(dtype):
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def _fields(obj) -> dict:
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return obj._asdict()


def _convert_dataclass(obj, cls, **override):
    src = _fields(obj)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in src.items() if k in names}, **override)


def settings_from_jax(settings) -> PipelineSettings:
    """The port's PipelineSettings from the JAX package's (by field name).
    Where its ``triggers`` is empty, its single-trigger fields
    (``trigger_type``, ``highlow_coincidence``, ..., ``pa_*``) become the one
    ``TriggerSettings`` of the port's list, as the JAX pipeline builds it."""
    src = _fields(settings)
    if src.get("stop_after"):
        raise ValueError("stop_after is a TPU profiling mode; the port has none")
    if src.get("matmul_dtype", "float32") != "float32":
        raise ValueError("matmul_dtype other than float32 changes numbers and "
                         "is not ported")
    ice = _convert_dataclass(src["ice"], ice_models.IceModelSimple)
    triggers = (tuple(_convert_dataclass(t, TriggerSettings) for t in src["triggers"])
                or (_convert_dataclass(settings, TriggerSettings),))
    names = {f.name for f in dataclasses.fields(PipelineSettings)}
    kept = {k: v for k, v in src.items()
            if k in names and k not in _TPU_ONLY and k not in ("ice", "triggers")}
    return PipelineSettings(ice=ice, triggers=triggers, **kept)


def _tensor(value, dtype, device):
    if value is None:
        return None
    return torch.as_tensor(np.asarray(value), device=device).to(dtype)


def channels_from_jax(ch, *, device, dtype) -> ChannelParams:
    src = _fields(ch)
    out = {}
    for name in ChannelParams._fields:
        if name == "antenna_table":
            tab = src.get(name)
            out[name] = None if tab is None else AntennaTableParams(**{
                k: _tensor(v, _ctype(dtype) if k.startswith("h_") else dtype, device)
                for k, v in _fields(tab).items()})
        elif name == "kind":
            out[name] = _tensor(src[name], torch.int64, device)
        elif name in _COMPLEX_FIELDS:
            out[name] = _tensor(src.get(name), _ctype(dtype), device)
        elif name == "min_efield_amplitude" and np.all(np.asarray(src[name]) <= 0):
            out[name] = None          # the JAX package's "no cut"
        else:
            out[name] = _tensor(src.get(name), dtype, device)
    return ChannelParams(**out)


def batch_from_jax(batch, *, device, dtype) -> ShowerBatch:
    src = _fields(batch)
    kinds = {"is_em": torch.bool, "shower_mask": torch.bool,
             "profile_idx": torch.int64}
    return ShowerBatch(**{name: _tensor(src.get(name), kinds.get(name, dtype), device)
                          for name in ShowerBatch._fields})


def emitter_from_jax(emitter, *, device=device_util.DEFAULT, dtype=torch.float64):
    """The port's EmitterParams from the JAX package's (numpy leaves in,
    tensors out); None stays None."""
    if emitter is None:
        return None
    device = device_util.resolve(device)
    src = _fields(emitter)
    ctype = _ctype(dtype)
    kinds = {"templates": ctype, "unit_spec": ctype, "spice_specs": ctype,
             "rot": dtype, "spice_angles": dtype}
    return EmitterParams(**{k: _tensor(v, kinds[k], device) if k in kinds else v
                            for k, v in src.items()})


def library_from_jax(library, *, device=device_util.DEFAULT, dtype=torch.float64):
    """The port's ARZ ShowerLibrary (tensors) from the JAX package's; None
    stays None."""
    if library is None:
        return None
    device = device_util.resolve(device)
    return ShowerLibrary(**{k: _tensor(v, dtype, device)
                            for k, v in _fields(library).items()})


def from_jax(settings, ch, batch, *, device=device_util.DEFAULT, dtype=torch.float64):
    """(PipelineSettings, ChannelParams, ShowerBatch) of the port from the
    JAX package's, on ``device`` (the card unless "cpu" is asked for) in
    ``dtype``."""
    device = device_util.resolve(device)
    return (settings_from_jax(settings),
            channels_from_jax(ch, device=device, dtype=dtype),
            batch_from_jax(batch, device=device, dtype=dtype))


def _headline_numpy(n_groups, n_showers, n_channels, n_internal, n_base):
    """The numpy arrays of __graft_entry__._make_settings_and_inputs (:6-71),
    drawn in the same order from default_rng(0)."""
    rng = np.random.default_rng(0)
    freqs_int = np.fft.rfftfreq(n_internal, 1.0 / 2.0)
    freqs_base = np.fft.rfftfreq(n_base, 1.0 / 2.0)
    tpl = antenna.build_analytic_template("analytic_VPol", freqs_int)
    templates = np.broadcast_to(tpl[0], (n_channels, 3, len(freqs_int))).copy()
    rot = np.broadcast_to(
        antenna.antenna_rotation_matrix(0.0, 0.0, np.pi / 2, 0.0),
        (n_channels, 3, 3)).copy()
    chain = [((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
             ((0, 500 * units.MHz), "butter", {"order": 10})]
    filt = filters.chain_response(freqs_base, chain)
    filt_int = filters.chain_response(freqs_int, chain)
    ch = dict(
        positions=np.asarray(np.c_[np.zeros(n_channels), np.zeros(n_channels),
                                   -100.0 - 10 * np.arange(n_channels)], dtype=np.float32),
        cable_delays=np.zeros((n_channels,), dtype=np.float32),
        rot=np.asarray(rot, dtype=np.float32),
        kind=np.ones((n_channels,), dtype=np.int32),
        templates=np.asarray(templates, dtype=np.complex64),
        filter_response=np.asarray(np.broadcast_to(filt, (n_channels, len(freqs_base))),
                                   dtype=np.complex64),
        filter_response_int=np.asarray(
            np.broadcast_to(filt_int, (n_channels, len(freqs_int))), dtype=np.complex64),
        threshold_high=np.full((n_channels,), 2e-5, dtype=np.float32),
        threshold_low=np.full((n_channels,), -2e-5, dtype=np.float32),
        noise_amplitude=np.full((n_channels,), 1e-5, dtype=np.float32),
        min_efield_amplitude=np.zeros((n_channels,), dtype=np.float32),
    )
    rr = rng.uniform(100, 2000, (n_groups, n_showers))
    phi = rng.uniform(0, 2 * np.pi, (n_groups, n_showers))
    zz = rng.uniform(-2000, -100, (n_groups, n_showers))
    vert = np.stack([rr * np.cos(phi), rr * np.sin(phi), zz], axis=-1)
    zen = rng.uniform(0.3, 2.8, (n_groups, n_showers))
    az = rng.uniform(0, 2 * np.pi, (n_groups, n_showers))
    axis = np.stack([np.sin(zen) * np.cos(az), np.sin(zen) * np.sin(az),
                     np.cos(zen)], axis=-1)
    batch = dict(
        vertices=np.asarray(vert, dtype=np.float32),
        energies=np.full((n_groups, n_showers), 1e18, dtype=np.float32),
        is_em=np.zeros((n_groups, n_showers), dtype=bool),
        shower_mask=np.ones((n_groups, n_showers), dtype=bool),
        prop_dir=np.asarray(-axis, dtype=np.float32),
        k_L=np.full((n_groups, n_showers), 30.0, dtype=np.float32),
        vertex_times=np.zeros((n_groups, n_showers), dtype=np.float32),
    )
    return ch, batch


def make_headline_inputs(n_groups=8, n_showers=2, n_channels=4, n_internal=256,
                         n_base=512, *, device=device_util.DEFAULT, dtype=torch.float32):
    """(settings, ch, batch) of the headline workload as the port's types:
    the arrays of ``__graft_entry__._make_settings_and_inputs`` (float32
    there) moved to ``device`` (the card unless "cpu" is asked for) and cast
    to ``dtype``."""
    device = device_util.resolve(device)
    settings = PipelineSettings(
        ice=ice_models.southpole_2015,
        attenuation_model="SP1",
        askaryan_model="Alvarez2000",
        n_internal=n_internal, n_base=n_base, sampling_rate=2.0,
        n_freq_attenuation=16, attenuation_steps=8,
        max_detector_freq=0.5,
        n_bisect=28,
    )
    ch, batch = _headline_numpy(n_groups, n_showers, n_channels, n_internal, n_base)
    return (settings,
            channels_from_jax(ChannelParams(**ch), device=device, dtype=dtype),
            batch_from_jax(ShowerBatch(**batch), device=device, dtype=dtype))


# ---- the dipole 3000-event golden (tests/test_e2e.py, tests/test_torch_simulation.py)

DIPOLE_DETECTOR = {
    "channels": {"1": {
        "adc_n_samples": 256, "adc_sampling_frequency": 1.0,
        "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
        "ant_position_x": 0.0, "ant_position_y": 0.0, "ant_position_z": -100.0,
        "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
        "ant_type": "XFDTD_Vpol_CrossFeed_150mmHole_n1.78",
        "amp_type": "300", "cab_time_delay": 19.8, "adc_nbits": None,
        "channel_id": 0, "station_id": 101,
    }},
    "stations": {"1": {"pos_altitude": 0, "pos_easting": 0, "pos_northing": 0,
                       "pos_site": "southpole", "station_id": 101}},
}
DIPOLE_CONFIG = {"sampling_rate": 2.0, "propagation": {"ice_model": "southpole_2015"},
                 "signal": {"model": "Alvarez2000"},
                 "weights": {"weight_mode": "core_mantle_crust_simple",
                             "cross_section_type": "ctw"}}


def dipole_simulation(inputfilename, config=None, **kwargs):
    """The port's ``Simulation`` of the dipole golden: one VPol at 100 m, the
    butterworth chain, a 2-sigma high/low trigger (``config`` merged on top
    of DIPOLE_CONFIG; ``detector=`` replaces DIPOLE_DETECTOR; the other
    ``kwargs`` go to ``Simulation``)."""
    from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
    return Simulation(
        inputfilename, kwargs.pop("detector", DIPOLE_DETECTOR),
        config=config_util.merge_config(config, DIPOLE_CONFIG),
        filter_chain=[
            FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
            FilterStage((0, 500 * units.MHz), "butter", {"order": 10}),
        ],
        antenna_replacements={"XFDTD_Vpol_CrossFeed_150mmHole_n1.78": "analytic_VPol"},
        **{"trigger": TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
           **kwargs})


# ---- the phased-array workload (bench._pa_setup, tests/test_e2e_phased_array.py)

# a 4-channel RNO-G-style deep phased array, 1 m spacing below 197 m
PA_DETECTOR = {
    "channels": {str(i + 1): {
        "adc_n_samples": 256, "adc_sampling_frequency": 0.5, "adc_nbits": 8,
        "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
        "ant_position_x": 0.0, "ant_position_y": 0.0, "ant_position_z": -197.0 - i,
        "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
        "ant_type": "RNOG_vpol_v1_n1.73", "amp_type": "",
        "cab_time_delay": 1051.0, "channel_id": i, "station_id": 1,
    } for i in range(4)},
    "stations": {"1": {"station_id": 1, "pos_altitude": 0,
                       "pos_easting": 0, "pos_northing": 0}},
}
PA_CONFIG = {"sampling_rate": 2.0, "noise": True,
             "propagation": {"ice_model": "southpole_2015", "focusing": True},
             "signal": {"model": "Alvarez2009"},
             "weights": {"weight_mode": "core_mantle_crust_simple",
                         "cross_section_type": "ctw"}}


def pa_simulation(inputfilename, config=None, **kwargs):
    """The port's ``Simulation`` of the phased-array workload: PA_DETECTOR,
    PA_CONFIG (``config`` merged on top), the cheby1 chain and the default
    phased-array trigger; ``kwargs`` go to ``Simulation``."""
    from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
    return Simulation(
        inputfilename, PA_DETECTOR,
        config=config_util.merge_config(config, PA_CONFIG),
        filter_chain=[
            FilterStage((96 * units.MHz, 100 * units.GHz), "cheby1", {"order": 4, "rp": 0.1}),
            FilterStage((0, 220 * units.MHz), "cheby1", {"order": 7, "rp": 0.1}),
        ],
        antenna_replacements={"RNOG_vpol_v1_n1.73": "analytic_VPol"},
        **{"trigger": TriggerSpec(trigger_type="phased_array"), **kwargs})


def multitrigger_simulation(inputfilename, config=None, **kwargs):
    """The port's ``Simulation`` of the multi-trigger station
    (tests/test_e2e_multitrigger.py): PA_DETECTOR, PA_CONFIG without noise
    (``config`` merged on top), the cheby1 chain and three named triggers in
    one pass: a 2-sigma high/low on all channels, a 3-sigma simple threshold
    on channels (0, 1) and the phased array; ``kwargs`` go to ``Simulation``
    (``triggers=`` replaces the list)."""
    from nuradiomc_tpu_torch.sim.simulation import TriggerSpec
    kwargs.setdefault("triggers", [
        TriggerSpec(name="hilo_2sig", trigger_type="high_low",
                    threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
        TriggerSpec(name="simple_3sig", trigger_type="simple_threshold",
                    channels=(0, 1), threshold_high_sigma=3.0),
        TriggerSpec(name="PA_4channel", trigger_type="phased_array"),
    ])
    return pa_simulation(inputfilename,
                         config_util.merge_config(config, {"noise": False}), **kwargs)


def narrow_trigger_chain():
    """The separate trigger chain of tests/test_trigger_channels.py, narrower
    than the dipole workload's readout chain: pass it to
    :func:`dipole_simulation` as ``trigger_filter_chain=``."""
    from nuradiomc_tpu_torch.sim.simulation import FilterStage
    return [FilterStage((120 * units.MHz, 1000 * units.GHz), "butter", {"order": 4}),
            FilterStage((0, 300 * units.MHz), "butter", {"order": 8})]


def make_pa_inputs(n_groups=16384, *, device=device_util.DEFAULT, dtype=torch.float32):
    """(settings, ch, batch) of ``bench.bench_pa``: the 3000 groups of the
    1e18 eV input (its ``.npz`` export) with the bench's solver settings,
    tiled to ``n_groups``, band limit 1e-3, noise on."""
    import dataclasses as dc

    from nuradiomc_tpu_torch.sim.io_input import INPUT_1E18_N3000
    sim = pa_simulation(
        INPUT_1E18_N3000,
        {"propagation": {"n_freq": 16, "attenuation_steps": 8, "n_bisect": 28}},
        device=device, dtype=dtype)
    batch = _tiled(sim._build_batches()[-1], n_groups, sim.device)
    return dc.replace(sim.settings, band_limit_eps=1e-3), sim.channel_params, batch


def make_multitrigger_inputs(n_groups=16384, *, device=device_util.DEFAULT,
                             dtype=torch.float32):
    """(settings, ch, batch) of the multi-trigger slice: the batch, channels
    and solver settings of :func:`make_pa_inputs` with a list of ten named
    triggers in one pass: an 8-rung high/low threshold ladder (2 to 5.5
    sigma), a 3-sigma simple threshold on channels (0, 1) and the digitized
    phased array."""
    import dataclasses as dc

    from nuradiomc_tpu_torch.sim.io_input import INPUT_1E18_N3000
    from nuradiomc_tpu_torch.sim.simulation import TriggerSpec
    ladder = [TriggerSpec(name=f"hilo_{sig:g}sig", threshold_high_sigma=sig,
                          threshold_low_sigma=-sig) for sig in np.arange(2.0, 6.0, 0.5)]
    sim = pa_simulation(
        INPUT_1E18_N3000,
        {"propagation": {"n_freq": 16, "attenuation_steps": 8, "n_bisect": 28}},
        triggers=ladder + [
            TriggerSpec(name="simple_3sig", trigger_type="simple_threshold", channels=(0, 1),
                        threshold_high_sigma=3.0),
            TriggerSpec(name="PA_4channel", trigger_type="phased_array")],
        device=device, dtype=dtype)
    batch = _tiled(sim._build_batches()[-1], n_groups, sim.device)
    return dc.replace(sim.settings, band_limit_eps=1e-3), sim.channel_params, batch


def _tiled(batch0, n_groups, device):
    """The numpy batch tiled (or cut) to ``n_groups`` groups, on ``device``."""
    reps = -(-n_groups // batch0.energies.shape[0])
    return ShowerBatch(*[None if a is None else torch.as_tensor(
        np.ascontiguousarray(np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:n_groups]),
        device=device) for a in batch0])


# ---- the Gen2 composed workload (bench._gen2_setup, tests/test_gen2_array.py)

def _gen2_channel(cid, sid, z):
    return {"adc_n_samples": 256, "adc_sampling_frequency": 1.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
            "ant_position_x": 0.0, "ant_position_y": 0.0, "ant_position_z": z,
            "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
            "ant_type": "analytic_VPol", "amp_type": "",
            "cab_time_delay": 10.0, "adc_nbits": None,
            "channel_id": cid, "station_id": sid}


# three deep stations of two VPols (100 m and 150 m) on a 1.7 km triangle
GEN2_DETECTOR = {
    "channels": {
        "1": _gen2_channel(0, 101, -100.0), "2": _gen2_channel(1, 101, -150.0),
        "3": _gen2_channel(0, 102, -100.0), "4": _gen2_channel(1, 102, -150.0),
        "5": _gen2_channel(0, 103, -100.0), "6": _gen2_channel(1, 103, -150.0),
    },
    "stations": {
        "1": {"station_id": 101, "pos_easting": 0.0, "pos_northing": 0.0, "pos_altitude": 0},
        "2": {"station_id": 102, "pos_easting": 1700.0, "pos_northing": 0.0,
              "pos_altitude": 0},
        "3": {"station_id": 103, "pos_easting": 850.0, "pos_northing": 1470.0,
              "pos_altitude": 0},
    },
}
GEN2_CONFIG = {"sampling_rate": 2.0,
               "propagation": {"ice_model": "southpole_2015", "birefringence": True,
                               "birefringence_model": "southpole_A",
                               "n_freq": 16, "attenuation_steps": 8, "n_bisect": 28},
               "signal": {"model": "Alvarez2000"},
               "weights": {"weight_mode": "core_mantle_crust_simple",
                           "cross_section_type": "ctw"}}


def gen2_simulation(inputfilename, config=None, **kwargs):
    """The port's ``Simulation`` of the Gen2 composed workload: GEN2_DETECTOR,
    GEN2_CONFIG (``config`` merged on top; birefringence on), the butterworth
    chain and a 2-sigma high/low trigger (``kwargs`` go to ``Simulation``)."""
    from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
    return Simulation(
        inputfilename, GEN2_DETECTOR,
        config=config_util.merge_config(config, GEN2_CONFIG),
        filter_chain=[
            FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
            FilterStage((0, 500 * units.MHz), "butter", {"order": 10}),
        ],
        trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
        **kwargs)


def make_gen2_inputs(n_groups=256, *, device=device_util.DEFAULT, dtype=torch.float32):
    """(settings, [ch per station], batch) of ``bench.bench_gen2``: the first
    ``n_groups`` groups of the 2048-event tau input (its ``.npz`` export;
    tiled past 2048) for the three stations, birefringence on."""
    from nuradiomc_tpu_torch.sim.io_input import INPUT_GEN2
    sim = gen2_simulation(INPUT_GEN2, device=device, dtype=dtype)
    chps = [sim.channel_params_per_station[sid] for sid in sim.det.get_station_ids()]
    return sim.settings, chps, _tiled(sim._build_batches()[-1], n_groups, sim.device)


# the gen2 cell's deep stations (portbench/configs/gen2_birefringence.json):
# positions (x, y) in m and the phased-array VPols' depths
GEN2_DEEP_STATIONS = ((0.0, 0.0), (1700.0, 0.0), (850.0, 1470.0))
GEN2_DEEP_DEPTHS = (-197.0, -198.0, -199.0, -200.0)


def gen2_birefringence_paths(n_paths=4096, *, n_points=256, seed=29,
                             device=device_util.DEFAULT, dtype=torch.float64):
    """[n_paths, n_points, 3]: the first ``n_paths`` valid ray paths
    (``birefringence.path_points_3d``) from vertices of the gen2 cell's
    volume (r < 3 km, -2.7 km < z < 0), drawn by numpy from ``seed``, to the
    deep VPols of its three stations."""
    from nuradiomc_tpu_torch.ops import birefringence, raytrace

    rng = np.random.default_rng(seed)
    ice = ice_models.southpole_2015
    receivers = np.array([(x, y, z) for x, y in GEN2_DEEP_STATIONS for z in GEN2_DEEP_DEPTHS])
    paths, n_found = [], 0
    while n_found < n_paths:
        n = max(n_paths // 2, 256)
        r, phi = 3e3 * np.sqrt(rng.uniform(0, 1, n)), rng.uniform(0, 2 * np.pi, n)
        x1 = np.c_[r * np.cos(phi), r * np.sin(phi), rng.uniform(-2700.0, 0.0, n)]
        x2 = receivers[rng.integers(0, len(receivers), n)]
        g = raytrace.to_2d(*(torch.as_tensor(x, dtype=dtype, device=device) for x in (x1, x2)))
        sols = raytrace.find_solutions(g.x1y, g.x1z, g.x2y, g.x2z, ice)
        sel = torch.nonzero(sols.mask.reshape(-1)).squeeze(1)
        geom = raytrace.Geometry2D(*(f[:, None].expand(n, 2).reshape(-1)[sel] for f in g))
        paths.append(birefringence.path_points_3d(sols.c0.reshape(-1)[sel], geom, ice, n_points))
        n_found += sel.shape[0]
    return torch.cat(paths)[:n_paths]


def make_birefringence_scan_inputs(path, *, n_freq=513, seed=29):
    """The segment scan's operands (spec_theta, spec_phi, cpsi, spsi, k1sq,
    k2sq, dt_rel, ok, frequencies) along ``path`` [P, K, 3]
    (``birefringence.segment_parameters``), with standard normal spectra
    drawn by numpy from ``seed`` at ``n_freq`` frequencies from 0 to the
    0.5 ns grid's 1 GHz (the gen2 cell's 513), on the path's device and in
    its dtype."""
    from nuradiomc_tpu_torch.ops import birefringence

    rng = np.random.default_rng(seed)
    P, dtype, device = path.shape[0], path.dtype, path.device
    specs = [torch.as_tensor(rng.standard_normal((P, n_freq))
                             + 1j * rng.standard_normal((P, n_freq)),
                             dtype=_ctype(dtype), device=device) for _ in range(2)]
    ff = torch.as_tensor(np.arange(n_freq) / max(n_freq - 1, 1), dtype=dtype, device=device)
    return (*specs, *birefringence.segment_parameters(path, ice_models.southpole_2015), ff)


# ---- the reflective-bottom workload (Moore's Bay, an ARIANNA-style station)

def _mooresbay_channel(cid, x, y, rotation_phi):
    # a downward-pointing LPDA 2 m below the snow surface
    return {"adc_n_samples": 256, "adc_sampling_frequency": 1.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": 180.0,
            "ant_position_x": x, "ant_position_y": y, "ant_position_z": -2.0,
            "ant_rotation_phi": rotation_phi, "ant_rotation_theta": 90.0,
            "ant_type": "analytic_LPDA", "amp_type": "",
            "cab_time_delay": 0.0, "adc_nbits": None,
            "channel_id": cid, "station_id": 61}


# four LPDAs on the corners of a 6 m square, two orthogonal pairs
MOORESBAY_DETECTOR = {
    "channels": {"1": _mooresbay_channel(0, 3.0, 3.0, 0.0),
                 "2": _mooresbay_channel(1, -3.0, 3.0, 90.0),
                 "3": _mooresbay_channel(2, -3.0, -3.0, 0.0),
                 "4": _mooresbay_channel(3, 3.0, -3.0, 90.0)},
    "stations": {"1": {"station_id": 61, "pos_altitude": 0, "pos_easting": 0,
                       "pos_northing": 0, "pos_site": "mooresbay"}},
}
MOORESBAY_CONFIG = {"sampling_rate": 2.0, "noise": False,
                    "propagation": {"ice_model": "mooresbay_simple",
                                    "attenuation_model": "MB1", "n_reflections": 1,
                                    "n_freq": 16, "attenuation_steps": 8, "n_bisect": 28},
                    "signal": {"model": "Alvarez2000"},
                    "weights": {"weight_mode": "core_mantle_crust_simple",
                                "cross_section_type": "ctw"}}
MOORESBAY_RADIUS = 1.5 * units.km
MOORESBAY_DEPTH = 576.0 * units.m


def mooresbay_event_input(n_groups, seed=0, energy=1e18 * units.eV):
    """An in-memory event list of ``n_groups`` electron-neutrino CC
    interactions (a hadronic and an electromagnetic shower each, sharing
    the vertex) uniform in a cylinder of MOORESBAY_RADIUS between the
    reflector at -576 m and the surface, isotropic arrival directions, all
    drawn from ``default_rng(seed)`` one group after the other: a shorter
    list is a prefix of a longer one."""
    from nuradiomc_tpu_torch.sim.io_hdf5 import EventInput
    u = np.random.default_rng(seed).uniform(0, 1, (n_groups, 6))
    r = MOORESBAY_RADIUS * np.sqrt(u[:, 0])
    phi = 2 * np.pi * u[:, 1]
    z = -MOORESBAY_DEPTH * u[:, 2]
    zen = np.arccos(2 * u[:, 3] - 1)
    az = 2 * np.pi * u[:, 4]
    y = 0.1 + 0.8 * u[:, 5]

    def twice(a):
        return np.repeat(a, 2)

    n = 2 * n_groups
    return EventInput(
        event_group_ids=twice(np.arange(n_groups)), shower_ids=np.arange(n),
        xx=twice(r * np.cos(phi)), yy=twice(r * np.sin(phi)), zz=twice(z),
        zeniths=twice(zen), azimuths=twice(az), energies=np.full(n, energy),
        shower_energies=np.stack([y * energy, (1 - y) * energy], axis=-1).reshape(-1),
        shower_type=np.tile(np.array(["had", "em"]), n_groups),
        flavors=np.full(n, 12), interaction_type=np.full(n, "cc"),
        inelasticity=twice(y), vertex_times=np.zeros(n),
        attrs={"n_events": n_groups,
               "volume": np.pi * MOORESBAY_RADIUS ** 2 * MOORESBAY_DEPTH})


def mooresbay_simulation(inputfilename, config=None, **kwargs):
    """The port's ``Simulation`` of the Moore's Bay workload: MOORESBAY_DETECTOR,
    MOORESBAY_CONFIG (``config`` merged on top: one bottom reflection, so six
    ray slots and three readout windows; MB1 attenuation), the butterworth
    chain and a 2-of-4 high/low trigger at 4 sigma; ``kwargs`` go to
    ``Simulation``. ``inputfilename`` may be an in-memory ``EventInput``."""
    from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
    return Simulation(
        inputfilename, MOORESBAY_DETECTOR,
        config=config_util.merge_config(config, MOORESBAY_CONFIG),
        filter_chain=[
            FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
            FilterStage((0, 500 * units.MHz), "butter", {"order": 10}),
        ],
        **{"trigger": TriggerSpec(name="LPDA_2of4_4sigma", threshold_high_sigma=4.0,
                                  threshold_low_sigma=-4.0, number_of_coincidences=2),
           **kwargs})


def make_mooresbay_inputs(n_groups=16384, seed=0, *, device=device_util.DEFAULT,
                          dtype=torch.float32):
    """(settings, ch, batch) of the Moore's Bay slice, from numpy alone:
    ``n_groups`` groups of :func:`mooresbay_event_input` (2 showers) seen by
    the 4 LPDAs of :func:`mooresbay_simulation`, band limit 1e-2."""
    import dataclasses as dc
    sim = mooresbay_simulation(mooresbay_event_input(n_groups, seed), device=device,
                               dtype=dtype)
    batch = sim._build_batches()[-1]
    batch = ShowerBatch(*[None if a is None else torch.as_tensor(
        np.ascontiguousarray(a), device=sim.device) for a in batch])
    return dc.replace(sim.settings, band_limit_eps=1e-2), sim.channel_params, batch


# ---- the emitter runs (tests/test_emitter_e2e.py: 24 pulser positions)

def _surface_channel(cid, ant_type, x, y, z, ori_theta, rot_theta, rot_phi):
    return {"adc_n_samples": 512, "adc_sampling_frequency": 1.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": ori_theta,
            "ant_position_x": x, "ant_position_y": y, "ant_position_z": z,
            "ant_rotation_phi": rot_phi, "ant_rotation_theta": rot_theta,
            "ant_type": ant_type, "amp_type": "", "cab_time_delay": 0.0,
            "adc_nbits": None, "channel_id": cid, "station_id": 101}


# a surface station of 4 downward LPDAs and 4 vertical dipoles, as the
# SingleEvents test station is laid out
SURFACE_DETECTOR = {
    "channels": {
        **{str(i + 1): _surface_channel(i, "analytic_LPDA", x, y, -2.0, 180.0, 90.0, rp)
           for i, (x, y, rp) in enumerate([(3.0, 0.0, 0.0), (0.0, 3.0, 90.0),
                                           (-3.0, 0.0, 0.0), (0.0, -3.0, 90.0)])},
        **{str(i + 5): _surface_channel(i + 4, "analytic_VPol", x, y, -5.0, 0.0, 90.0, 90.0)
           for i, (x, y) in enumerate([(5.0, 5.0), (-5.0, 5.0), (-5.0, -5.0), (5.0, -5.0)])},
    },
    "stations": {"1": {"station_id": 101, "pos_altitude": 0, "pos_easting": 0,
                       "pos_northing": 0, "pos_site": "southpole"}},
}
EMITTER_CONFIG = {"sampling_rate": 5.0, "noise": False,
                  "speedup": {"minimum_weight_cut": 1e-5, "min_efield_amplitude": 2},
                  "propagation": {"ice_model": "ARAsim_southpole", "focusing": True},
                  "signal": {"model": "Alvarez2000"},
                  "trigger": {"noise_temperature": 300}}
EMITTER_ANTENNAS = {"createLPDA_100MHz_InfFirn": "analytic_LPDA",
                    "bicone_v8_InfFirn": "analytic_VPol"}


def emitter_simulation(inputfilename, config=None, **kwargs):
    """The port's ``Simulation`` of an emitter input on SURFACE_DETECTOR with
    the emitter test's config, filters and two named triggers (a 3-sigma
    threshold on all channels, a 2-of-4 high/low at 2 sigma on the dipoles);
    ``kwargs`` go to ``Simulation``."""
    from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
    kwargs.setdefault("triggers", [
        TriggerSpec(name="simple_threshold", trigger_type="simple_threshold",
                    threshold_high_sigma=3.0, number_of_coincidences=1),
        TriggerSpec(name="dipoles_2of4_2sigma", trigger_type="high_low",
                    threshold_high_sigma=2.0, threshold_low_sigma=-2.0,
                    channels=(4, 5, 6, 7), number_of_coincidences=2)])
    kwargs.setdefault("antenna_replacements", EMITTER_ANTENNAS)
    return Simulation(
        inputfilename, SURFACE_DETECTOR,
        config=config_util.merge_config(config, EMITTER_CONFIG),
        filter_chain=[
            FilterStage((80 * units.MHz, 1000 * units.GHz), "butter", {"order": 2}),
            FilterStage((0, 500 * units.MHz), "butter", {"order": 10}),
        ], **kwargs)


# ---- a tabulated antenna, the ARZ shower model (chip_smoke.py phase 9)

SYNTHETIC_TABLE = "synthetic_table"
# copied from tests/test_antenna_table.py:24-70 (_perp, _angles,
# _make_synthetic_pickle)
def write_synthetic_antenna_pickle(path, ori=(0.0, 0.0), rot=None):
    """A reference-format 9-item antenna pickle on a uniform grid with
    smooth complex VELs; flat layout iFreq*n_theta*n_phi + iPhi*n_theta +
    iTheta (antennapattern.py:1423)."""
    import pickle

    freqs = np.linspace(0.05, 1.2, 24)
    thetas = np.linspace(0.0, np.pi, 25)
    phis = np.linspace(0.0, 2 * np.pi, 37)
    F, T, P = len(freqs), len(thetas), len(phis)
    iF, iP, iT = np.meshgrid(np.arange(F), np.arange(P), np.arange(T), indexing="ij")
    ff, ph, th = freqs[iF].ravel(), phis[iP].ravel(), thetas[iT].ravel()
    h_theta = (0.2 + ff) * np.sin(th) * np.exp(1j * (0.3 * ph + 0.7 * th + 2.0 * ff))
    h_phi = (0.1 + 0.5 * ff) * np.cos(0.5 * th) * np.exp(1j * (0.2 * ph - 0.4 * th))

    o_vec = np.array([np.sin(ori[0]) * np.cos(ori[1]),
                      np.sin(ori[0]) * np.sin(ori[1]), np.cos(ori[0])])
    if rot is None:
        a = np.array([1.0, 0.0, 0.0])
        if abs(np.dot(a, o_vec)) > 0.9:
            a = np.array([0.0, 1.0, 0.0])
        rot = np.cross(o_vec, a)
        rot = rot / np.linalg.norm(rot)
    rt, rp = float(np.arccos(rot[2] / np.linalg.norm(rot))), float(np.arctan2(rot[1], rot[0]))
    with open(path, "wb") as f:
        pickle.dump([ori[0], ori[1], rt, rp, ff, th, ph, h_phi, h_theta], f, protocol=4)
    return path


def table_simulation(inputfilename, models_path, config=None, **kwargs):
    """The dipole golden's station with a tabulated antenna: writes the
    synthetic pattern to ``models_path/synthetic_table/synthetic_table.pkl``
    and runs :func:`dipole_simulation` with that antenna model, which enters
    the non-factored chain."""
    import copy
    import os
    os.makedirs(os.path.join(models_path, SYNTHETIC_TABLE), exist_ok=True)
    write_synthetic_antenna_pickle(
        os.path.join(models_path, SYNTHETIC_TABLE, SYNTHETIC_TABLE + ".pkl"))
    det = copy.deepcopy(DIPOLE_DETECTOR)
    det["channels"]["1"]["ant_type"] = SYNTHETIC_TABLE
    return dipole_simulation(inputfilename, config, detector=det,
                             antenna_models_path=str(models_path), **kwargs)


def arz_simulation(inputfilename, config=None, **kwargs):
    """:func:`dipole_simulation` with the ARZ2020 shower model on the
    committed mini shower library."""
    from nuradiomc_tpu_torch.sim.io_input import DATA_DIR
    kwargs.setdefault("arz_library_path", str(DATA_DIR / "arz_minilib.pkl"))
    return dipole_simulation(
        inputfilename, config_util.merge_config(config, {"signal": {"model": "ARZ2020"}}),
        **kwargs)


# ---- NuRadioMC's production-scale Veff campaigns (tests/test_veff_fullscale.py)

# the reference's CI campaign test/Veff/1e18eV: 50,000 events at 1e18 eV,
# seed 10, r < 4 km, -2.7 km < z < 0 (tests/golden/veff_fullscale_reference.npz)
FULLSCALE_LIST = dict(n_events=50000, volume={
    "fiducial_rmin": 0, "fiducial_rmax": 4 * units.km,
    "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0})
# its noisy deep phased-array variant: 10,000 events, r < 3 km, -2 km < z < 0
# (tests/golden/veff_fullscale_pa_reference.npz)
FULLSCALE_PA_LIST = dict(n_events=10000, volume={
    "fiducial_rmin": 0, "fiducial_rmax": 3 * units.km,
    "fiducial_zmin": -2 * units.km, "fiducial_zmax": 0})


def fullscale_event_list(campaign=FULLSCALE_LIST, seed=10):
    """``(data, attributes)`` of a campaign's event list, generated in memory
    by the port's ``evtgen`` at 1e18 eV with the CTW cross sections (the
    golden's ``input_sha1`` is ``evtgen.list_digest`` of ``data``)."""
    from nuradiomc_tpu_torch.sim import evtgen
    return evtgen.generate_eventlist_cylinder(
        None, campaign["n_events"], 1e18 * units.eV, 1e18 * units.eV, campaign["volume"],
        seed=seed, cross_sections_model="ctw")


def fullscale_simulation(event_input, config=None, **kwargs):
    """The port's ``Simulation`` of the dipole campaign
    (tests/test_veff_fullscale.py:38-52, :94-114): the station, config,
    filters, trigger and antenna replacement of :func:`dipole_simulation`,
    in chunks of 2048 groups; ``event_input`` may be an in-memory
    ``EventInput`` (``io_input.from_generated``)."""
    return dipole_simulation(event_input, config, **{"chunk_size": 2048, **kwargs})


# ---- a BGR18/HEDIS cross-section table of the published schema ---------------

# dsigma/dy = A(E) y^BGR18_SLOPE per (flavor, nc/cc) on the grids of
# tests/test_bgr18.py: sigma(E) = A(E) / (B + 1) and the inelasticity CDF is
# y^(B + 1), closed forms to hold the table machinery to. The published
# BGR18_dsigma_dy_H2O.npz (a NuRadioMC data-server download) has this schema;
# point sim/cross_sections.set_bgr18_table_path at either.
BGR18_SLOPE = -0.7
BGR18_FLAVORS = np.array([12, -12, 14, -14, 16, -16])
BGR18_ENERGIES = np.logspace(15, 20, 21)     # eV
BGR18_Y = np.logspace(-4, 0, 200)


def _bgr18_amplitude(e_idx, i_flavor, i_nccc):
    """A(E) of the synthetic table: an energy power law, a distinct
    normalization per flavor and per nc (i_nccc 0) / cc (1)."""
    return (1e-33 * (BGR18_ENERGIES[e_idx] / 1e18) ** 0.36
            * (1.0 + 0.1 * i_flavor) * (1.0 if i_nccc else 0.4))


def make_bgr18_table(path):
    """Write the synthetic table (per ice nucleus, in cm^2, as the published
    file) to ``path`` (.npz) and return ``path``."""
    dsdy = np.zeros((len(BGR18_FLAVORS), 2, len(BGR18_ENERGIES), len(BGR18_Y)))
    for iF in range(len(BGR18_FLAVORS)):
        for iI in range(2):
            for iE in range(len(BGR18_ENERGIES)):
                dsdy[iF, iI, iE] = _bgr18_amplitude(iE, iF, iI) * BGR18_Y ** BGR18_SLOPE
    with open(path, "wb") as f:
        np.savez(f, dsigma_dy_ref=dsdy, nu_energies_ref=BGR18_ENERGIES, y_ref=BGR18_Y,
                 flavors_ref=BGR18_FLAVORS, ncccs_ref=np.array(["NC", "CC"]))
    return path


# the campaign's four RNO-G VPols below 197 m, 5 ns more cable per channel
FULLSCALE_PA_DETECTOR = {
    "channels": {str(i + 1): {**PA_DETECTOR["channels"][str(i + 1)],
                              "cab_time_delay": 1051.0 + 5.0 * i} for i in range(4)},
    "stations": PA_DETECTOR["stations"],
}
FULLSCALE_PA_CONFIG = {"sampling_rate": 2.0, "noise": True,
                       "propagation": {"ice_model": "southpole_2015", "focusing": True},
                       "signal": {"model": "Alvarez2009"},
                       "speedup": {"min_efield_amplitude": 2},
                       "weights": {"weight_mode": "core_mantle_crust",
                                   "cross_section_type": "ctw"}}


def fullscale_pa_simulation(event_input, config=None, **kwargs):
    """The port's ``Simulation`` of the noisy deep phased-array campaign
    (tests/test_veff_fullscale.py:151-198): FULLSCALE_PA_DETECTOR (mapped to
    analytic_VPol), FULLSCALE_PA_CONFIG (``config`` merged on top), the
    cheby1 chain and the phased-array trigger, in chunks of 1024 groups."""
    from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
    return Simulation(
        event_input, FULLSCALE_PA_DETECTOR,
        config=config_util.merge_config(config, FULLSCALE_PA_CONFIG),
        filter_chain=[
            FilterStage((96 * units.MHz, 100 * units.GHz), "cheby1", {"order": 4, "rp": 0.1}),
            FilterStage((0, 220 * units.MHz), "cheby1", {"order": 7, "rp": 0.1}),
        ],
        antenna_replacements={"RNOG_vpol_v1_n1.73": "analytic_VPol"},
        **{"trigger": TriggerSpec(trigger_type="phased_array"), "chunk_size": 1024, **kwargs})


# ---- NuRadioMC's atmospheric-muon campaign (test/atmospheric_Aeff/1e18eV) ------

# the generator's arguments of tests/test_atmospheric_aeff.py: 2500 muons at
# 1e18 eV entering the top of a 4 km x 3 km cylinder at 58-62 deg zenith, their
# in-ice losses from the stochastic propagator (sim/muon_propagation.py)
SURFACE_MUON_LIST = dict(n_events=2500, Emin=1e18 * units.eV, Emax=1e18 * units.eV,
                         volume={"fiducial_rmin": 0, "fiducial_rmax": 4 * units.km,
                                 "fiducial_zmin": -3 * units.km, "fiducial_zmax": 0},
                         thetamin=np.deg2rad(58), thetamax=np.deg2rad(62), seed=42,
                         secondaries="stochastic")
# NuRadioMC's anchor: Aeff over 256 re-runs, mean and spread (T03check_output.py:44-47)
SURFACE_MUON_AEFF = (0.45027 * units.km ** 2, 0.06549 * units.km ** 2)


def surface_muon_event_list(n_events=None, secondaries=None):
    """The surface-muon campaign's list in memory, ``(data, attrs)``
    (``SURFACE_MUON_LIST``, optionally with fewer muons or another
    secondaries mode)."""
    from nuradiomc_tpu_torch.sim import evtgen
    kw = dict(SURFACE_MUON_LIST)
    if n_events is not None:
        kw["n_events"] = n_events
    if secondaries is not None:
        kw["secondaries"] = secondaries
    n = kw.pop("n_events")
    return evtgen.generate_surface_muons(None, n, kw.pop("Emin"), kw.pop("Emax"),
                                         kw.pop("volume"), **kw)


def surface_muon_simulation(event_input, config=None, **kwargs):
    """The surface-muon campaign's ``Simulation``: the dipole golden's
    station, chain and 2-sigma high/low trigger (T01/T02 of
    test/atmospheric_Aeff/1e18eV), chunks of 256 groups; its results carry
    ``aeff``."""
    return dipole_simulation(event_input, config, **{"chunk_size": 256, **kwargs})


def gen2_tau_event_list(n_events=2048, seed=21):
    """``(data, attributes)`` of the Gen2 workload's input (bench.py:492-497):
    ν_τ CC at 1e19 eV in r < 3 km, -2.7 km < z < 0 with stochastic tau and
    muon secondaries; ``io_input.INPUT_GEN2`` is the export of the 2048-event
    list."""
    from nuradiomc_tpu_torch.sim import evtgen
    return evtgen.generate_eventlist_cylinder(
        None, n_events, 1e19, 1e19,
        {"fiducial_rmin": 0, "fiducial_rmax": 3 * units.km,
         "fiducial_zmin": -2.7 * units.km, "fiducial_zmax": 0},
        seed=seed, flavor=(16, -16), interaction_type="cc", secondaries="stochastic")


# ---- arrivals on the analytic LPDA's phase-sector edges

# 135 deg zenith is 45 deg off a downward LPDA's axis, the edge of its first
# two phase sectors; one arrival per azimuth (60 deg is examples.IFT_TRUTH's)
LPDA_EDGE_ZENITH = np.deg2rad(135.0)
LPDA_EDGE_AZIMUTHS = np.deg2rad(np.arange(0.0, 360.0, 15.0))


def lpda_edge_receive_vectors():
    """The receive directions [A, 3] of the edge arrivals, in numpy float64:
    the same numbers on every device."""
    az = LPDA_EDGE_AZIMUTHS
    st = np.sin(LPDA_EDGE_ZENITH)
    return np.stack([st * np.cos(az), st * np.sin(az),
                     np.full_like(az, np.cos(LPDA_EDGE_ZENITH))], axis=-1)


def make_lpda_edge_inputs(*, device=device_util.DEFAULT, dtype=torch.float64):
    """(settings, ch, batch, launch_receive_vectors) of the dipole
    configuration on ``reco.examples.MIXED_DETECTOR``'s four downward LPDAs,
    one group per edge arrival. The returned function stands in for
    ``raytrace.launch_receive_vectors`` in ``simulate_batch``: it keeps the
    launch vectors and puts group g's arrival at every (shower, channel,
    slot), so each LPDA sees a direction on a sector edge."""
    from nuradiomc_tpu_torch.ops import raytrace
    from nuradiomc_tpu_torch.reco import examples
    n = len(LPDA_EDGE_AZIMUTHS)
    sim = dipole_simulation(mooresbay_event_input(n), detector=examples.MIXED_DETECTOR,
                            device=device, dtype=dtype)
    batch = ShowerBatch(*[None if a is None else torch.as_tensor(
        np.ascontiguousarray(a), device=sim.device) for a in sim._build_batches()[-1]])
    arrivals = lpda_edge_receive_vectors()
    solver_vectors = raytrace.launch_receive_vectors

    def launch_receive_vectors(geom, sols):
        launch, receive = solver_vectors(geom, sols)
        edge = torch.as_tensor(arrivals[:receive.shape[0]], dtype=receive.dtype,
                               device=receive.device)
        return launch, edge[:, None, None, None, :].expand(receive.shape).contiguous()

    return sim.settings, sim.channel_params, batch, launch_receive_vectors


# ---- the cosmic-ray side: in-memory inputs (no files, no h5py)

LOFAR_FS = 0.2                                  # LBA: 200 MHz in internal GHz
LOFAR_SUPERTERP = (2, 3, 4, 5, 6, 7)            # CS002-CS007


class LofarDetector:
    """Duck-typed LOFAR detector (tests/test_lofar.py's FakeLOFARDetector) for
    several stations: per station ``n_ant`` dual-polarised antennas in the
    z=0 plane, drawn uniform in a square of half-width ``half_width``;
    channel 2k (Y dipole, 135 deg) and 2k+1 (X dipole, 225 deg) belong to
    antenna k and to channel group 2k; ``readout_samples`` at 200 MHz is
    the readout window of every channel."""

    def __init__(self, n_ant=24, seed=0, station_ids=(2,), half_width=150.0,
                 readout_samples=65536):
        rng = np.random.default_rng(seed)
        self.n_ant = n_ant
        self.readout_samples = readout_samples
        self.positions = {}
        for sid in station_ids:
            pos = np.zeros((n_ant, 3))
            pos[:, :2] = rng.uniform(-half_width, half_width, (n_ant, 2))
            self.positions[sid] = pos

    def get_relative_position(self, station_id, channel_id):
        return self.positions[station_id][channel_id // 2]

    def get_antenna_orientation(self, station_id, channel_id):
        phi = 135.0 if channel_id % 2 == 0 else 225.0
        return np.deg2rad([90.0, phi, 90.0, phi + 90.0])

    def get_number_of_channels(self, station_id):
        return 2 * self.n_ant

    def get_number_of_samples(self, station_id, channel_id):
        return self.readout_samples

    def get_sampling_frequency(self, station_id, channel_id):
        return LOFAR_FS

    def get_site_coordinates(self, station_id=None):
        return 52.91, 6.87  # LOFAR core


def make_lofar_station(ev, det, station_id, zenith, azimuth, n_samples=8192, noise=0.05,
                       pulse_sample=6000, seed=1, cw_lines=()):
    """One station of ``det`` as a framework Station of the event module
    ``ev`` (the port's or the JAX package's): tests/test_lofar.py's
    make_event, a plane-wave Gaussian-modulated pulse from (zenith,
    azimuth) on the even (dominant) channels over Gaussian noise, plus
    phase-stable CW lines ``cw_lines`` = ((frequency, amplitude), ...) with
    one fixed phase per (line, channel)."""
    rng = np.random.default_rng(seed)
    n_dir = np.array([np.sin(zenith) * np.cos(azimuth),
                      np.sin(zenith) * np.sin(azimuth), np.cos(zenith)])
    delays = -(det.positions[station_id] @ n_dir) / 0.299792458    # ns
    tt = np.arange(n_samples) / LOFAR_FS
    cw = [(f, a, rng.uniform(0, 2 * np.pi, 2 * det.n_ant)) for f, a in cw_lines]
    station = ev.Station(station_id)
    for ant in range(det.n_ant):
        t0 = pulse_sample / LOFAR_FS + delays[ant]
        pulse = np.exp(-0.5 * ((tt - t0) / 15.0) ** 2) \
            * np.cos(2 * np.pi * 0.055 * (tt - t0))
        for pol in range(2):
            cid = 2 * ant + pol
            ch = ev.Channel(cid, channel_group_id=2 * ant)
            trace = noise * rng.standard_normal(n_samples)
            if pol == 0:
                trace = trace + pulse
            for f, a, phases in cw:
                trace = trace + a * np.cos(2 * np.pi * f * tt + phases[cid])
            ch.set_trace(trace, LOFAR_FS)
            station.add_channel(ch)
    return station


def make_lofar_stations(ev, zenith, azimuth, station_ids=LOFAR_SUPERTERP, n_ant=48,
                        n_samples=65536, noise=0.05, seed=0, half_width=40.0,
                        cw_lines=((1500 / 8192 * LOFAR_FS, 0.1),
                                  (2900 / 8192 * LOFAR_FS, 0.1))):
    """(event, detector) of the LOFAR superterp: one station per id of
    ``station_ids`` (LBA_OUTER: 48 dual-polarised antennas, 65,536 samples
    at 200 MHz, readLOFARData.run's default trace length), the pulse in the
    middle of the trace, two CW lines on bins of 8192-sample blocks."""
    det = LofarDetector(n_ant, seed, station_ids, half_width)
    event = ev.Event(run_number=0, event_id=1)
    for k, sid in enumerate(station_ids):
        event.set_station(make_lofar_station(ev, det, sid, zenith, azimuth, n_samples, noise,
                                             n_samples // 2, seed + 1 + k, cw_lines))
    return event, det


def make_rit_event(n_ant=30, n_samples=2048, fs=1.0, half_width=400.0, seed=0,
                   zenith=np.deg2rad(32.0), azimuth=np.deg2rad(70.0), x_max=650.0):
    """tests/test_rit.py's synthetic air shower: a line emitter along the
    axis (7 points with a Gaussian profile in depth around ``x_max``) seen by
    ``n_ant`` antennas uniform in a square of half-width ``half_width``
    (atmosphere model 17, the port's refractivity on the CPU). Returns
    (positions, traces, times, axis [from the core to the source], source
    at x_max, its distance), numpy."""
    from nuradiomc_tpu_torch.models.atmosphere import Atmosphere, Refractivity
    from nuradiomc_tpu_torch.utils.constants import speed_of_light
    at = Atmosphere(17)
    refr = Refractivity(at)
    axis = np.array([np.sin(zenith) * np.cos(azimuth),
                     np.sin(zenith) * np.sin(azimuth), np.cos(zenith)])
    src_depths = np.linspace(x_max - 150, x_max + 150, 7)
    amps = np.exp(-0.5 * ((src_depths - x_max) / 80.0) ** 2)
    sources = [axis * at.get_distance_xmax_geometric(zenith, X, 0.0) for X in src_depths]
    rng = np.random.default_rng(seed)
    positions = np.c_[rng.uniform(-half_width, half_width, n_ant),
                      rng.uniform(-half_width, half_width, n_ant), np.zeros(n_ant)]
    # the shower front moves down the axis at c: a point at distance d emits
    # at -d/c, so only the wavefront curvature tells the depths apart
    delays = refr.time_delay(torch.as_tensor(np.array(sources))[:, None, :],
                             torch.as_tensor(positions), speed_of_light).numpy()
    arrivals = [a - np.linalg.norm(s) / speed_of_light for a, s in zip(delays, sources)]
    t0 = min(a.min() for a in arrivals) - 300.0
    t = np.arange(n_samples) / fs
    times = np.tile(t, (n_ant, 1)) + t0
    traces = np.zeros((n_ant, n_samples))
    for amp, arr in zip(amps, arrivals):
        traces += amp * np.exp(-0.5 * ((t[None, :] + t0 - arr[:, None]) / 5.0) ** 2) \
            * np.cos(0.3 * (t[None, :] + t0 - arr[:, None]))
    dist = at.get_distance_xmax_geometric(zenith, x_max, 0.0)
    return positions, traces, times, axis, axis * dist, dist


class H5Node(dict):
    """An h5py-shaped group in memory: its children by name and ``.attrs``;
    it iterates its children in name order, as an HDF5 group does."""

    def __init__(self, attrs=None, **children):
        super().__init__(children)
        self.attrs = dict(attrs or {})

    def __iter__(self):
        return iter(sorted(super().keys()))

    def keys(self):
        return list(self)

    def items(self):
        return [(k, self[k]) for k in self]


class H5Dataset:
    """An h5py-shaped dataset in memory: ``np.asarray`` gives its data."""

    def __init__(self, data, attrs=None):
        self.data = np.asarray(data)
        self.attrs = dict(attrs or {})

    def __array__(self, dtype=None, copy=None):
        return self.data if dtype is None else self.data.astype(dtype)

    def __len__(self):
        return len(self.data)


def make_coreas_star(n_arms=8, radii_cm=None, n_t=2048, dt_s=2e-10, zenith_deg=35.0,
                     azimuth_deg=120.0, energy_gev=1e8, with_coreas_attrs=True):
    """An h5py-shaped mapping of a CORSIKA-7/CoREAS file (what
    ``sim.io_coreas.coreas_event`` reads): a star of ``n_arms`` x
    len(``radii_cm``) observers (default 8 x 20 radii, 20 m to 400 m) with
    tests/test_coreas_readers.py's inputs, CoREAS attributes and
    pulses (amplitude 1e-3 / (1 + (r / 100 m)^2) statvolt/cm, components
    1 : 0.3 : 0.1, a Gaussian of 8 samples at a quarter of the trace)."""
    if radii_cm is None:
        radii_cm = np.linspace(2000.0, 40000.0, 20)
    inputs = {"THETAP": np.array([zenith_deg, zenith_deg]),
              "PHIP": np.array([azimuth_deg, azimuth_deg]),
              "MAGNET": np.array([18.5, 48.3]), "ERANGE": np.array([energy_gev, energy_gev]),
              "RUNNR": 1, "EVTNR": 7, "PRMPAR": 14, "OBSLEV": 280000.0}
    coreas = {"CoreCoordinateWest": 0.0, "CoreCoordinateNorth": 0.0,
              "CoreCoordinateVertical": 280000.0, "DepthOfShowerMaximum": 650.0,
              "DistanceOfShowerMaximum": 500000.0, "GroundLevelRefractiveIndex": 1.000292,
              "RotationAngleForMagfieldDeclination": 0.0} if with_coreas_attrs else {}
    observers = H5Node()
    t = np.arange(n_t) * dt_s
    k = np.arange(n_t)
    for i, (r, phi) in enumerate([(rr, pp) for rr in radii_cm
                                  for pp in np.linspace(0, 2 * np.pi, n_arms,
                                                        endpoint=False)]):
        data = np.zeros((n_t, 4))
        data[:, 0] = t
        pulse = 1e-3 / (1 + (r / 10000) ** 2) * np.exp(-0.5 * ((k - n_t // 4) / 8.0) ** 2)
        data[:, 1] = pulse
        data[:, 2] = 0.3 * pulse
        data[:, 3] = 0.1 * pulse
        observers[f"obs_{i}"] = H5Dataset(data, {"position": np.array(
            [r * np.cos(phi), r * np.sin(phi), 0.0])})
    return H5Node(inputs=H5Node(inputs), CoREAS=H5Node(coreas, observers=observers))


def coreas_lpda_detector(station_id=7, n=4):
    """tests/test_coreas_readers.py's station: ``n`` downward analytic LPDAs
    3 m around the station center at 1 m depth, at Summit."""
    chans = {}
    pos = [(3, 0), (0, 3), (-3, 0), (0, -3)][:n]
    for cid, (x, y) in enumerate(pos):
        chans[str(cid + 1)] = {
            "adc_n_samples": 512, "adc_sampling_frequency": 1.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": 180.0,
            "ant_position_x": x, "ant_position_y": y, "ant_position_z": -1.0,
            "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
            "ant_type": "analytic_LPDA", "amp_type": "", "cab_time_delay": 0.0,
            "adc_nbits": None, "channel_id": cid, "station_id": station_id,
        }
    return {"channels": chans,
            "stations": {"1": {"station_id": station_id, "pos_altitude": 0,
                               "pos_easting": 0, "pos_northing": 0,
                               "pos_site": "summit"}}}


RNOG_STATION = 11
RNOG_FIRST_RUN = 1000
RNOG_CHANNELS = 24
RNOG_SAMPLES = 2048
RNOG_FS = 3.2                                   # GHz
RNOG_TRIGGERS = ("FORCE", "LT", "RADIANT0")
RNOG_PA_PULSE_SAMPLES = (1000, 1003, 1006, 1009)   # channels 0-3, ~0.94 ns apart


def _rnog_scramble(trace, block_size=64):
    """The LAB4D readout fault that ``rnog_data.unscramble`` undoes: the
    64-sample block i of the readout holds block i+2 (even i) or i-2 (odd
    i) of the true trace."""
    n = trace.shape[-1] // block_size
    blocks = trace.reshape(*trace.shape[:-1], n, block_size)
    src = np.where(np.arange(n) % 2 == 0, np.arange(n) + 2, np.arange(n) - 2) % n
    return blocks[..., src, :].reshape(trace.shape)


class RNOGRunDetector:
    """The detector side that ``dataProviderRNOG`` asks of the RNO-G runs of
    :func:`make_rnog_runs`: cable delays of 10 ns + 0.1 ns per channel id,
    and the station time it was last updated to."""

    def __init__(self):
        self.updated_to = None

    def update(self, time):
        self.updated_to = time

    def get_cable_delay(self, station_id, channel_id):
        return (10.0 + 0.1 * channel_id) * units.ns


def _rnog_run(path, run, n_events, seed, glitch_fraction):
    """Draw and write one run of :func:`make_rnog_runs`; returns its truth."""
    from nuradiomc_tpu_torch.reco.rnog_io import write_numpy_dataset

    rng = np.random.default_rng(seed)
    ff = np.fft.rfftfreq(RNOG_SAMPLES, 1.0 / RNOG_FS)
    band = ((ff > 0.08) & (ff < 0.35)).astype(float)
    t = np.arange(RNOG_SAMPLES) / RNOG_FS
    white = rng.normal(size=(n_events, RNOG_CHANNELS, RNOG_SAMPLES))
    noise = np.fft.irfft(np.fft.rfft(white) * band, RNOG_SAMPLES)
    noise *= 8.0 / noise.std()
    types = rng.choice(RNOG_TRIGGERS, n_events)
    amp = np.where(types == "LT", rng.uniform(0.0, 100.0, n_events), 0.0)
    for c, s0 in enumerate(RNOG_PA_PULSE_SAMPLES):
        t0 = s0 / RNOG_FS
        pulse = np.exp(-0.5 * ((t - t0) / 1.5) ** 2) * np.cos(2 * np.pi * 0.3 * (t - t0))
        noise[:, c] += amp[:, None] * pulse
    scrambled = np.zeros((n_events, RNOG_CHANNELS), dtype=bool)
    for e in np.flatnonzero(rng.random(n_events) < glitch_fraction):
        scrambled[e, rng.choice(RNOG_CHANNELS, rng.integers(1, 4), replace=False)] = True
    noise[scrambled] = _rnog_scramble(noise[scrambled])
    spread = rng.uniform(0.0, 6.0, (n_events, RNOG_CHANNELS, 1))
    offsets = rng.normal(size=(n_events, RNOG_CHANNELS, RNOG_SAMPLES // 128)) * spread
    noise += np.repeat(offsets, 128, axis=-1)
    times = 1.7e9 + 3600.0 * (run % 1000) + 0.1 * np.arange(n_events)
    trigger_times = times.copy()
    trigger_times[0] = np.inf
    write_numpy_dataset(path, RNOG_STATION, run, np.round(noise).astype(np.int16),
                        trigger_types=types, trigger_times=trigger_times, readout_times=times,
                        sample_rate=RNOG_FS,
                        readout_delays=rng.uniform(0.0, 1.0, (n_events, RNOG_CHANNELS)))
    return {"trigger_types": types, "scrambled": scrambled, "pulse_amplitude": amp}


def make_rnog_runs(base_dir, n_runs=4, n_events=1024, seed=0, glitch_fraction=0.05):
    """Write ``n_runs`` RNO-G runs of station 11 (24 channels x 2048 samples
    at 3.2 GHz, int16 ADC counts) as ``rnog_io.write_numpy_dataset`` run
    directories ``base_dir/station11/run<N>`` (N = 1000 + k) and return
    (paths, truth).

    Each event has a trigger type drawn from FORCE, LT and RADIANT0 and
    Gaussian ADC noise band-limited to 80-350 MHz (8 counts RMS); every LT
    event has a pulse on channels 0-3 at the hit filter's PA spacing
    (:data:`RNOG_PA_PULSE_SAMPLES`) with a peak of 0-100 counts; in
    ``glitch_fraction`` of the events, 1-3 channels carry the LAB4D block
    scramble; every channel then gets 128-sample block offsets of its own
    spread (0-6 counts), as the readout adds them. Each run's first event
    has an infinite trigger time (the reader's fallback to the readout
    time). ``truth`` holds per run ``trigger_types`` [E], ``scrambled``
    [E, 24] and ``pulse_amplitude`` [E] (counts, 0 off LT). Run k draws from
    ``np.random.default_rng([seed, k])``; the runs are drawn and written in
    threads (numpy's draws, FFTs and zlib release the interpreter lock)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    paths = [os.path.join(base_dir, f"station{RNOG_STATION}", f"run{RNOG_FIRST_RUN + k}")
             for k in range(n_runs)]
    with ThreadPoolExecutor(max_workers=max(1, n_runs)) as pool:
        jobs = [pool.submit(_rnog_run, path, RNOG_FIRST_RUN + k, n_events, [seed, k],
                            glitch_fraction) for k, path in enumerate(paths)]
        truth = [job.result() for job in jobs]
    return paths, truth


def make_rnog_sim_stations(ev, n_events, seed=0, n_channels=RNOG_CHANNELS):
    """``n_events`` simulated station-11 events in memory, as a simulation
    hands them to a measured-noise importer: 24 channels x 2048 samples at
    3.2 GHz, a band-limited pulse of 0-60 mV on channels 0-3 (sample ~1000,
    the PA spacing) and zeros elsewhere. Returns [(event, station)]."""
    rng = np.random.default_rng(seed)
    t = np.arange(RNOG_SAMPLES) / RNOG_FS
    amp = rng.uniform(0.0, 60.0, n_events) * units.mV
    shift = rng.uniform(-200.0, 200.0, n_events)
    out = []
    for e in range(n_events):
        evt = ev.Event(0, e)
        st = ev.Station(RNOG_STATION)
        for c in range(n_channels):
            trace = np.zeros(RNOG_SAMPLES)
            if c < 4:
                t0 = (RNOG_PA_PULSE_SAMPLES[c] + shift[e]) / RNOG_FS
                trace = amp[e] * np.exp(-0.5 * ((t - t0) / 1.5) ** 2) \
                    * np.cos(2 * np.pi * 0.3 * (t - t0))
            ch = ev.Channel(c)
            ch.set_trace(trace, RNOG_FS * units.GHz)
            st.add_channel(ch)
        evt.set_station(st)
        out.append((evt, st))
    return out


ANTENNA_PATTERN_KINDS = ("wipld", "ara", "xfdtd", "hfss", "aera", "lofar", "feko",
                         "rnog_xfdtd")


def _write_ara_pattern(path, rng, freqs=(100.0, 300.0)):
    """An ARASim gain table: per frequency a header, then (theta, phi, gain
    dB, gain, phase) rows over 45 deg x 5 deg."""
    with open(path, "w") as f:
        for fr in freqs:
            f.write(f"freq : {fr} MHz\nSWR : 1.5\nTheta   Phi     Gain(dB)  Gain   Phase(deg)\n")
            for phi in np.arange(0, 356, 5):
                for theta in np.arange(0, 181, 45):
                    g = rng.uniform(0.1, 5.0)
                    f.write(f"{theta} {phi} {10 * np.log10(g):.3f} {g:.6f} "
                            f"{rng.uniform(-180, 180):.3f}\n")


def write_antenna_pattern(root, kind, seed=0):
    """Write a small raw antenna-pattern export of ``kind`` (one of
    :data:`ANTENNA_PATTERN_KINDS`: the formats ``detector/
    antenna_preprocess.py`` reads) under the directory ``root`` and return
    (preprocessor name, args, kwargs) that turn it into a pickle there."""
    import os

    rng = np.random.default_rng(seed)
    root = str(root)
    if kind == "wipld":
        d = os.path.join(root, "wipldant")
        os.makedirs(d)
        freqs = (0.1, 0.3, 0.5, 0.8)
        with open(os.path.join(d, "wipldant.ad1"), "w") as f:
            f.write("> header line\n")
            for fr in freqs:
                f.write(f"{fr} 1 1 0 0 {50 + 20 * fr} {-5 * fr} {0.3 * fr - 0.2} {0.1 * fr}\n")
        with open(os.path.join(d, "wipldant.ra1"), "w") as f:
            for fr in freqs:
                f.write(f"> ra1 gen 1 {fr}\n")
                for ph in range(0, 361, 60):
                    for th in range(-90, 91, 30):
                        re_p, im_p, re_t, im_t = rng.standard_normal(4)
                        f.write(f"{ph} {th} {re_p} {im_p} {re_t} {im_t} 1.0 0.0\n")
        with open(os.path.join(d, "wipldant.orientation"), "w") as f:
            f.write("0, 0, 1\n1, 0, 0\n")
        return "save_preprocessed_wipld", (os.path.join(d, "wipldant.ad1"),), {}
    if kind == "ara":
        d = os.path.join(root, "aravpol")
        os.makedirs(d)
        _write_ara_pattern(os.path.join(d, "aravpol.txt"), rng)
        return "preprocess_ara", (os.path.join(d, "aravpol.txt"),), {}
    if kind == "xfdtd":
        d = os.path.join(root, "xfhpol")
        os.makedirs(d)
        _write_ara_pattern(os.path.join(d, "xfhpol.txt"), rng)
        with open(os.path.join(d, "xfhpol.yaml"), "w") as f:
            f.write("boresight_direction: [0, 0, 1]\norientation: [1, 0, 0]\nn: 1.78\n"
                    "type: Hpol\n")
        return "preprocess_xfdtd", (os.path.join(d, "xfhpol.txt"),), {}
    if kind == "hfss":
        d = os.path.join(root, "hfssant")
        os.makedirs(d)
        angles = [(t, p) for p in (0, 120, 240) for t in (0, 90, 180)]
        cols = ["Freq [MHz]"]
        for t, p in angles:
            tag = f"Phi='{p}deg' Theta='{t}deg'"
            cols += [f"log10(mag(rEPhi)) - {tag}", f"log10(mag(rETheta)) - {tag}",
                     f"ang_rad(rEPhi) - {tag}", f"ang_rad(rETheta) - {tag}"]
        with open(os.path.join(d, "hfssant.csv"), "w") as f:
            f.write(",".join(cols) + "\n")
            for fr in (200.0, 400.0):
                row = [str(fr)]
                for _ in angles:
                    m = rng.uniform(-10, 3)
                    row += [str(m), str(m - 1), str(rng.uniform(-np.pi, np.pi)),
                            str(rng.uniform(-np.pi, np.pi))]
                f.write(",".join(row) + "\n")
        return "preprocess_hfss", (os.path.join(d, "hfssant.csv"),), {}
    if kind == "aera":
        freqs, thetas, phis = (30.0, 55.0, 80.0), (0, 30, 60, 90), (0, 90, 180, 270)
        pairs = [(t, p) for p in phis for t in thetas]
        path = os.path.join(root, "aeraant.xml")
        with open(path, "w") as f:
            f.write("<frequency> %s </frequency>\n" % " ".join(str(x) for x in freqs))
            f.write("<theta> %s </theta>\n" % " ".join(str(t) for t, _ in pairs))
            f.write("<phi> %s </phi>\n" % " ".join(str(p) for _, p in pairs))
            for fr in freqs:
                for tag in ("EAHTheta_amp", "EAHTheta_phase", "EAHPhi_amp", "EAHPhi_phase"):
                    vals = (rng.uniform(-180, 180, len(pairs)) if "phase" in tag
                            else rng.uniform(0.02, 2.0, len(pairs)))
                    f.write("<%s idfreq='%.2f'> %s </%s>\n"
                            % (tag, fr, " ".join(repr(float(v)) for v in vals), tag))
        return "preprocess_aera", (path,), {"output": os.path.join(root, "aeraant.pkl")}
    if kind == "lofar":
        rows = [(f, t, p) for f in (30.0, 50.0, 70.0) for t in (0, 45, 90)
                for p in (0, 90, 180, 270)]
        for comp in ("theta", "phi"):
            with open(os.path.join(root, f"LBA_Vout_{comp}.txt"), "w") as fh:
                fh.write("freq theta phi re im\n")
                for f, t, p in rows:
                    re, im = rng.standard_normal(2)
                    fh.write(f"{f} {t} {p} {float(re)!r} {float(im)!r}\n")
        return "preprocess_lofar_txt", (root,), {"ant": "LBA", "orientation": "Y",
                                                 "output": os.path.join(root, "lofar.pkl")}
    if kind == "feko":
        from scipy import io as scipy_io
        E = rng.standard_normal((9, 5, 7, 2, 2)).view(np.complex128).reshape(9, 5, 7, 2)
        path = os.path.join(root, "feko.mat")
        scipy_io.savemat(path, {"Ephi": E[..., 0], "Etheta": E[..., 1]})
        return "preprocess_feko_mat", (path,), {
            "polarization": "X", "downscale_freq": 2, "downscale_zenith": 1,
            "downscale_azimuth": 2, "output": os.path.join(root, "feko.pkl")}
    if kind == "rnog_xfdtd":
        rows = [(f, t, p) for f in (0.1, 0.3, 0.5) for t in range(0, 181, 45)
                for p in range(0, 360, 90)]
        gain, phase = os.path.join(root, "gain.csv"), os.path.join(root, "phase.csv")
        with open(gain, "w") as f:
            f.write("freq,theta,phi,gain_phi,gain_theta\n")
            for fr, t, p in rows:
                f.write(f"{fr},{t},{p},{rng.uniform(0.01, 2)},{rng.uniform(0.01, 2)}\n")
        with open(phase, "w") as f:
            f.write("freq,theta,phi,re_phi,im_phi,re_theta,im_theta\n")
            for fr, t, p in rows:
                f.write(f"{fr},{t},{p}," + ",".join(str(v) for v in rng.standard_normal(4))
                        + "\n")
        return "preprocess_rnog_xfdtd", (gain, phase, os.path.join(root, "rnog.pkl")), {}
    raise ValueError(f"unknown antenna pattern kind {kind!r}")


def make_ara_run(path, n_events=300, n_channels=16, n_samples=512, seed=0):
    """Write an ARA run export (``reco.ara_io.write_numpy_dataset``) of
    station 2, run 42: per event and channel a calibrated graph of
    ``n_samples`` - 0..7 samples at slightly non-uniform times (0.55-0.70 ns
    apart, as the ARA graphs are) and 50 mV Gaussian voltages."""
    from nuradiomc_tpu_torch.reco.ara_io import write_numpy_dataset

    rng = np.random.default_rng(seed)
    times, volts = [], []
    for _ in range(n_events):
        n = n_samples - rng.integers(0, 8, n_channels)
        times.append([np.cumsum(0.55 + 0.15 * rng.random(k)) for k in n])
        volts.append([rng.standard_normal(k) * 50.0 for k in n])
    write_numpy_dataset(path, 42, [2] * n_events, np.arange(100, 100 + n_events), times, volts)
    return path


def make_arianna_calib_file(path, n_events=300, n_channels=4, n_samples=256, seed=0):
    """Write an ARIANNA CalibTree export (``reco.arianna_io.
    write_numpy_dataset``) of station 51, run 7 in the layout of
    tests/test_ara_arianna_io.py's fixture, ``n_events`` long: events in
    sequences of 50 (the last sequence without a config row), thermal and
    forced triggers alternating, one in 20 without a stop sample, 20 mV
    Gaussian waveforms."""
    import datetime

    from nuradiomc_tpu_torch.reco.arianna_io import write_numpy_dataset

    rng = np.random.default_rng(seed)
    t0 = datetime.datetime(2018, 3, 1, 12, 0, 0).timestamp()
    seq = np.arange(n_events) // 50 + 1
    n_cfg = int(seq.max()) - 1 if seq.max() > 1 else 1
    stop = rng.integers(1, n_samples, n_events)
    stop[::20] = -1
    write_numpy_dataset(
        path, trees={"AmpOutData": rng.standard_normal((n_events, n_channels, n_samples)) * 20},
        station_ids=np.full(n_events, 51), run_numbers=np.full(n_events, 7),
        event_numbers=np.arange(10, 10 + n_events), seq_numbers=seq,
        unix_times=t0 + 60.0 * np.arange(n_events),
        is_thermal=np.arange(n_events) % 2 == 0, is_forced=np.arange(n_events) % 2 == 1,
        dt_ms=rng.uniform(1, 10, n_events), stop_samples=stop,
        cfg_station_ids=np.full(n_cfg, 51), cfg_run_numbers=np.full(n_cfg, 7),
        cfg_seq_numbers=np.arange(1, n_cfg + 1), cfg_n_chans=np.full(n_cfg, n_channels),
        cfg_sampling_rates=np.ones(n_cfg), cfg_type_names=["Standard"] * n_cfg,
        cfg_seq_start=t0 - 30.0 + 3000.0 * np.arange(n_cfg),
        cfg_seq_stop=t0 + 3000.0 * np.arange(1, n_cfg + 1),
        cfg_comm_durations=np.full(n_cfg, 120.0), cfg_comm_periods=np.full(n_cfg, 600.0),
        cfg_l1_cuts=np.full(n_cfg, 0.3),
        cfg_thresholds=np.tile(np.array([[-0.1, 0.1]]), (n_cfg, n_channels, 1)))
    return path
