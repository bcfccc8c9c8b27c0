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
h5py.
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
from nuradiomc_tpu_torch.sim.pipeline import (ChannelParams, PipelineSettings,
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
    """The port's PipelineSettings from the JAX package's (by field name)."""
    src = _fields(settings)
    if src.get("stop_after"):
        raise ValueError("stop_after is a TPU profiling mode; the port has none")
    if src.get("matmul_dtype", "float32") != "float32":
        raise ValueError("matmul_dtype other than float32 changes numbers and "
                         "is not ported")
    ice = _convert_dataclass(src["ice"], ice_models.IceModelSimple)
    triggers = tuple(_convert_dataclass(t, TriggerSettings) for t in src["triggers"])
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
    if src.get("antenna_table") is not None:
        raise NotImplementedError("tabulated antennas are not ported yet "
                                  "(ROADMAP queue 1 item 6, emitter / ARZ / HCRB / "
                                  "tabulated antennas)")
    out = {}
    for name in ChannelParams._fields:
        if name == "antenna_table":
            out[name] = None
        elif name == "kind":
            out[name] = _tensor(src[name], torch.int64, device)
        elif name in _COMPLEX_FIELDS:
            out[name] = _tensor(src.get(name), _ctype(dtype), device)
        else:
            out[name] = _tensor(src.get(name), dtype, device)
    return ChannelParams(**out)


def batch_from_jax(batch, *, device, dtype) -> ShowerBatch:
    src = _fields(batch)
    kinds = {"is_em": torch.bool, "shower_mask": torch.bool,
             "profile_idx": torch.int64}
    return ShowerBatch(**{name: _tensor(src.get(name), kinds.get(name, dtype), device)
                          for name in ShowerBatch._fields})


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
    of DIPOLE_CONFIG; ``kwargs`` go to ``Simulation``)."""
    from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
    return Simulation(
        inputfilename, DIPOLE_DETECTOR,
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
