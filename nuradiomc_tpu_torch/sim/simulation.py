"""Host-side simulation orchestrator (torch): the dipole Veff, the
phased-array, the Gen2 (multi-station, birefringence), the multi-trigger
station, the reflective-bottom (Moore's Bay), the emitter (pulser), the
tabulated-antenna and the ARZ runs.

Counterpart of ``nuradiomc_tpu/sim/simulation.py::Simulation``: it merges
the config, calibrates Vrms from the filter chain's bandwidth (and the
trigger Vrms from a separate trigger chain's, where one is given), builds
the per-channel tensors, the list of named triggers (high/low, threshold and
the phased array with its trigger ADC, each on all channels or on a subset
given by channel ids) and the padded [group x shower] batch
with the Alvarez2009 ``k_L`` draws, runs :func:`pipeline.simulate_batch`
chunk by chunk on ``device`` (noise from one ``torch.Generator`` per chunk on
that device, seeded from ``config["seed"]``, the station and the chunk's
index), computes the weights and Veff, and
writes the output HDF5 through ``io_hdf5.write_output_hdf5`` (the port's
copy; needs h5py) and, with ``nur_outputfilename``, the triggered events
with their waveforms through the port's ``io_nur.EventWriter`` (no h5py). A
plain chunk loop takes the place of the JAX package's packed executor.

The input is an HDF5 event list (read with h5py), its ``.npz`` export
(``sim/io_input.py``) or an ``EventInput`` made in memory
(``io_input.from_generated`` on ``evtgen``'s output); the last two need no
h5py: that is how ``Simulation`` runs where h5py is missing. Writing an
output HDF5 file needs h5py.

An emitter input (``simulation_mode = "emitter"``) makes the run an emitter
run: the ``emitter_*`` columns give the model, the emitting antenna and the
per-row amplitude, frequency, polarization and time. ``antenna_models_path``
holds tabulated antenna pickles as ``<model>/<model>.pkl``;
``arz_library_path`` the shower library of the ARZ models. A surface-muon
input (``simulation_mode = "atmospheric_muon"``, ``evtgen.generate_surface_muons``)
runs as a neutrino input does (its downgoing muons get weight 1 from the
Earth model, as in the JAX package); its results carry the input's
``area``, ``thetamin``, ``thetamax`` and ``n_events`` and the effective
area ``aeff`` (``veff.aeff_from_results``).

With ``mesh`` (a ``parallel.mesh.Mesh``, or ``"auto"``: every rank of the
process group on one event axis) the run is one process per rank. The
event axis deals whole chunks round-robin: rank e of an event row runs
chunks e, e + n_event, ..., so every chunk has the shape and the numbers
it has in a single-process run (the noise too: its generator belongs to
the chunk), and the host results of the chunks are gathered to every rank.
The JAX package instead splits each chunk over its event axis and rounds
``chunk_size`` up to a multiple of it; the port does neither, because a
chunk split over ranks would change the chunk's shape and hence which
groups share a launch, where dealing whole chunks keeps the single-process
run's numbers. The channel axis splits steps 1-7 of each chunk over the
ranks of a column (``simulate_batch(channel_axis=)``). Weights and Veff are
computed on every rank; rank 0 alone writes ``outputfilename`` and
``nur_outputfilename`` (whose re-run of the triggered groups runs on the
mesh too).

Not ported yet (it raises): numeric birefringence propagation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from nuradiomc_tpu_torch.detector.detector import Detector
from nuradiomc_tpu_torch.ops import filters
from nuradiomc_tpu_torch.parallel import mesh as mesh_util
from nuradiomc_tpu_torch.sim import earth_attenuation
from nuradiomc_tpu_torch.sim import veff as veff_util
from nuradiomc_tpu_torch.sim.evtgen import group_into_events
from nuradiomc_tpu_torch.utils import config as config_util
from nuradiomc_tpu_torch.utils import units
from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils.constants import boltzmann
from nuradiomc_tpu_torch.models import ice as ice_models
from nuradiomc_tpu_torch.ops import (antenna, arz as arz_ops, askaryan,
                                     emitter as emitter_ops, phased_array)
from nuradiomc_tpu_torch.sim.io_input import read_input
from nuradiomc_tpu_torch.sim.pipeline import (AntennaTableParams, ChannelParams,
                                              EmitterParams, PipelineSettings,
                                              ShowerBatch, TriggerSettings,
                                              simulate_batch)
from nuradiomc_tpu_torch.utils import geometry


@dataclasses.dataclass
class FilterStage:
    passband: tuple
    filter_type: str
    kwargs: dict = dataclasses.field(default_factory=dict)
    channels: tuple = ()       # channel ids this stage applies to; () = all


@dataclasses.dataclass
class TriggerSpec:
    name: str = "default_high_low"
    trigger_type: str = "high_low"   # 'high_low' | 'simple_threshold' | 'phased_array'
    channels: tuple = ()
    threshold_high_sigma: float = 2.0       # in units of Vrms
    threshold_low_sigma: float = -2.0
    highlow_coincidence: float = 5.0        # ns
    number_of_coincidences: int = 1
    channel_coincidence: float = 200.0      # ns
    # phased-array settings (trigger_type == 'phased_array'), as the JAX
    # package's TriggerSpec (simulation.py:61-72)
    pa_phasing_angles: tuple = tuple(np.arcsin(np.linspace(
        np.sin(np.deg2rad(-59.54968597864437)),
        np.sin(np.deg2rad(59.54968597864437)), 11)))
    pa_ref_index: float = 1.75
    pa_window_ns: float = 16.0
    pa_step_ns: float = 8.0
    pa_upsampling: int = 2
    pa_threshold_factor: float = 30.85      # threshold = factor * Vrms^2
    pa_digitize: bool = True                # trigger ADC before phasing
    pa_adc_noise_count: int = None          # 15 if None
    requires: str = None


def _group_showers(group_ids):
    """(unique_ids, start, count, order): showers stably sorted by group id
    (the JAX package's native batch builder, native/batch_builder.cpp)."""
    order = np.argsort(np.asarray(group_ids, dtype=np.int64), kind="stable")
    uids, start, count = np.unique(np.asarray(group_ids)[order],
                                   return_index=True, return_counts=True)
    return uids, start.astype(np.int64), count.astype(np.int64), order.astype(np.int64)


def _pad_columns(columns: dict, order, start, count, s_max: int):
    """Pad per-shower columns into [n_groups, s_max] (zeros) plus the mask."""
    n_groups = len(start)
    slot = np.arange(s_max)[None, :]
    mask = slot < count[:, None]
    rows = order[np.minimum(start[:, None] + slot, len(order) - 1)]
    out = {name: np.where(mask, np.asarray(col, dtype=np.float64)[rows], 0.0)
           for name, col in columns.items()}
    return out, mask.reshape(n_groups, s_max)


class Simulation:
    """End-to-end MC simulation of the ported paths.

    Parameters as in the JAX package's ``Simulation``; ``inputfilename`` is
    an HDF5 event list or its ``.npz`` export; ``device`` and ``dtype`` say
    where and in which precision the pipeline runs: the CUDA card unless
    ``device="cpu"`` is asked for (without a card the default raises);
    float64 is the production default, float32 the benchmark configuration.
    ``mesh``: ``None`` (one process), ``"auto"`` or a ``parallel.mesh.Mesh``
    (see the module docstring); the run then takes the mesh's device, whose
    type must be ``device``'s. ``noise_device``: where the noise generators
    draw (default the run's device); ``"cpu"`` draws the same numbers on any
    device, so that a run on the card can be held exactly to one on the CPU.
    """

    def __init__(self, inputfilename: str, detector, config=None,
                 filter_chain: Sequence[FilterStage] = (),
                 trigger: TriggerSpec = TriggerSpec(),
                 triggers: Optional[Sequence[TriggerSpec]] = None,
                 trigger_filter_chain: Optional[Sequence[FilterStage]] = None,
                 outputfilename: Optional[str] = None,
                 nur_outputfilename: Optional[str] = None,
                 antenna_replacements: Optional[dict] = None,
                 antenna_models_path: Optional[str] = None,
                 chunk_size: int = 256, n_base: int = 2048,
                 arz_library_path: Optional[str] = None,
                 spice_pulses_path: Optional[str] = None,
                 spice_pulse_index: int = 0,
                 device=device_util.DEFAULT, dtype=torch.float64, mesh=None,
                 noise_device=None):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh must be None, 'auto' or a Mesh, got {mesh!r}")
            mesh = mesh_util.make_mesh(device=torch.device(device).type)
        self.mesh = mesh
        if mesh is None:
            self.device = device_util.resolve(device)
        else:
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device!r} but the mesh runs on {mesh.device}")
            self.device = mesh.device
        self.dtype = dtype
        self.noise_device = self.device if noise_device is None else torch.device(noise_device)
        self.config = config_util.get_config(config)
        self.det = detector if isinstance(detector, Detector) else Detector(detector)
        self.filter_chain = list(filter_chain)
        self.triggers = list(triggers) if triggers is not None else [trigger]
        if len({t.name for t in self.triggers}) != len(self.triggers):
            raise ValueError("trigger names must be unique")
        self.trigger = self.triggers[0]
        # a distinct signal chain for the trigger channels; None: the
        # triggers read the readout chain
        self.trigger_filter_chain = (list(trigger_filter_chain)
                                     if trigger_filter_chain is not None else None)
        self.outputfilename = outputfilename
        self.nur_outputfilename = nur_outputfilename
        self.antenna_replacements = antenna_replacements or {}
        self.antenna_models_path = antenna_models_path
        self.spice_pulses_path = spice_pulses_path
        self.spice_pulse_index = int(spice_pulse_index)
        self.chunk_size = chunk_size

        self.station_id = self.det.get_station_ids()[0]
        ch = self.det.get_station(self.station_id).channels
        cfg = self.config
        if cfg["signal"]["model"] not in ("ZHS1992", "Alvarez2000", "Alvarez2009",
                                          "ARZ2019", "ARZ2020"):
            raise NotImplementedError(
                f"signal model {cfg['signal']['model']} is not implemented in the "
                "pipeline (HCRB2017 is the stand-alone op ops/hcrb2017.py)")
        self.internal_rate = float(cfg["sampling_rate"])
        dt = 1.0 / self.internal_rate
        # detector samples at the internal rate (simulation.py:151-153), and
        # >= 25% headroom of the time base beyond one readout window
        n = ch.n_samples[0] / ch.sampling_frequency[0] / dt
        self.n_internal = int(np.ceil(n / 2.0) * 2)
        pad = int(np.ceil(0.25 * self.n_internal / 128.0) * 128)
        self.n_base = max(n_base, self.n_internal + pad)
        self.ice = ice_models.get_ice_model(cfg["propagation"]["ice_model"])

        # ---- Vrms calibration (simulation.py:192-232) -----------------------
        ff_cal = np.linspace(0, 0.5 * self.internal_rate, 10000)
        noise_temp = cfg["trigger"]["noise_temperature"]
        vrms_cfg = cfg["trigger"]["Vrms"]

        def thermal_vrms(bandwidth):
            if vrms_cfg is not None:
                return float(vrms_cfg)
            return float(np.sqrt(float(noise_temp) * 50 * units.ohm
                                 * bandwidth * boltzmann))

        self.bandwidth_per_channel = {}
        self.Vrms_per_channel = {}
        self.max_amplification_per_channel = {}
        ids0 = [int(c) for c in ch.channel_ids]
        for cid in ids0:
            filt = self._chain_response_for(ff_cal, cid, self.filter_chain)
            bw = np.trapezoid(np.abs(filt) ** 2, ff_cal)
            self.bandwidth_per_channel[cid] = bw
            self.Vrms_per_channel[cid] = thermal_vrms(bw)
            self.max_amplification_per_channel[cid] = (
                float(np.abs(filt).max()) if len(self.filter_chain) else 1.0)
        self.bandwidth = self.bandwidth_per_channel[ids0[0]]
        self.max_amplification = self.max_amplification_per_channel[ids0[0]]
        self.Vrms = self.Vrms_per_channel[ids0[0]]
        self.Vrms_efield = self.Vrms / self.max_amplification / units.m
        # the trigger thresholds in sigma refer to the thermal Vrms of the
        # trigger chain's bandwidth where a separate one is given
        # (simulation.py:222-232)
        if self.trigger_filter_chain is not None:
            filt_t = self._chain_response_for(ff_cal, ids0[0], self.trigger_filter_chain)
            self.bandwidth_trigger = np.trapezoid(np.abs(filt_t) ** 2, ff_cal)
            self.Vrms_trigger = thermal_vrms(self.bandwidth_trigger)
        else:
            self.bandwidth_trigger = self.bandwidth
            self.Vrms_trigger = self.Vrms

        self.channel_params_per_station = {
            sid: self._build_channel_params(sid) for sid in self.det.get_station_ids()}
        self.channel_params = self.channel_params_per_station[self.station_id]
        self.trigger_names = [t.name for t in self.triggers]
        prop = cfg["propagation"]
        n_reflections = int(prop.get("n_reflections", 0) or 0)
        self.settings = PipelineSettings(
            triggers=tuple(self._build_trigger_settings(t) for t in self.triggers),
            ice=self.ice,
            attenuation_model=prop["attenuation_model"],
            askaryan_model=cfg["signal"]["model"],
            n_internal=self.n_internal,
            n_base=self.n_base,
            sampling_rate=self.internal_rate,
            n_reflections=n_reflections,
            # sub-event readout windows: bounce rays arrive microseconds
            # after the direct pulse, one cluster per (r, case) family, so
            # the default is one window per cluster; propagation.n_windows
            # overrides (simulation.py:273-281)
            n_windows=int(prop.get("n_windows", 0) or (1 + 2 * n_reflections)),
            delta_C_cut=float(cfg["speedup"]["delta_C_cut"]),
            distance_cut=bool(cfg["speedup"]["distance_cut"]),
            distance_cut_coefficients=tuple(cfg["speedup"]["distance_cut_coefficients"]),
            distance_cut_sum_length=float(cfg["speedup"]["distance_cut_sum_length"]),
            n_freq_attenuation=int(prop["n_freq"]),
            max_detector_freq=float(max(
                float(np.max(self.det.get_station(sid).channels.sampling_frequency))
                for sid in self.det.get_station_ids())) * 0.5,
            **({"attenuation_steps": int(prop["attenuation_steps"])}
               if prop.get("attenuation_steps") else {}),
            **({"attenuation_quadrature": str(prop["attenuation_quadrature"])}
               if prop.get("attenuation_quadrature") else {}),
            **({"n_bisect": int(prop["n_bisect"])} if prop.get("n_bisect") else {}),
            **({"band_limit_eps": float(cfg["perf"]["band_limit_eps"])}
               if cfg.get("perf", {}).get("band_limit_eps") else {}),
            **({"noise_sampler": str(cfg["perf"]["noise_sampler"])}
               if cfg.get("perf", {}).get("noise_sampler") else {}),
            attenuate_ice=bool(prop["attenuate_ice"]),
            apply_focusing=bool(prop["focusing"]),
            focusing_limit=float(prop["focusing_limit"]),
            **({"focusing_mode": str(prop["focusing_mode"])}
               if prop.get("focusing_mode") else {}),
            birefringence=bool(prop.get("birefringence", False)),
            birefringence_model=str(prop.get("birefringence_model", "southpole_A")),
            # the path is rotated into the ice-flow frame by angle_to_iceflow
            # (deg), -131 in the default config (simulation.py:307-311)
            birefringence_iceflow=float(np.deg2rad(prop.get("angle_to_iceflow", -131.0))),
            add_noise=bool(cfg["noise"]),
            noise_type="rayleigh",
        )
        if (self.settings.birefringence
                and prop.get("birefringence_propagation", "analytical") != "analytical"):
            raise NotImplementedError(
                "only analytical birefringence propagation is implemented "
                "(config propagation.birefringence_propagation)")
        # the ARZ shower library (simulation.py:321-328)
        self.arz_library = None
        if cfg["signal"]["model"] in ("ARZ2019", "ARZ2020"):
            if arz_library_path is None:
                raise ValueError("ARZ models require arz_library_path "
                                 "(reference-format shower library pickle)")
            self.arz_library = arz_ops.load_library_pickle(arz_library_path).to(
                self.device, self.dtype)
        self.input = read_input(inputfilename)
        self._emitter = self._build_emitter_params()

    def _build_emitter_params(self):
        """EmitterParams when the input declares simulation_mode "emitter"
        (simulation.py:378): the emitter model and, for voltage models, the
        emitting antenna's VEL. Static per run; the per-row amplitude,
        frequency and polarization ride the ShowerBatch."""
        mode = self.input.attrs.get("simulation_mode", "neutrino")
        mode = mode.decode() if isinstance(mode, bytes) else str(mode)
        self.simulation_mode = mode
        self.emitter_mode = mode == "emitter"
        if not self.emitter_mode:
            return None
        em = self.input.emitter or {}

        def uniq(key, default=None):
            if key not in em:
                return default
            vals = [v.decode() if isinstance(v, bytes) else v for v in em[key]]
            u = sorted(set(np.asarray(vals).tolist()))
            if len(u) != 1:
                raise NotImplementedError(
                    f"mixed per-row {key} in one emitter run is not "
                    f"supported (found {u}); split the input file")
            return u[0]

        model = str(uniq("emitter_model"))
        half_width = float(uniq("emitter_half_width", 5.0) or 5.0)
        freqs_int = np.fft.rfftfreq(self.n_internal, 1.0 / self.internal_rate)
        tpl = np.zeros((3, len(freqs_int)), dtype=complex)
        rot = np.eye(3)
        kind = 0
        if not model.startswith("efield_"):
            ant = str(uniq("emitter_antenna_type"))
            ant = self.antenna_replacements.get(ant, ant)
            if ant not in antenna.ANALYTIC_MODELS:
                raise NotImplementedError(
                    f"emitting antenna '{ant}' is not analytic; pass "
                    "antenna_replacements")
            kind = antenna.ANALYTIC_MODELS[ant][0]
            t = antenna.build_analytic_template(ant, freqs_int)
            tpl[:t.shape[0]] = t
            if t.shape[0] == 1:
                tpl[1:] = t[0]
            rot = antenna.antenna_rotation_matrix(
                float(uniq("emitter_orientation_theta", 0.0) or 0.0),
                float(uniq("emitter_orientation_phi", 0.0) or 0.0),
                float(uniq("emitter_rotation_theta", 0.0) or 0.0),
                float(uniq("emitter_rotation_phi", 0.0) or 0.0))
        ctype = torch.complex64 if self.dtype == torch.float32 else torch.complex128

        def real(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype,
                                   device=self.device)

        def cplx(a):
            return torch.as_tensor(np.asarray(a), dtype=ctype, device=self.device)

        unit_spec = None
        if model in emitter_ops.MEASURED_MODELS:
            # a measured lab waveform: the amplitude scales the normalized
            # trace, so the unit-amplitude spectrum is one constant
            trace = emitter_ops.get_measured_time_trace(
                model, 1.0, self.n_internal, 1.0 / self.internal_rate)
            unit_spec = cplx(np.fft.rfft(trace) / self.internal_rate * np.sqrt(2.0))
        spice_angles = spice_specs = None
        if model == "efield_idl1_spice":
            # the measured SPICE pulser archive: per-launch-angle unit
            # spectra; the pipeline gathers the nearest angle per ray
            if self.spice_pulses_path is None:
                raise ValueError("emitter model efield_idl1_spice needs spice_pulses_path "
                                 "(the SPice_pulses.xz archive)")
            archive = emitter_ops.load_spice_archive(self.spice_pulses_path)
            angles, specs = emitter_ops.spice_unit_specs(
                archive, self.n_internal, 1.0 / self.internal_rate,
                iN=self.spice_pulse_index)
            spice_angles, spice_specs = real(angles), cplx(specs)
        return EmitterParams(model=model, templates=cplx(tpl), rot=real(rot), kind=int(kind),
                             half_width=half_width, unit_spec=unit_spec,
                             spice_angles=spice_angles, spice_specs=spice_specs)

    def _chain_response_for(self, freqs, channel_id, chain):
        """Combined response of the stages of ``chain`` that apply to
        ``channel_id``."""
        stages = [(f.passband, f.filter_type, f.kwargs) for f in chain
                  if not f.channels or int(channel_id) in f.channels]
        return filters.chain_response(freqs, stages, fs=self.internal_rate)

    def _build_trigger_settings(self, spec: TriggerSpec) -> TriggerSettings:
        """Absolute thresholds in volts, channel ids as indices and the
        phased-array beam and ADC configuration (simulation.py:472-526)."""
        if spec.trigger_type not in ("high_low", "simple_threshold", "phased_array"):
            raise NotImplementedError(f"trigger type {spec.trigger_type}")
        ch = self.det.get_station(self.station_id).channels
        ids = [int(c) for c in ch.channel_ids]
        idx = tuple(ids.index(int(c)) for c in spec.channels)
        # the beams are built on the trigger's own channels
        sub = np.asarray(idx, dtype=int) if idx else np.arange(len(ids))
        pa = {}
        if spec.trigger_type == "phased_array":
            det_fs = float(ch.sampling_frequency[0])
            # with digitization the trigger runs at the ADC rate x upsampling
            fs_up = (det_fs if spec.pa_digitize else self.internal_rate) * spec.pa_upsampling
            rolls = phased_array.beam_rolls(ch.positions[sub, 2], ch.cable_delay[sub],
                                            np.asarray(spec.pa_phasing_angles),
                                            spec.pa_ref_index, fs_up)
            n_bits = int(ch.adc_nbits[0]) if ch.adc_nbits[0] > 0 else 8
            pa = dict(
                pa_rolls=tuple(tuple(int(v) for v in row) for row in rolls),
                pa_window=int(spec.pa_window_ns * det_fs * spec.pa_upsampling),
                pa_step=int(spec.pa_step_ns * det_fs * spec.pa_upsampling),
                pa_upsampling=spec.pa_upsampling,
                pa_threshold=spec.pa_threshold_factor * self.Vrms_trigger ** 2,
                pa_digitize=spec.pa_digitize, pa_adc_fs=det_fs, pa_adc_nbits=n_bits,
                # ADC range from the noise occupancy (_get_adc_parameters:216-241)
                pa_adc_range=(self.Vrms_trigger * (2 ** n_bits - 1)
                              / (spec.pa_adc_noise_count or 15)))
        return TriggerSettings(
            name=spec.name, trigger_type=spec.trigger_type, channels=idx,
            threshold_high=float(spec.threshold_high_sigma * self.Vrms_trigger),
            threshold_low=float(spec.threshold_low_sigma * self.Vrms_trigger),
            highlow_coincidence=spec.highlow_coincidence,
            number_of_coincidences=spec.number_of_coincidences,
            channel_coincidence=spec.channel_coincidence,
            requires=spec.requires, **pa)

    def _build_channel_params(self, station_id) -> ChannelParams:
        """Per-channel tensors of one station (simulation.py:528)."""
        station = self.det.get_station(station_id)
        ch = station.channels
        dt = 1.0 / self.internal_rate
        C = len(ch.channel_ids)
        freqs_int = np.fft.rfftfreq(self.n_internal, dt)
        freqs_base = np.fft.rfftfreq(self.n_base, dt)
        rot = np.zeros((C, 3, 3))
        kind = np.zeros(C, dtype=np.int64)
        templates = np.zeros((C, 3, len(freqs_int)), dtype=complex)
        tables = []
        for i in range(C):
            model = self.antenna_replacements.get(ch.antenna_model[i], ch.antenna_model[i])
            table = None
            if model not in antenna.ANALYTIC_MODELS:
                # a tabulated pattern from a reference-format pickle under
                # antenna_models_path/<model>/<model>.pkl (antennapattern.py:1363)
                import os
                pkl = (os.path.join(self.antenna_models_path, model, f"{model}.pkl")
                       if self.antenna_models_path else None)
                if pkl is None or not os.path.exists(pkl):
                    raise NotImplementedError(
                        f"antenna model '{model}' has no tabulated data on "
                        "disk; provide antenna_models_path with the pickle "
                        "or antenna_replacements to an analytic model")
                table = antenna.load_antenna_table(pkl)
            tables.append(table)
            if table is None:
                kind[i] = antenna.ANALYTIC_MODELS[model][0]
                tpl = antenna.build_analytic_template(model, freqs_int)
                templates[i, :tpl.shape[0]] = tpl
                if tpl.shape[0] == 1:
                    templates[i, 1:] = tpl[0]
                model_orientation = antenna._MODEL_ORIENTATION
            else:
                # the detector orientation relative to the simulated antenna
                # frame stored in the pickle (antennapattern.py:1197)
                model_orientation = table.orientation
            rot[i] = antenna.antenna_rotation_matrix(
                ch.orientation_theta[i], ch.orientation_phi[i],
                ch.rotation_theta[i], ch.rotation_phi[i],
                model_orientation=model_orientation)
        ids = [int(c) for c in ch.channel_ids]
        filter_response = np.stack([
            self._chain_response_for(freqs_base, c, self.filter_chain) for c in ids])
        filter_response_int = np.stack([
            self._chain_response_for(freqs_int, c, self.filter_chain) for c in ids])
        trigger_filter_response = None
        if self.trigger_filter_chain is not None:
            trigger_filter_response = np.stack([
                self._chain_response_for(freqs_base, c, self.trigger_filter_chain)
                for c in ids])
        ff_cal = np.linspace(0, 0.5 * self.internal_rate, 10000)
        for cid in ids:
            if cid not in self.bandwidth_per_channel:
                bw = np.trapezoid(np.abs(self._chain_response_for(
                    ff_cal, cid, self.filter_chain)) ** 2, ff_cal)
                self.bandwidth_per_channel[cid] = bw
                self.Vrms_per_channel[cid] = self.Vrms * np.sqrt(bw / self.bandwidth)
        vrms_ch = np.array([self.Vrms_per_channel[c] for c in ids])
        bw_ch = np.array([self.bandwidth_per_channel[c] for c in ids])
        ctype = torch.complex64 if self.dtype == torch.float32 else torch.complex128

        def real(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype,
                                   device=self.device)

        def cplx(a):
            return torch.as_tensor(a, dtype=ctype, device=self.device)

        antenna_table = None
        if any(t is not None for t in tables):
            if not all(t is not None for t in tables):
                raise NotImplementedError(
                    "mixing tabulated and analytic antenna models in one "
                    "station is not supported yet")
            shapes = {t.h_theta.shape for t in tables}
            grids = {(tuple(t.freqs), tuple(t.thetas), tuple(t.phis)) for t in tables}
            if len(shapes) != 1 or len(grids) != 1:
                raise NotImplementedError(
                    "tabulated antenna models of one station must share the "
                    "same (freq, theta, phi) grid")
            t0 = tables[0]
            antenna_table = AntennaTableParams(
                freqs=real(t0.freqs), thetas=real(t0.thetas), phis=real(t0.phis),
                h_theta=cplx(np.stack([t.h_theta for t in tables])),
                h_phi=cplx(np.stack([t.h_phi for t in tables])))

        return ChannelParams(
            positions=real(ch.positions + station.absolute_position),
            cable_delays=real(ch.cable_delay),
            rot=real(rot),
            kind=torch.as_tensor(kind, device=self.device),
            templates=cplx(templates),
            filter_response=cplx(filter_response),
            filter_response_int=cplx(filter_response_int),
            threshold_high=real(np.full(C, self.trigger.threshold_high_sigma * self.Vrms)),
            threshold_low=real(np.full(C, self.trigger.threshold_low_sigma * self.Vrms)),
            noise_amplitude=real(vrms_ch / np.sqrt(bw_ch / (0.5 * self.internal_rate))),
            min_efield_amplitude=real(np.full(
                C, float(self.config["speedup"]["min_efield_amplitude"]) * self.Vrms_efield)),
            trigger_filter_response=(None if trigger_filter_response is None
                                     else cplx(trigger_filter_response)),
            antenna_table=antenna_table,
        )

    def _build_batches(self):
        """Pad per-shower rows into [G, S_max] numpy arrays (simulation.py:665)."""
        inp = self.input
        group_ids, start, count, order = _group_showers(inp.event_group_ids)
        split_gap = float(self.config.get("split_event_time_diff", 1e6))
        if np.any(count > 1):
            # split a group into sub-events where vertex times gap by more
            # than split_event_time_diff (simulation.py:678-695)
            new_order, new_start, new_count, new_gids = [], [], [], []
            pos = 0
            for g in range(len(group_ids)):
                rows = order[start[g]:start[g] + count[g]]
                sub = group_into_events(inp.vertex_times[rows], split_gap)
                for s_idx in np.unique(sub):
                    sel = rows[sub == s_idx]
                    new_order.append(sel)
                    new_start.append(pos)
                    new_count.append(len(sel))
                    new_gids.append(group_ids[g])
                    pos += len(sel)
            order = np.concatenate(new_order)
            start = np.asarray(new_start, dtype=np.int64)
            count = np.asarray(new_count, dtype=np.int64)
            group_ids = np.asarray(new_gids, dtype=group_ids.dtype)
        S = int(count.max())
        dt = np.float64 if self.dtype == torch.float64 else np.float32
        pad_src = {"xx": inp.xx, "yy": inp.yy, "zz": inp.zz,
                   "energies": inp.shower_energies,
                   "is_em": (inp.shower_type == "em").astype(float),
                   "zeniths": inp.zeniths, "azimuths": inp.azimuths,
                   "vertex_times": inp.vertex_times}
        if self.emitter_mode:
            # the emitter columns of the input (simulation.py:706-714)
            em = inp.emitter or {}
            n = inp.n_showers
            pad_src["emitter_polarization"] = np.asarray(
                em.get("emitter_polarization", np.full(n, 0.5)), dtype=float)
            pad_src["emitter_frequency"] = np.asarray(
                em.get("emitter_frequency", np.zeros(n)), dtype=float)
            if "emitter_time" in em:
                pad_src["vertex_times"] = np.asarray(em["emitter_time"], dtype=float)
        cols, mask = _pad_columns(pad_src, order, start, count, S)
        energies = cols["energies"].astype(dt)
        mask = mask & (energies > 0)
        zen, az = cols["zeniths"].astype(dt), cols["azimuths"].astype(dt)
        axis = np.stack([np.sin(zen) * np.cos(az), np.sin(zen) * np.sin(az),
                         np.cos(zen)], axis=-1)
        is_em = cols["is_em"] > 0.5
        k_L = np.zeros_like(energies)
        profile_idx = None
        self._realizations = {}
        model = self.config["signal"]["model"]
        if model == "Alvarez2009" or self.arz_library is not None:
            # per-shower realizations: drawn on the host in the JAX
            # package's order, first every k_L, then the ARZ library picks
            # (simulation.py:734-760), or reused from the input file
            rng = np.random.default_rng(np.random.Philox(int(self.config["seed"])))
            k_L = askaryan.draw_alvarez2009_k_L(np.maximum(energies, 1.0), is_em,
                                                rng).astype(dt)
            if inp.shower_realization_Alvarez2009 is not None:
                reuse, _ = _pad_columns(
                    {"k_L": inp.shower_realization_Alvarez2009}, order, start, count, S)
                k_L = reuse["k_L"].astype(dt)
            if self.arz_library is not None:
                n_em = max(int(self.arz_library.ce_em.shape[0]), 1)
                n_had = max(int(self.arz_library.ce_had.shape[0]), 1)
                profile_idx = np.where(
                    is_em, rng.integers(0, n_em, is_em.shape),
                    rng.integers(0, n_had, is_em.shape)).astype(np.int64)
                if inp.shower_realization_ARZ is not None:
                    reuse, _ = _pad_columns(
                        {"iN": inp.shower_realization_ARZ}, order, start, count, S)
                    profile_idx = reuse["iN"].astype(np.int64)
            # unpadded per input row, for the output (simulation.py:762-775)
            arz = model.startswith("ARZ")
            flat = np.zeros(inp.n_showers, dtype=np.int64 if arz else float)
            src = profile_idx if arz else k_L
            for g in range(len(start)):
                flat[order[start[g]:start[g] + count[g]]] = src[g, :count[g]]
            self._realizations["shower_realization_ARZ" if arz
                               else "shower_realization_Alvarez2009"] = flat
        emitter_pol = None
        if self.emitter_mode:
            # emitter runs: k_L carries the per-row emitter frequency (cw,
            # tone_burst); no Askaryan realizations (simulation.py:776-782)
            k_L = cols["emitter_frequency"].astype(dt)
            emitter_pol = cols["emitter_polarization"].astype(dt)
            self._realizations = {}
        batch = ShowerBatch(
            vertices=np.stack([cols["xx"], cols["yy"], cols["zz"]], axis=-1).astype(dt),
            energies=energies, is_em=is_em, shower_mask=mask,
            prop_dir=(-axis).astype(dt), k_L=k_L,
            vertex_times=cols["vertex_times"].astype(dt),
            profile_idx=profile_idx, emitter_polarization=emitter_pol)
        return group_ids, start, count, order, batch

    def _weights(self, group_ids, start, count, order):
        """Per-group earth-absorption weight (simulation.py:791)."""
        inp = self.input
        if self.emitter_mode:
            return np.ones(len(group_ids))
        first = order[start]
        return earth_attenuation.get_weight(
            inp.zeniths[first], inp.energies[first], inp.flavors[first],
            mode=self.config["weights"]["weight_mode"],
            cross_section_type=self.config["weights"]["cross_section_type"],
            vertex_position=np.c_[inp.xx[first], inp.yy[first], inp.zz[first]],
            phi_nu=inp.azimuths[first])

    def _on_device(self, batch, rows):
        """The ``rows`` (a slice or indices) of the host batch as tensors on
        the run's device."""
        return ShowerBatch(*[None if a is None else torch.as_tensor(
            np.ascontiguousarray(a[rows]), device=self.device) for a in batch])

    def _noise_generator(self, seed_offset, chunk_index, stream=0):
        """The noise generator of one chunk on ``noise_device`` (None without
        noise), seeded from ``SeedSequence([seed, seed_offset, chunk_index])``
        (``stream`` appended for the ``.nur`` re-run), so a chunk draws the
        same numbers on whichever rank runs it."""
        if not self.settings.add_noise:
            return None
        key = [int(self.config["seed"]), int(seed_offset), int(chunk_index)]
        seq = np.random.SeedSequence(key + [int(stream)] if stream else key)
        gen = torch.Generator(device=self.noise_device)
        gen.manual_seed(int(seq.generate_state(1, np.uint64)[0]))
        return gen

    def _my_chunks(self, n):
        """The chunk indices of ``n`` chunks this rank runs: all of them
        without a mesh, else every n_event-th from its event index."""
        if self.mesh is None:
            return range(n)
        return range(self.mesh.event.index, n, self.mesh.n_event)

    def _run_chunk(self, station_id, batch, sl, gen, **kw):
        """``simulate_batch`` on the groups ``sl`` of the host batch (on the
        mesh's channel axis where there is one)."""
        return simulate_batch(self._on_device(batch, sl), self.channel_params_per_station[
            station_id], self.settings, noise_generator=gen, emitter=self._emitter,
            arz_library=self.arz_library,
            channel_axis=None if self.mesh is None else self.mesh.channel, **kw)

    def _run_station(self, station_id, batch, seed_offset=0):
        """The pipeline over all groups of one station, chunk by chunk (this
        rank's chunks on a mesh, then every chunk's host results gathered
        over the event axis); the noise of chunk i comes from
        :meth:`_noise_generator` ``(seed_offset, i)``."""
        G = batch.energies.shape[0]
        chp = self.channel_params_per_station[station_id]
        C = chp.positions.shape[0]
        T = len(self.triggers)
        keys = ("max_amp_shower_and_ray", "ray_tracing_C0", "ray_tracing_C1",
                "ray_tracing_solution_type", "ray_tracing_reflection",
                "ray_tracing_reflection_case", "focusing_factor", "launch_vectors",
                "receive_vectors", "polarization", "travel_times", "travel_distances",
                "time_shower_and_ray", "sol_mask")
        cd = chp.cable_delays.cpu().numpy()
        n_chunks = -(-G // self.chunk_size)
        mine = []
        for i in self._my_chunks(n_chunks):
            sl = slice(i * self.chunk_size, min((i + 1) * self.chunk_size, G))
            out = self._run_chunk(station_id, batch, sl,
                                  self._noise_generator(seed_offset, i))
            trig = out.triggered.cpu().numpy()
            res = {"i": i, "triggered": trig, "max_amp": out.max_amplitude.cpu().numpy(),
                   "trigger_time": out.trigger_time.cpu().numpy(),
                   "triggered_per": out.triggered_per.cpu().numpy(),
                   "trigger_times_per": out.trigger_times_per.cpu().numpy()}
            idx = np.where(trig)[0]
            if len(idx):
                sel = torch.as_tensor(idx, device=self.device)

                def pick(t):
                    return t[sel].cpu().numpy()

                # cartesian polarization at the antenna (HDF5_structure.rst)
                rec = out.receive_vector[sel]
                zen = torch.arccos(torch.clamp(rec[..., 2], -1.0, 1.0))
                az = torch.atan2(rec[..., 1], rec[..., 0])
                tt = pick(out.travel_time)
                res["rows"] = {
                    "g_idx": idx + sl.start,
                    "max_amp_shower_and_ray": pick(out.max_amp_per_solution),
                    "ray_tracing_C0": pick(out.c0), "ray_tracing_C1": pick(out.c1),
                    "ray_tracing_solution_type": pick(out.sol_type),
                    "ray_tracing_reflection": pick(out.reflection),
                    "ray_tracing_reflection_case": pick(out.refl_case),
                    "focusing_factor": pick(out.focusing),
                    "launch_vectors": pick(out.launch_vector),
                    "receive_vectors": pick(out.receive_vector),
                    "polarization": geometry.onsky_to_ground(
                        out.polarization[sel], zen, az).cpu().numpy(),
                    "travel_times": tt, "travel_distances": pick(out.path_length),
                    "time_shower_and_ray": tt + cd[None, None, :, None],
                    "sol_mask": pick(out.sol_mask)}
            mine.append(res)
        chunks = mine
        if self.mesh is not None:
            chunks = [r for part in mesh_util.gather_objects(mine, self.mesh.event) for r in part]
        triggered = np.zeros(G, dtype=bool)
        max_amp = np.zeros((G, C))
        trigger_times = np.zeros(G)
        trig_per = np.zeros((G, T), dtype=bool)
        tt_per = np.zeros((G, T))
        rows = {k: [] for k in ("g_idx",) + keys}
        for res in sorted(chunks, key=lambda r: r["i"]):
            sl = slice(res["i"] * self.chunk_size, min((res["i"] + 1) * self.chunk_size, G))
            triggered[sl] = res["triggered"]
            max_amp[sl] = res["max_amp"]
            trigger_times[sl] = res["trigger_time"]
            trig_per[sl] = res["triggered_per"]
            tt_per[sl] = res["trigger_times_per"]
            for k, v in res.get("rows", {}).items():
                rows[k].append(v)
        return triggered, max_amp, trigger_times, rows, trig_per, tt_per

    def run(self):
        """Run all stations; a group triggers if any station does
        (simulation.py:1072). Returns the results dict of the JAX package."""
        group_ids, start, count, order, batch = self._build_batches()
        G = batch.energies.shape[0]
        weights = self._weights(group_ids, start, count, order)
        T = len(self.triggers)
        per_station = {}
        triggered = np.zeros(G, dtype=bool)
        trigger_times = np.full(G, np.inf)
        multiple_triggers = np.zeros((G, T), dtype=bool)
        trigger_times_per = np.full((G, T), np.inf)
        for k, sid in enumerate(self.det.get_station_ids()):
            trig_s, amp_s, tt_s, rows_s, trigper_s, ttper_s = self._run_station(sid, batch, k)
            per_station[sid] = (trig_s, amp_s, tt_s, rows_s, trigper_s)
            triggered |= trig_s
            trigger_times = np.where(trig_s, np.minimum(trigger_times, tt_s), trigger_times)
            multiple_triggers |= trigper_s
            trigger_times_per = np.where(trigper_s, np.minimum(trigger_times_per, ttper_s),
                                         trigger_times_per)
        trigger_times = np.where(np.isfinite(trigger_times), trigger_times, 0.0)
        trigger_times_per = np.where(np.isfinite(trigger_times_per), trigger_times_per, np.nan)
        _, max_amp, _, _, _ = per_station[self.station_id]

        # Veff (simulation.py:1105-1143): minimum-weight cut as zero weight,
        # sub-events OR-ed back to their parent group
        min_weight = float(self.config["speedup"]["minimum_weight_cut"])
        eff_weights = np.where(weights < min_weight, 0.0, weights)
        n_events = int(self.input.attrs["n_events"])
        volume = float(self.input.attrs.get("volume", np.nan))
        uniq, inv = np.unique(group_ids, return_inverse=True)
        trig_parent = np.zeros(len(uniq), dtype=bool)
        np.logical_or.at(trig_parent, inv, triggered)
        w_parent = np.zeros(len(uniq))
        w_parent[inv] = eff_weights
        veff = volume * float(np.sum(w_parent * trig_parent)) / n_events
        veff_per_trigger = {}
        for iT, name in enumerate(self.trigger_names):
            tp = np.zeros(len(uniq), dtype=bool)
            np.logical_or.at(tp, inv, multiple_triggers[:, iT])
            veff_per_trigger[name] = volume * float(np.sum(w_parent * tp)) / n_events

        results = {
            "group_ids": group_ids, "triggered": triggered, "weights": weights,
            "max_amplitude": max_amp, "trigger_times": trigger_times,
            "multiple_triggers": multiple_triggers,
            "trigger_times_per_trigger": trigger_times_per,
            "trigger_names": list(self.trigger_names),
            "veff": veff, "veff_per_trigger": veff_per_trigger,
            "n_triggered": int(np.sum(trig_parent)),
            # each station's decision per group: what the output file's
            # station groups hold, for runs without h5py
            "triggered_per_station": {sid: v[0] for sid, v in per_station.items()},
            **self._realizations,
        }
        if self.simulation_mode == "atmospheric_muon":
            # surface muons: the generation area and zenith band carry
            # through, and Aeff comes from the results (T03check_output.py)
            results.update(area=float(self.input.attrs["area"]),
                           thetamin=float(self.input.attrs["thetamin"]),
                           thetamax=float(self.input.attrs["thetamax"]), n_events=n_events)
            results["aeff"] = veff_util.aeff_from_results(results)
        rank0 = self.mesh is None or self.mesh.rank == 0
        if self.outputfilename is not None and rank0:
            self._write_output(results, per_station, group_ids, start, count, order)
        if self.nur_outputfilename is not None:
            self._write_nur(group_ids, start, count, order, batch, triggered,
                            multiple_triggers, trigger_times_per)
        return results

    def _write_nur(self, group_ids, start, count, order, batch, triggered,
                   multiple_triggers, trigger_times_per):
        """The triggered groups as events with waveforms in a ``.nur`` file
        (simulation.py:1253-1317, the reference's outputfilenameNuRadioReco
        path): the triggered groups run again through ``simulate_batch``
        with ``keep_traces`` on the run's device (chunk i's noise from
        :meth:`_noise_generator` ``(0, i, stream=1)``; on a mesh each rank
        runs its chunks and rank 0 writes the file), each channel's readout
        trace resampled to the detector's rate; one ``Trigger`` per named
        trigger with its time, and the sim showers."""
        from nuradiomc_tpu_torch.framework import parameters as par
        from nuradiomc_tpu_torch.framework.event import (Channel, Event, Shower,
                                                         Station, Trigger)
        from nuradiomc_tpu_torch.sim import io_nur

        idx = np.where(triggered)[0]
        mine = []
        for i in self._my_chunks(-(-len(idx) // self.chunk_size)):
            sel = idx[i * self.chunk_size:(i + 1) * self.chunk_size]
            out = self._run_chunk(self.station_id, batch, sel,
                                  self._noise_generator(0, i, stream=1), keep_traces=True)
            mine.append((i, out.traces.cpu().numpy(), out.base_t0.cpu().numpy()))
        parts = mine
        if self.mesh is not None:
            parts = [r for part in mesh_util.gather_objects(mine, self.mesh.event) for r in part]
            if self.mesh.rank != 0:
                return
        parts = sorted(parts, key=lambda r: r[0])
        if len(idx):
            traces = np.concatenate([r[1] for r in parts])
            base_t0 = np.concatenate([r[2] for r in parts])
        writer = io_nur.EventWriter(self.nur_outputfilename)
        ch_det = self.det.get_station(self.station_id).channels
        shp = par.showerParameters
        inp = self.input
        for j, g in enumerate(idx):
            evt = Event(0, int(group_ids[g]))
            station = Station(self.station_id)
            for ci, cid in enumerate(ch_det.channel_ids):
                ch = Channel(int(cid))
                ch.set_trace(traces[j, ci], self.internal_rate,
                             trace_start_time=float(base_t0[j]))
                ch.resample(float(ch_det.sampling_frequency[ci]))
                station.add_channel(ch)
            for iT, spec in enumerate(self.triggers):
                fired = bool(multiple_triggers[g, iT])
                trig = Trigger(spec.name, list(spec.channels) or
                               [int(c) for c in ch_det.channel_ids], spec.trigger_type)
                trig.set_triggered(fired)
                if fired:
                    trig.set_trigger_time(float(trigger_times_per[g, iT]))
                station.set_trigger(trig)
            evt.set_station(station)
            for r in order[start[g]:start[g] + count[g]]:
                sh = Shower(int(inp.shower_ids[r]))
                sh[shp.energy] = float(inp.shower_energies[r])
                sh[shp.zenith] = float(inp.zeniths[r])
                sh[shp.azimuth] = float(inp.azimuths[r])
                sh[shp.vertex] = np.array([inp.xx[r], inp.yy[r], inp.zz[r]])
                sh[shp.type] = str(inp.shower_type[r])
                evt.add_sim_shower(sh)
            writer.run(evt)
        writer.end()

    def _write_output(self, results, per_station, group_ids, start, count, order):
        """Output HDF5 through the port's copy of the HDF5 writer (needs h5py)."""
        from nuradiomc_tpu_torch.sim import io_hdf5
        G = len(group_ids)
        T = len(self.triggers)
        n = self.input.n_showers
        trig_shower = np.zeros(n, dtype=bool)
        w_shower = np.zeros(n)
        tt_shower = np.full((n, T), np.nan)
        mt_shower = np.zeros((n, T), dtype=bool)
        for g in range(G):
            rows = order[start[g]:start[g] + count[g]]
            trig_shower[rows] = results["triggered"][g]
            w_shower[rows] = results["weights"][g]
            tt_shower[rows] = results["trigger_times_per_trigger"][g]
            mt_shower[rows] = results["multiple_triggers"][g]
        station_groups = {
            sid: self._station_group(rows_s, amp_s, tt_s, group_ids, start, count,
                                     order, trigper_s)
            for sid, (trig_s, amp_s, tt_s, rows_s, trigper_s) in per_station.items()}
        ch = self.det.get_station(self.station_id).channels
        io_hdf5.write_output_hdf5(
            self.outputfilename, self.input,
            {"triggered": trig_shower, "weights": w_shower,
             "multiple_triggers": mt_shower, "trigger_times": tt_shower,
             **self._realizations,
             **{f"station_{sid}": grp for sid, grp in station_groups.items()}},
            {"Veff": results["veff"], "n_triggered": results["n_triggered"],
             "Vrms": self.Vrms, "bandwidth": self.bandwidth,
             "trigger_names": np.array(self.trigger_names, dtype="S"),
             "antenna_positions": ch.positions,
             "n_samples": int(ch.n_samples[0]),
             "sampling_rate": float(ch.sampling_frequency[0]),
             "config": str(self.config)})

    def _station_group(self, station_rows, max_amp, trigger_times, group_ids,
                       start, count, order, trig_per):
        """One station's output group of the triggered groups' showers
        (simulation.py:1191, HDF5_structure.rst:150-182)."""
        if not station_rows["g_idx"]:
            return {}
        g_sel = np.concatenate(station_rows["g_idx"])
        m_rows, sh_ids, eg_ids = [], [], []
        for j, g in enumerate(g_sel):
            for s_idx, r in enumerate(order[start[g]:start[g] + count[g]]):
                m_rows.append((j, s_idx))
                sh_ids.append(self.input.shower_ids[r])
                eg_ids.append(group_ids[g])
        jj = np.array([m[0] for m in m_rows])
        ss = np.array([m[1] for m in m_rows])

        def gather(key):
            return np.concatenate(station_rows[key])[jj, ss]

        mask = gather("sol_mask")

        def nanify(key):
            a = np.array(gather(key), dtype=float)
            a[~mask] = np.nan
            return a

        return {
            "event_group_ids": np.array([group_ids[g] for g in g_sel]),
            "event_ids": np.zeros(len(g_sel), dtype=int),
            "event_group_id_per_shower": np.array(eg_ids),
            "event_id_per_shower": np.zeros(len(sh_ids), dtype=int),
            "shower_id": np.array(sh_ids),
            "triggered": np.ones(len(sh_ids), dtype=bool),
            "triggered_per_event": np.ones(len(g_sel), dtype=bool),
            "multiple_triggers": trig_per[g_sel][jj],
            "multiple_triggers_per_event": trig_per[g_sel],
            "maximum_amplitudes": max_amp[g_sel],
            "maximum_amplitudes_envelope": max_amp[g_sel],
            "trigger_times": trigger_times[g_sel][:, None][jj],
            "trigger_times_per_event": trigger_times[g_sel][:, None],
            "max_amp_shower_and_ray": nanify("max_amp_shower_and_ray"),
            "ray_tracing_C0": nanify("ray_tracing_C0"),
            "ray_tracing_C1": nanify("ray_tracing_C1"),
            "ray_tracing_solution_type": nanify("ray_tracing_solution_type"),
            "ray_tracing_reflection": nanify("ray_tracing_reflection"),
            "ray_tracing_reflection_case": nanify("ray_tracing_reflection_case"),
            "focusing_factor": nanify("focusing_factor"),
            "travel_times": nanify("travel_times"),
            "travel_distances": nanify("travel_distances"),
            "time_shower_and_ray": nanify("time_shower_and_ray"),
            "launch_vectors": np.concatenate(station_rows["launch_vectors"])[jj, ss],
            "receive_vectors": np.concatenate(station_rows["receive_vectors"])[jj, ss],
            "polarization": np.concatenate(station_rows["polarization"])[jj, ss],
        }
