"""The batched end-to-end MC pipeline (torch).

Counterpart of ``nuradiomc_tpu/sim/pipeline.py::simulate_batch`` on the paths
of the dipole effective-volume run, the phased-array run, the Gen2 composed
run, the multi-trigger station, the reflective-bottom (Moore's Bay) run,
emitter (pulser) runs, tabulated antennas and the ARZ shower model
(pipeline.py:541-632, :679-1160, :1174-1553). One call runs the whole chain
over a padded batch [group G x shower S x channel C x ray R] (R = 2 + 4
n_reflections solution slots) with validity masks in place of early exits:

1. ray tracing                      (ops.raytrace; with bottom reflections
   ``find_solutions_all``)
2. viewing angle and delta_C cut (no cut for emitters)
3. ZHS1992 / Alvarez2000 / Alvarez2009 spectra (ops.askaryan), the ARZ
   semi-analytic trace's eTheta spectrum (ops.arz), or in emitter mode the
   pulser's spectrum (ops.emitter), folded with the emitting antenna
4. polarization, Fresnel (one factor per surface touch), bottom-bounce and
   focusing factors, analytic VEL mix: folded into one complex scalar per
   (shower, channel, ray) on the factored chain; on the non-factored chain
   (birefringence, ``keep_efields``, emitters, tabulated antennas) the efield
   (eTheta, ePhi) spectra are materialized and, with birefringence,
   propagated through the ice's eigenbasis (ops.birefringence)
5. attenuation on a sparse frequency grid (SP1 by moments; any model and
   every bounce slot through ``attenuation_factor_slots``)
6. per-solution Hilbert-envelope maxima and the candidate cut
7. placement on the common time base + (shower, ray) reduction
   (ops.placement: kernel 1 on the factored chain, kernel 4 on the
   materialized voltage spectrum of the non-factored one)
8. noise (ops.noise), filter multiply (the readout chain and, where the
   station has one, a separate trigger chain on the same raw spectrum), and
   the list of named triggers: irfft, high/low or threshold trigger and
   majority logic for all such columns at once (ops.trigger_fused, kernel 2;
   a channel outside a trigger's subset gets a +inf threshold), and per
   phased-array trigger the chain of trigger ADC, upsampling, beams and power
   sums on its channels' rows (ops.pa_trigger, kernel 3)

Steps 7 and 8 run once per sub-event readout window (``n_windows``): pulses
later than the window's length after its first arrival go to the next
window, decisions OR across windows and the trigger time is the earliest
fired window's.

With the recorder of ``utils/timing.py`` on, step 1 is the span
``step.raytrace``, steps 2-6 ``step.signal``, step 7 ``step.placement`` and
step 8 ``step.trigger`` (the last two once per window and around the
window-independent work); with birefringence, its propagation is the span
``step.birefringence`` inside ``step.signal``, with the counter
``birefringence.paths`` (valid paths propagated; on the card also
``birefringence.kernel_paths``, the paths of the scan kernel's launch); each
blocking device-to-host read is a ``host_sync`` (``band_support``,
``birefringence``, ``arz_select``).

With ``channel_axis`` (a ``parallel.mesh.Axis`` over which C divides),
steps 1-7 run on this rank's slice of the channels; the OR over channels
(``candidate``, ``any_valid``, each window's ``any_rem``), the window
anchor's MIN and ``max_efield``'s MAX are collectives over the axis, the
per-solution outputs are gathered along it, and each window's readout
spectrum is gathered before step 8, which every rank of the axis then runs
on all C channels with the same noise draws. MIN, OR and MAX are exact and
no channel's steps 1-7 read another channel, so the sharded call equals the
unsharded one bit for bit on the card. On the CPU, ATen's vectorized loops
run the last elements of a tensor through scalar code, whose complex
products can round a last bit differently at a rank's last channel; no
decision or amplitude has moved (tests/test_torch_channel_split.py).

``placement_impl`` / ``trigger_impl`` = "kernel" (default) go through the
kernel wrappers, which launch the CUDA kernels on CUDA tensors and run their
plain versions on CPU tensors; "plain" calls the plain versions directly on
any device (the on-card cross check). Everything the slice does not cover
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from nuradiomc_tpu_torch.models.ice import IceModelSimple
from nuradiomc_tpu_torch.ops import (antenna, arz as arz_ops, askaryan, birefringence,
                                     emitter as emitter_ops,
                                     noise as noise_ops, pa_trigger, phased_array,
                                     placement, raytrace, trace as trace_ops,
                                     trigger_fused)
from nuradiomc_tpu_torch.ops import fft_plan
from nuradiomc_tpu_torch.parallel import mesh as mesh_util
from nuradiomc_tpu_torch.utils import fft, geometry, timing
from nuradiomc_tpu_torch.utils.constants import speed_of_light


@dataclasses.dataclass(frozen=True)
class TriggerSettings:
    """One named trigger (pipeline.py:197); thresholds in volts, ``None``
    falls back to ChannelParams.threshold_high/low."""

    name: str = "default_high_low"
    trigger_type: str = "high_low"
    channels: tuple = ()
    threshold_high: float = None
    threshold_low: float = None
    highlow_coincidence: float = 5.0
    number_of_coincidences: int = 1
    channel_coincidence: float = 200.0
    pa_rolls: tuple = ()
    pa_window: int = 32
    pa_step: int = 16
    pa_upsampling: int = 1
    pa_threshold: float = 0.0
    pa_digitize: bool = False
    pa_adc_fs: float = 0.5
    pa_adc_nbits: int = 8
    pa_adc_range: float = 0.0
    requires: str = None


@dataclasses.dataclass(frozen=True)
class PipelineSettings:
    """Static configuration of the pipeline (field names as in the JAX
    package; its TPU-only fields are not carried over)."""

    ice: IceModelSimple
    attenuation_model: str = "SP1"
    askaryan_model: str = "Alvarez2000"
    n_internal: int = 512
    n_bisect: int = 96
    n_base: int = 2048
    sampling_rate: float = 2.0
    delta_C_cut: float = 0.698
    distance_cut: bool = False
    distance_cut_coefficients: tuple = (-1.56434411e02, 2.54131322e01,
                                        -1.34932379e00, 2.39984185e-02)
    distance_cut_sum_length: float = 10.0
    n_freq_attenuation: int = 25
    max_detector_freq: float = None
    n_reflections: int = 0
    n_windows: int = 1
    attenuation_steps: int = 16
    attenuation_quadrature: str = "gauss"
    attenuate_ice: bool = True
    apply_focusing: bool = False
    focusing_limit: float = 2.0
    focusing_dz: float = -0.01
    focusing_mode: str = "implicit"
    # "kernel": the kernel wrappers (CUDA kernel on the card, plain version
    # on the CPU); "plain": the plain versions on any device
    placement_impl: str = "kernel"
    trigger_impl: str = "kernel"
    # > 0: drop frequency rows whose |filter response| <= eps * max on every
    # channel from the placement DFT and the trigger irfft (pipeline.py:138)
    band_limit_eps: float = 0.0
    birefringence: bool = False
    birefringence_model: str = "southpole_A"
    birefringence_points: int = 256
    birefringence_iceflow: float = 0.0
    add_noise: bool = False
    noise_type: str = "rayleigh"
    noise_sampler: str = "phase"
    # every trigger of the station, in declaration order (``requires`` names
    # an earlier one); the JAX package's single-trigger fields map onto one
    # entry in ``convert.settings_from_jax``
    triggers: tuple = (TriggerSettings(),)

    def __post_init__(self):
        # the checks that depend on the settings alone, made once here
        if self.apply_focusing and self.focusing_mode not in ("implicit", "numeric"):
            raise ValueError(
                f"focusing_mode must be 'implicit' or 'numeric', got {self.focusing_mode!r}")
        if self.n_reflections > 0 and self.ice.refl_z is None:
            raise ValueError("n_reflections > 0 requires an ice model with a reflective bottom")
        if (self.placement_impl not in ("kernel", "plain")
                or self.trigger_impl not in ("kernel", "plain")):
            raise ValueError("placement_impl / trigger_impl must be 'kernel' or 'plain'")
        if not self.triggers:
            raise ValueError("triggers must name at least one trigger")
        name_to_col = {t.name: i for i, t in enumerate(self.triggers)}
        for i, t in enumerate(self.triggers):
            if t.trigger_type not in ("high_low", "simple_threshold", "phased_array"):
                raise NotImplementedError(f"trigger type {t.trigger_type}")
            if t.requires and name_to_col.get(t.requires, i) >= i:
                raise ValueError(
                    f"trigger {t.name!r} requires {t.requires!r}, which "
                    "must be declared earlier in the trigger list")

    @property
    def dt(self) -> float:
        return 1.0 / self.sampling_rate

    # the settings carry no device: the frequency grids are host float64,
    # from which each stage makes its tensors on the batch's device
    @property
    def freqs_internal(self) -> np.ndarray:
        return np.fft.rfftfreq(self.n_internal, self.dt)

    @property
    def freqs_base(self) -> np.ndarray:
        return np.fft.rfftfreq(self.n_base, self.dt)


class ChannelParams(NamedTuple):
    """Per-channel tensors of one station."""

    positions: torch.Tensor           # [C, 3]
    cable_delays: torch.Tensor        # [C]
    rot: torch.Tensor                 # [C, 3, 3]
    kind: torch.Tensor                # [C] analytic antenna kind
    templates: torch.Tensor           # [C, 3, F_int] complex
    filter_response: torch.Tensor     # [C, F_base] complex
    filter_response_int: torch.Tensor  # [C, F_int] complex
    threshold_high: torch.Tensor      # [C]
    threshold_low: torch.Tensor       # [C]
    noise_amplitude: torch.Tensor     # [C]
    # [C]; None: no candidate cut (decided where the params are made)
    min_efield_amplitude: Optional[torch.Tensor]
    trigger_filter_response: Optional[torch.Tensor] = None
    # tabulated antenna patterns: the VEL comes from trilinear interpolation
    # of the grids per direction; ``templates`` / ``kind`` are ignored
    antenna_table: Optional["AntennaTableParams"] = None


class AntennaTableParams(NamedTuple):
    """Per-channel stacked tabulated antenna grids on a common grid
    (pipeline.py:267); h_* are [C, F0, T, P] complex."""

    freqs: torch.Tensor     # (F0,)
    thetas: torch.Tensor    # (T,)
    phis: torch.Tensor      # (P,)
    h_theta: torch.Tensor   # (C, F0, T, P)
    h_phi: torch.Tensor     # (C, F0, T, P)


class EmitterParams(NamedTuple):
    """Static parameters of an artificial emitter run, one emitter antenna
    model per batch (pipeline.py:514). In emitter mode the ShowerBatch is
    read anew: ``vertices`` are emitter positions, ``energies`` the pulser
    amplitudes, ``k_L`` the emitter frequency (cw / tone_burst) and
    ``vertex_times`` the emitter times."""

    model: str                 # emitter signal model (ops.emitter)
    templates: torch.Tensor    # [3, F_int] emitting-antenna VEL templates
    rot: torch.Tensor          # [3, 3]
    kind: int
    half_width: float = 5.0
    # measured-waveform models: the unit-amplitude voltage spectrum [F_int]
    unit_spec: Optional[torch.Tensor] = None
    # efield_idl1_spice: measured per-launch-angle (eTheta, ePhi) unit
    # spectra, angles [A] ascending (rad) and specs [A, 2, F_int]
    spice_angles: Optional[torch.Tensor] = None
    spice_specs: Optional[torch.Tensor] = None


class ShowerBatch(NamedTuple):
    """Padded event-group batch (leading axes [G, S])."""

    vertices: torch.Tensor      # [G, S, 3]
    energies: torch.Tensor      # [G, S]
    is_em: torch.Tensor         # [G, S] bool
    shower_mask: torch.Tensor   # [G, S] bool
    prop_dir: torch.Tensor      # [G, S, 3]
    k_L: torch.Tensor           # [G, S] (Alvarez2009 only)
    vertex_times: torch.Tensor  # [G, S]
    profile_idx: Optional[torch.Tensor] = None
    emitter_polarization: Optional[torch.Tensor] = None


class PipelineOutput(NamedTuple):
    triggered: torch.Tensor        # [G] bool
    candidate: torch.Tensor        # [G] bool
    max_efield: torch.Tensor       # [G]
    trigger_time: torch.Tensor     # [G]
    max_amplitude: torch.Tensor    # [G, C]
    traces: Optional[torch.Tensor]  # [G, C, n_base] window 0's readout traces (keep_traces)
    base_t0: torch.Tensor          # [G]
    sol_mask: torch.Tensor         # [G, S, C, 2]
    c0: torch.Tensor
    c1: torch.Tensor
    sol_type: torch.Tensor
    travel_time: torch.Tensor
    path_length: torch.Tensor
    launch_vector: torch.Tensor    # [G, S, C, 2, 3]
    receive_vector: torch.Tensor   # [G, S, C, 2, 3]
    polarization: torch.Tensor     # [G, S, C, 2, 3] on-sky at the vertex
    viewing_angle: torch.Tensor
    max_amp_per_solution: torch.Tensor  # [G, S, C, 2]
    focusing: torch.Tensor         # [G, S, C, 2]
    reflection: Optional[torch.Tensor] = None
    refl_case: Optional[torch.Tensor] = None
    efields: Optional[torch.Tensor] = None           # [2, G, S, C, 2, F] (keep_efields)
    triggered_per: Optional[torch.Tensor] = None      # [G, T]
    trigger_times_per: Optional[torch.Tensor] = None  # [G, T]


# ---- numpy host helpers, verbatim copies of the JAX package's ------------
# (the irfft, placement, decimation and upsampling matrices are in
# ops/fft_plan.py)

# copied from nuradiomc_tpu/sim/pipeline.py:370 (_band_support)
def _band_support(responses, eps, full):
    """Highest frequency index (exclusive) whose |response| exceeds
    ``eps * max|response|`` on ANY channel in any of the given response
    arrays, rounded up to a multiple of 8 (sublane alignment; Mosaic and
    the MXU pad the lane dim themselves, so finer-grained truncation
    keeps more of the saving). Returns ``full`` when nothing can be
    dropped — including when a response is a traced value (mesh argument
    form: the support must be static, so band limiting is silently
    disabled there)."""
    k = 0
    for resp in responses:
        if resp is None:
            continue
        if not isinstance(resp, np.ndarray):
            return full
        mag = np.max(np.abs(np.asarray(resp)), axis=0)
        keep = mag > eps * mag.max()
        if not keep.any():
            continue
        k = max(k, int(np.flatnonzero(keep).max()) + 1)
    if k == 0 or k >= full:
        return full
    return int(min(full, -(-k // 8) * 8))


# copied from nuradiomc_tpu/sim/pipeline.py:414 (_interp_matrix)
@functools.lru_cache(maxsize=8)
def _interp_matrix(x_sparse: tuple, x_dense: tuple):
    """W[s, d] with (v_sparse @ W) == np.interp(x_dense, x_sparse, v_sparse)."""
    import numpy as _np
    xs = _np.asarray(x_sparse)
    xd = _np.asarray(x_dense)
    W = _np.zeros((len(xs), len(xd)))
    idx = _np.clip(_np.searchsorted(xs, xd) - 1, 0, len(xs) - 2)
    x0, x1 = xs[idx], xs[idx + 1]
    t = _np.clip((xd - x0) / (x1 - x0), 0.0, 1.0)
    W[idx, _np.arange(len(xd))] = 1.0 - t
    W[idx + 1, _np.arange(len(xd))] = t
    return W


# copied from nuradiomc_tpu/sim/pipeline.py:428 (_attenuation_freq_grid)
def _attenuation_freq_grid(ff, n_freq, max_detector_freq=None):
    """The reference's sparse frequency vector for the attenuation integral
    (analyticraytracing.py:885-931): n_freq points over the positive
    detector band (0, f_nyq_det] plus n_freq//2 points over
    (f_nyq_det, f_max] when the internal band extends beyond the detector —
    linear interpolation of the attenuation curve between THESE nodes is
    part of the conformance contract (the interpolation error is a few
    percent mid-band and both sides must make the same one)."""
    ff = np.asarray(ff)
    pos = ff[ff > 0]
    n = min(int(n_freq), pos.size)
    if max_detector_freq is not None and n < pos.size:
        det = pos[pos <= max_detector_freq]
        if det.size:
            n = min(int(n_freq), det.size)
            freqs = np.linspace(det.min(), det.max(), n)
            above = pos[pos > max_detector_freq]
            if above.size > 1:
                freqs = np.append(
                    freqs, np.linspace(above.min(), above.max(), n // 2))
            return freqs
    return np.linspace(pos.min(), pos.max(), n)


_ASKARYAN_MODELS = ("ZHS1992", "Alvarez2000", "Alvarez2009", "ARZ2019", "ARZ2020")


def _check_slice(batch: ShowerBatch, s: PipelineSettings, emitter, arz_library):
    """The checks that need the call's arguments (the settings' own run in
    ``PipelineSettings.__post_init__``)."""
    if emitter is None and s.askaryan_model not in _ASKARYAN_MODELS:
        raise NotImplementedError(
            f"Askaryan model {s.askaryan_model} is not implemented in the pipeline; "
            f"available: {_ASKARYAN_MODELS}")
    if (emitter is None and s.askaryan_model.startswith("ARZ")
            and (arz_library is None or batch.profile_idx is None)):
        raise ValueError("ARZ models require arz_library and batch.profile_idx")


def _phased_array_trigger(t: TriggerSettings, spec_re, spec_im, s: PipelineSettings, C: int):
    """One phased-array trigger on the filtered spectra [G*C, K]
    (pipeline.py:575-632 in matmul form, :1336-1380 for the kernel route):
    (fired [G], first frame [G], amp [G, C], seconds per frame)."""
    G = spec_re.shape[0] // C
    K = spec_re.shape[1]
    dtype, dev = spec_re.dtype, spec_re.device
    scale_full = s.sampling_rate / math.sqrt(2.0)
    up = int(t.pa_upsampling)
    if t.pa_digitize:
        # irfft at 5 GHz, stride-decimated to the ADC rate; then ADC,
        # upsampling, beams and power sums
        fs_hi = 5.0
        n_hi = int(round(s.n_base * fs_hi / s.sampling_rate))
        fn = (pa_trigger.fused_pa_trigger if s.trigger_impl == "kernel"
              else pa_trigger.fused_pa_trigger_plain)
        fired, frame, amp = fn(
            spec_re, spec_im, n_base=s.n_base, n_hi=n_hi,
            decim=int(round(fs_hi / t.pa_adc_fs)), up=up, scale_full=scale_full,
            scale_dec=fs_hi / math.sqrt(2.0), rolls=t.pa_rolls,
            threshold=t.pa_threshold, window=t.pa_window, step=t.pa_step,
            v_min=-t.pa_adc_range / 2, lsb=t.pa_adc_range / (2 ** t.pa_adc_nbits - 1),
            n_counts=2 ** t.pa_adc_nbits, C=C)[:3]
        return fired, frame, amp, t.pa_step / (t.pa_adc_fs * up)
    # no ADC: the trigger traces at the internal rate, optionally upsampled
    I_r, I_i = fft_plan.irfft_dense(s.n_base, K, dtype, dev)
    tr = (spec_re @ I_r + spec_im @ I_i) * scale_full
    amp = torch.amax(torch.abs(tr), dim=-1).reshape(G, C)
    if up > 1:
        tr = tr @ fft_plan.upsample_dense(s.n_base, up, dtype, dev)
    fired, frame, _, _ = phased_array.phased_power_trigger(
        tr.reshape(G, C, -1), t.pa_rolls, t.pa_threshold, t.pa_window, t.pa_step)
    return fired, frame, amp, t.pa_step / (s.sampling_rate * up)


def _run_triggers(trig, readout, s: PipelineSettings, ch: ChannelParams,
                  G: int, C: int):
    """Every trigger of ``s.triggers`` on one window's spectra (pipeline.py:541-634,
    :1336-1460). ``trig`` = (re, im) [G*C, K_trig] of the trigger chain;
    ``readout`` = (re, im) [G*C, K_base] of the readout chain where it is a
    separate one, else None. All high/low and threshold triggers are the
    columns of one fused-trigger call; a channel outside a trigger's subset
    has threshold +inf there, so it never counts. Each phased-array trigger
    is one call on its channels' rows. Returns (fired [G] per trigger, time
    after the window start [G] per trigger, amp [G, C] of the readout
    chain over all channels)."""
    spec_re, spec_im = trig
    real_dtype, dev = spec_re.dtype, spec_re.device
    dt = s.dt
    Rc = G * C
    plain = s.trigger_impl != "kernel"
    fused = (trigger_fused.fused_irfft_trigger_plain if plain
             else trigger_fused.fused_irfft_trigger)
    scale = s.sampling_rate / math.sqrt(2.0)
    hl = [i for i, t in enumerate(s.triggers) if t.trigger_type != "phased_array"]
    pa = [i for i, t in enumerate(s.triggers) if t.trigger_type == "phased_array"]
    fired_cols, time_cols = {}, {}
    amp = None
    if hl:
        th_hi_cols, th_lo_cols, kspecs = [], [], []
        for t in (s.triggers[i] for i in hl):
            if t.threshold_high is not None:
                hi = torch.full((C,), t.threshold_high, dtype=real_dtype, device=dev)
            else:
                hi = ch.threshold_high.to(real_dtype)
            if len(t.channels):
                outside = torch.ones(C, dtype=torch.bool, device=dev)
                outside[list(t.channels)] = False
                hi = torch.where(outside, torch.inf, hi)
            if t.trigger_type == "high_low":
                if t.threshold_low is not None:
                    lo = torch.full((C,), t.threshold_low, dtype=real_dtype, device=dev)
                else:
                    lo = ch.threshold_low.to(real_dtype)
                nb_hl = max(int(round(t.highlow_coincidence / dt)), 1)
            else:
                lo = torch.zeros((C,), dtype=real_dtype, device=dev)
                nb_hl = 1
            th_hi_cols.append(hi.repeat(G))
            th_lo_cols.append(lo.repeat(G))
            kspecs.append(trigger_fused.TriggerSpecStatic(
                kind=t.trigger_type, n_bins_hl=nb_hl,
                n_bins_maj=min(max(int(round(t.channel_coincidence / dt)), 1), s.n_base),
                n_coinc=t.number_of_coincidences))
        fired, first, amp_trig = fused(
            spec_re, spec_im, torch.stack(th_hi_cols, dim=-1),
            torch.stack(th_lo_cols, dim=-1), n_base=s.n_base, scale=scale,
            triggers=tuple(kspecs), C=C)
        if readout is None:
            amp = amp_trig
        for j, i in enumerate(hl):
            fired_cols[i] = fired[:, j]
            time_cols[i] = first[:, j].to(real_dtype) * dt
    for i in pa:
        t = s.triggers[i]
        re, im, C_t = spec_re, spec_im, C
        if len(t.channels):
            sel = torch.as_tensor(list(t.channels), device=dev)
            C_t = len(t.channels)
            re, im = (x.reshape(G, C, -1)[:, sel].reshape(G * C_t, -1).contiguous()
                      for x in (spec_re, spec_im))
        fired, frame, amp_i, frame_s = _phased_array_trigger(t, re, im, s, C_t)
        fired_cols[i] = fired
        time_cols[i] = frame.to(real_dtype) * frame_s
        if readout is None and not hl and not len(t.channels):
            amp = amp_i if amp is None else torch.maximum(amp, amp_i)
    if amp is None:
        # no call above saw every channel of the readout chain: one more
        # fused call with no trigger column, for its max |trace|
        empty = spec_re.new_empty((Rc, 0))
        amp = fused(*(readout or trig), empty, empty, n_base=s.n_base, scale=scale,
                    triggers=(), C=C)[2]
    order = range(len(s.triggers))
    return [fired_cols[i] for i in order], [time_cols[i] for i in order], amp


def _birefringence(e_theta, e_phi, valid, geom: raytrace.Geometry2D, c0, ff_int,
                   s: PipelineSettings):
    """Birefringent propagation of the valid paths' efields, applied last
    (pipeline.py:993-1014, apply_propagation_effects:3020-3030); invalid
    paths keep their spectra (a select, as ``where(valid, ...)`` there).
    Only the valid paths are propagated: their results are the same, and
    the segment loop's work shrinks with the delta_C cut. After the read of
    the valid paths the span ``step.birefringence`` covers the rest; the
    counter ``birefringence.paths`` counts the paths of each call."""
    F = e_theta.shape[-1]
    with timing.host_sync("birefringence"):
        sel = torch.nonzero(valid.reshape(-1)).squeeze(1)
    shape = valid.shape

    def per_path(x):
        return x[..., None].expand(shape).reshape(-1)[sel]

    with timing.span("step.birefringence"):
        timing.count("birefringence.paths", sel.shape[0])
        g = raytrace.Geometry2D(*(per_path(f) for f in geom))
        path = birefringence.path_points_3d(c0.reshape(-1)[sel], g, s.ice,
                                            s.birefringence_points,
                                            iceflow_angle=s.birefringence_iceflow)
        bt, bp = birefringence.propagate_pulse(
            e_theta.reshape(-1, F)[sel], e_phi.reshape(-1, F)[sel], path, ff_int, s.ice,
            s.birefringence_model)
        return (e_theta.reshape(-1, F).index_copy(0, sel, bt).reshape(e_theta.shape),
                e_phi.reshape(-1, F).index_copy(0, sel, bp).reshape(e_phi.shape))


def _emitter_efields(emitter: EmitterParams, batch: ShowerBatch, launch, R_safe, n_vertex,
                     ff_int, s: PipelineSettings, bshape):
    """(eTheta, ePhi) spectra [G, S, C, R, F] at the receiver of an emitter
    run, before the propagation effects (pipeline.py:825-892)."""
    dt = s.dt
    amp = batch.energies[:, :, None, None]
    if emitter.model == "efield_idl1_spice":
        # measured SPICE pulser efields keyed by launch zenith: the
        # nearest-angle unit spectrum per path, scaled by the amplitude;
        # only the 1/R spreading applies (an efield model: no antenna)
        zen_sp, _ = geometry.cartesian_to_spherical(launch)
        idx = torch.argmin(torch.abs(zen_sp[..., None] - emitter.spice_angles), dim=-1)
        sp = emitter.spice_specs[idx]                              # [G,S,C,R,2,F]
        return (amp[..., None] * sp[..., 0, :] / R_safe[..., None],
                amp[..., None] * sp[..., 1, :] / R_safe[..., None])
    if emitter.model.startswith("efield_"):
        # efield models give (eR, eTheta, ePhi) directly: no emitting
        # antenna, no -i f n / c factor
        pol = (batch.emitter_polarization if batch.emitter_polarization is not None
               else torch.full_like(batch.energies, 0.5))
        spec3 = emitter_ops.get_frequency_spectrum(
            amp.expand(bshape), s.n_internal, dt, emitter.model,
            polarization=pol[:, :, None, None].expand(bshape),
            half_width=emitter.half_width)                         # [G,S,C,R,3,F]
        return spec3[..., 1, :] / R_safe[..., None], spec3[..., 2, :] / R_safe[..., None]
    # voltage models: the pulser's voltage spectrum folded with the emitting
    # antenna's VEL at the launch direction,
    # E = VEL (-i) V(f) f n / c / R (simulation.py:401-424)
    if emitter.unit_spec is not None:
        # a measured waveform: amplitude times the unit spectrum
        vspec = (amp[..., None] * emitter.unit_spec).expand(*bshape, -1)
    else:
        vspec = emitter_ops.get_frequency_spectrum(
            amp.expand(bshape), s.n_internal, dt, emitter.model,
            emitter_frequency=batch.k_L[:, :, None, None].expand(bshape),
            half_width=emitter.half_width)
    zen_l, az_l = geometry.cartesian_to_spherical(launch)
    vel_t, vel_p = antenna.analytic_vel(zen_l, az_l, emitter.rot, emitter.templates,
                                        emitter.kind, direction=launch)
    deriv = (-1j) * ff_int * n_vertex[:, :, None, None, None] / speed_of_light
    return (vel_t * vspec * deriv / R_safe[..., None],
            vel_p * vspec * deriv / R_safe[..., None])


def simulate_batch(batch: ShowerBatch, ch: ChannelParams, s: PipelineSettings,
                   noise_generator: Optional[torch.Generator] = None,
                   keep_traces: bool = False, keep_efields: bool = False,
                   emitter=None, arz_library=None,
                   channel_axis: Optional[mesh_util.Axis] = None) -> PipelineOutput:
    """Run the chain on a padded batch. All tensors share one device; the
    real dtype is ``batch.vertices.dtype`` (float32 or float64). With
    ``s.add_noise`` the noise is drawn from ``noise_generator`` (a
    ``torch.Generator`` on that device or on the host's, whose numbers are
    moved to it), one realization per (group, channel), where the JAX function takes a ``noise_key``. With
    ``keep_traces`` the output carries window 0's readout-chain traces
    [G, C, n_base] at the internal rate; the trigger decisions still come
    from kernels 2 and 3, the traces from ``torch.fft.irfft`` of the same
    full-band spectra (pipeline.py:1437, :1523-1542). ``channel_axis``:
    steps 1-7 on this rank's channels (see the module docstring); ``ch``
    holds all channels either way, and so do the outputs."""
    _check_slice(batch, s, emitter, arz_library)
    if s.add_noise and noise_generator is None:
        raise ValueError("add_noise=True requires a noise_generator")
    G, S = batch.energies.shape
    C_all = ch.positions.shape[0]
    # steps 1-7 read ``ch`` (this rank's channels), step 8 ``ch_all``
    ch_all = ch
    ch_slice = mesh_util.channel_split(C_all, channel_axis)
    ch_axis = channel_axis if ch_slice is not None else None
    if ch_slice is not None:
        ch = mesh_util.slice_channels(ch_all, ch_slice)
    C = ch.positions.shape[0]
    dt = s.dt
    real_dtype = batch.vertices.dtype
    dev = batch.vertices.device
    ctype = torch.complex64 if real_dtype == torch.float32 else torch.complex128
    ff_int_np = s.freqs_internal
    ff_int = torch.as_tensor(ff_int_np, dtype=real_dtype, device=dev)

    with timing.span("step.raytrace"):
        # ---- 1. ray tracing [G, S, C] pairs, 2 solution slots -------------------
        x1 = batch.vertices[:, :, None, :].expand(G, S, C, 3)
        x2 = ch.positions[None, None, :, :].expand(G, S, C, 3)
        geom = raytrace.to_2d(x1, x2)
        def solve(x1z, x2z):
            # with bottom reflections: 2 + 4 n_reflections slots
            return raytrace.find_solutions_all(geom.x1y, x1z, geom.x2y, x2z, s.ice,
                                               n_reflections=s.n_reflections,
                                               n_bisect=s.n_bisect)

        sols = solve(geom.x1z, geom.x2z)
        n_rays = sols.c0.shape[-1]
        bshape = (G, S, C, n_rays)
        launch, receive = raytrace.launch_receive_vectors(geom, sols)

    with timing.span("step.signal"):
        # ---- 2. viewing angle + delta_C cut ------------------------------------
        n_vertex = s.ice.index_of_refraction(batch.vertices[..., 2])   # [G, S]
        cherenkov = torch.arccos(1.0 / n_vertex)
        cos_view = torch.sum(batch.prop_dir[:, :, None, None, :] * launch, dim=-1)
        viewing_angle = torch.arccos(torch.clamp(cos_view, -1.0, 1.0))
        delta_C = viewing_angle - cherenkov[:, :, None, None]
        R_safe = torch.where(sols.path_length > 1.0, sols.path_length, 1.0)

        sol_mask = sols.mask
        if s.distance_cut:
            # energy-summed polynomial vertex-distance cut (pipeline.py:716-741)
            vd = torch.linalg.vector_norm(batch.vertices - batch.vertices[:, :1, :], dim=-1)
            near = torch.abs(vd[:, None, :] - vd[:, :, None]) < s.distance_cut_sum_length
            near = near & batch.shower_mask[:, None, :]
            e_sum = torch.sum(torch.where(near, batch.energies[:, None, :], 0.0), dim=-1)
            log10_E = torch.log10(torch.clamp(e_sum, min=1.0))
            c = s.distance_cut_coefficients
            log10_dmax = c[0] + c[1] * log10_E + c[2] * log10_E ** 2 + c[3] * log10_E ** 3
            d_max = torch.clamp(10.0 ** log10_dmax, min=100.0)
            dist = torch.linalg.vector_norm(
                batch.vertices[:, :, None, :] - ch.positions[None, None, :, :], dim=-1)
            sol_mask = sol_mask & (dist <= d_max[:, :, None])[..., None]

        # the scalar propagation factors fold into one complex scalar per path
        # unless the efield must be materialized: birefringence mixes the two
        # polarizations segment by segment, keep_efields returns them, an
        # emitter's efield has its own components, and a tabulated VEL depends on
        # the frequency per direction (pipeline.py:750-754)
        factored = (emitter is None and not s.birefringence and not keep_efields
                    and ch.antenna_table is None)

        def per_pair(x):
            return x[:, :, None, None].expand(bshape)

        if emitter is None:
            valid = (sol_mask & (torch.abs(delta_C) <= s.delta_C_cut)
                     & batch.shower_mask[:, :, None, None])                 # [G,S,C,R]

            # ---- 3. Askaryan spectra [G, S, C, R, F] ---------------------------
            if s.askaryan_model in ("ARZ2019", "ARZ2020"):
                # the eTheta component of the semi-analytic trace as a scalar
                # spectrum (pipeline.py:761-788), for the valid pairs only: the
                # others are masked out of everything downstream
                with timing.host_sync("arz_select"):
                    sel = torch.nonzero(valid.reshape(-1)).squeeze(1)

                def picked(x):
                    return x.reshape(-1)[sel]

                lib = arz_library.to(dev, real_dtype)
                spec = torch.zeros((valid.numel(), ff_int.shape[0]), dtype=ctype, device=dev)
                spec[sel] = arz_ops.get_frequency_spectrum(
                    picked(per_pair(batch.energies)), picked(viewing_angle), s.n_internal, dt,
                    lib, picked(per_pair(batch.is_em)), picked(per_pair(n_vertex)),
                    picked(R_safe), picked(per_pair(batch.profile_idx)),
                    version=s.askaryan_model)
                spec = spec.reshape(*bshape, -1)
            else:
                spec = askaryan.get_frequency_spectrum(
                    per_pair(batch.energies), viewing_angle, s.n_internal, dt,
                    per_pair(batch.is_em), per_pair(n_vertex), R_safe, s.askaryan_model,
                    k_L=per_pair(batch.k_L))

            # ---- 4. polarization on-sky at the vertex --------------------------
            axis = batch.prop_dir[:, :, None, None, :].expand(*bshape, 3)
            pol = torch.linalg.cross(launch, torch.linalg.cross(axis, launch, dim=-1), dim=-1)
            pol = pol / torch.clamp(torch.linalg.vector_norm(pol, dim=-1, keepdim=True), min=1e-30)
            zen_l, az_l = geometry.cartesian_to_spherical(launch)
            pol_onsky = geometry.ground_to_onsky(pol, zen_l, az_l)
            if not factored:
                e_theta = pol_onsky[..., 1:2] * spec                   # [G,S,C,R,F]
                e_phi = pol_onsky[..., 2:3] * spec
        else:
            # ---- 3'. emitter mode (pipeline.py:825-892): no delta_C cut ---------
            valid = sol_mask & batch.shower_mask[:, :, None, None]
            e_theta, e_phi = _emitter_efields(emitter, batch, launch, R_safe, n_vertex, ff_int,
                                              s, bshape)
            pol_onsky = torch.zeros((*bshape, 3), dtype=real_dtype, device=dev)

        # ---- 5. SP1 attenuation on the sparse grid -----------------------------
        F_int = ff_int.shape[0]
        if s.attenuate_ice:
            sparse_np = _attenuation_freq_grid(tuple(ff_int_np), s.n_freq_attenuation,
                                               s.max_detector_freq)
            sparse = torch.as_tensor(sparse_np, dtype=real_dtype, device=dev)
            if s.n_reflections > 0:
                # one code path with per-slot (r, case, mirror) for the base and
                # the bounce slots, SP1 included (pipeline.py:464-482)
                att_vals = raytrace.attenuation_factor_slots(
                    sols.c0, sols.sol_type, sols.reflection, sols.refl_case,
                    geom.x1z[..., None], geom.x2z[..., None], s.ice, sparse,
                    s.attenuation_model, n_steps=s.attenuation_steps,
                    quadrature=s.attenuation_quadrature)
            else:
                att_vals = raytrace.attenuation_factor(
                    sols.c0, geom.x1y[..., None], geom.x1z[..., None],
                    geom.x2y[..., None], geom.x2z[..., None], s.ice, sparse,
                    s.attenuation_model, n_steps=s.attenuation_steps,
                    quadrature=s.attenuation_quadrature)              # [G,S,C,R,ns]
            att_W = torch.as_tensor(_interp_matrix(tuple(sparse_np), tuple(ff_int_np)),
                                    dtype=real_dtype, device=dev)
            att = torch.where(ff_int > 0, att_vals @ att_W, 1.0)
            if factored:
                spec_att = spec * att
            else:
                e_theta = e_theta * att
                e_phi = e_phi * att
        else:
            # a unit attenuation keeps the kernel's contract: ones @ ones = 1
            att_vals = torch.ones((*bshape, 1), dtype=real_dtype, device=dev)
            att_W = torch.ones((1, F_int), dtype=real_dtype, device=dev)
            if factored:
                spec_att = spec

        # surface-reflection Fresnel factors, one per surface touch
        n_surf = s.ice.index_of_refraction(torch.tensor(-1e-5, dtype=real_dtype, device=dev))
        refl_zenith = torch.atan(1.0 / torch.sqrt(torch.clamp(
            sols.c0 ** 2 * n_surf ** 2 - 1.0, min=1e-12)))
        r_p = geometry.fresnel_r_p(refl_zenith, n_2=1.0, n_1=n_surf)
        r_s = geometry.fresnel_r_s(refl_zenith, n_2=1.0, n_1=n_surf)
        z_turn_slots = raytrace.turning_depth(sols.c0, s.ice)
        n_touch = raytrace.surface_touches_slots(sols.sol_type, sols.reflection,
                                                 sols.refl_case, z_turn_slots)
        a_p = torch.ones_like(r_p)
        a_s = torch.ones_like(r_s)
        # a bounce slot touches the surface up to n_reflections + 1 times; all
        # touches of a slot share its C0, hence its angle (pipeline.py:928-932)
        for k in range(s.n_reflections + 1):
            a_p = torch.where(n_touch > k, a_p * r_p, a_p)
            a_s = torch.where(n_touch > k, a_s * r_s, a_s)
        if s.n_reflections > 0:
            # bottom bounces: refl_coef exp(i phase) per bounce on both
            # components (apply_propagation_effects:3004-3011)
            b1 = complex(s.ice.refl_coef * np.exp(1j * s.ice.refl_phase_shift))
            for k in range(s.n_reflections):
                bounce = sols.reflection > k
                a_p = torch.where(bounce, a_p * b1, a_p)
                a_s = torch.where(bounce, a_s * b1, a_s)
        if not factored:
            e_theta = e_theta * a_p[..., None]
            e_phi = e_phi * a_s[..., None]
        if s.apply_focusing:
            # the launch angle's convergence toward a displaced receiver
            # (pipeline.py:947-989)
            lau_ang = torch.arccos(torch.clamp(launch[..., 2], -1.0, 1.0))
            rec_ang = torch.arccos(torch.clamp(-receive[..., 2], -1.0, 1.0))
            if s.focusing_mode == "implicit" and s.n_reflections == 0:
                # the exact dz -> 0 derivative at the solved root
                d_launch_dz = raytrace.focusing_dtheta_dz(geom, sols, s.ice)
                foc_valid = sols.mask
            else:
                # "numeric": the finite difference of a second solve with the
                # receiver (the 2D x1 where the pair was swapped) moved by dz.
                # With bottom reflections always this one: the slot order of
                # find_solutions_all is fixed, so the displaced problem's slots
                # align one to one (pipeline.py:957-963)
                dz = s.focusing_dz
                x1z_d = torch.where(geom.swapped, geom.x1z + dz, geom.x1z)
                x2z_d = torch.where(geom.swapped, geom.x2z, geom.x2z + dz)
                sols1 = solve(x1z_d, x2z_d)
                launch1, _ = raytrace.launch_receive_vectors(
                    geom._replace(x1z=x1z_d, x2z=x2z_d), sols1)
                lau_ang1 = torch.arccos(torch.clamp(launch1[..., 2], -1.0, 1.0))
                d_launch_dz = torch.abs(lau_ang1 - lau_ang) / abs(dz)
                foc_valid = sols1.mask & sols.mask
            r_h = torch.abs(geom.x2y - geom.x1y)[..., None]
            dist = torch.clamp(sols.path_length, min=1.0)
            foc = torch.sqrt(dist / torch.clamp(torch.sin(rec_ang), min=1e-6) * d_launch_dz)
            foc = foc * torch.sqrt(dist * torch.sin(lau_ang) / torch.clamp(r_h, min=1e-6))
            foc = torch.clamp(torch.where(foc_valid, foc, 1.0), max=s.focusing_limit)
            # refractive-index correction between emitter and receiver
            n1 = s.ice.index_of_refraction(batch.vertices[..., 2])[:, :, None, None]
            n2 = s.ice.index_of_refraction(ch.positions[:, 2])[None, None, :, None]
            foc = foc * torch.sqrt(n1 / n2)
            if not factored:
                e_theta = e_theta * foc[..., None]
                e_phi = e_phi * foc[..., None]
        else:
            foc = torch.ones(bshape, dtype=real_dtype, device=dev)
        if s.birefringence:
            e_theta, e_phi = _birefringence(e_theta, e_phi, valid, geom, sols.c0, ff_int, s)
        if factored:
            amp_t_c = (pol_onsky[..., 1] * foc).to(ctype) * a_p
            amp_p_c = (pol_onsky[..., 2] * foc).to(ctype) * a_s

        # ---- 6a. candidate cut (simulation.py:283-286) -------------------------
        min_eff = ch.min_efield_amplitude
        if min_eff is None:
            ef_max = torch.zeros(bshape, dtype=real_dtype, device=dev)
            candidate = torch.ones((G,), dtype=torch.bool, device=dev)
        else:
            if factored:
                pols = [amp_t_c[..., None] * spec_att, amp_p_c[..., None] * spec_att]
            else:
                pols = [e_theta, e_phi]
            ef_traces = fft.freq2time(torch.stack(pols), s.sampling_rate, n=s.n_internal)
            ef_max = torch.amax(torch.abs(ef_traces), dim=(0, -1))
            ef_max = torch.where(valid, ef_max, 0.0)
            candidate = mesh_util.all_reduce_or(
                torch.any((ef_max > min_eff[None, None, :, None]).reshape(G, -1), dim=-1), ch_axis)

        # ---- 6b. antenna response: mixing scalars + template gather ------------
        zen_r, az_r = geometry.cartesian_to_spherical(receive)
        if ch.antenna_table is not None:
            # tabulated patterns: trilinear complex interpolation of the grids
            # at every receive direction, channel by channel (pipeline.py:1048-1065)
            tab = ch.antenna_table
            vel = [antenna.table_vel(
                zen_r[:, :, ci], az_r[:, :, ci], ch.rot[ci],
                antenna.AntennaTable(freqs=tab.freqs, thetas=tab.thetas, phis=tab.phis,
                                     h_theta=tab.h_theta[ci], h_phi=tab.h_phi[ci]), ff_int)
                for ci in range(C)]
            volt_spec = (torch.stack([v[0] for v in vel], dim=2) * e_theta
                         + torch.stack([v[1] for v in vel], dim=2) * e_phi)
        else:
            rot_b = ch.rot[None, None, :, None, :, :].expand(*bshape, 3, 3)
            kind_b = ch.kind[None, None, :, None].expand(bshape)
            mix_t, mix_p, sector = antenna.analytic_vel_mix(zen_r, az_r, rot_b, kind_b,
                                                            direction=receive)
            c_idx = torch.arange(C, device=dev)[None, None, :, None].expand(bshape)
            T = ch.templates[c_idx, sector]                                # [G,S,C,R,F]
            if factored:
                combined = mix_t.to(ctype) * amp_t_c + mix_p.to(ctype) * amp_p_c   # [G,S,C,R]
                volt_spec = T * combined[..., None] * spec_att
            else:
                volt_spec = (T * mix_t[..., None]) * e_theta + (T * mix_p[..., None]) * e_phi

        # per-solution Hilbert-envelope maximum after the filter chain
        volt_spec = torch.where(valid[..., None], volt_spec, 0.0)
        volt_spec = torch.where(ff_int < 5e-3, 0.0, volt_spec)        # DC removal
        sol_spec_filtered = volt_spec * ch.filter_response_int[None, None, :, None, :]
        max_amp_sol = torch.amax(trace_ops.hilbert_envelope_from_rfft(
            sol_spec_filtered, s.n_internal, s.sampling_rate), dim=-1)

    with timing.span("step.placement"):
        # ---- 7. placement into the common time base ----------------------------
        t_start = (batch.vertex_times[:, :, None, None] + sols.travel_time
                   - 0.5 * s.n_internal * dt + ch.cable_delays[None, None, :, None])
        any_valid = mesh_util.all_reduce_or(torch.any(valid.reshape(G, -1), dim=-1), ch_axis)
        cap = (s.n_base - s.n_internal) * dt
        F_base = s.n_base // 2 + 1
        # band limits (pipeline.py:1127-1158): with a separate trigger chain the
        # efield grid stays full, and the placement covers both chains' supports;
        # kept traces are user-visible waveforms, so the base grid stays full
        separate_chain = ch.trigger_filter_response is not None
        K_int, K_base, K_trig, K_place = F_int, F_base, F_base, F_base

        def support(response, full):
            with timing.host_sync("band_support"):
                response = response.cpu().numpy()
            return _band_support((response,), s.band_limit_eps, full)

        if s.band_limit_eps > 0 and not separate_chain:
            K_int = support(ch_all.filter_response_int, F_int)
        if s.band_limit_eps > 0 and not keep_traces:
            K_base = support(ch_all.filter_response, F_base)
            K_trig = support(ch_all.trigger_filter_response, F_base) if separate_chain else K_base
            K_place = max(K_base, K_trig)

        s2 = S * n_rays
        R = G * C * s2

        def ch_major(x):
            # [G, S, C, 2, ...] -> rows (g, c, s, r), (s, r) fastest
            return torch.movedim(x, 2, 1).reshape(R, *x.shape[4:]).contiguous()

        df_base = float(s.sampling_rate / s.n_base)
        kernel = s.placement_impl == "kernel"
        if factored:
            # the window-independent operands of the chain kernel
            tpl_idx = (c_idx * 3 + sector).to(torch.int32)
            dcmask = torch.as_tensor(ff_int_np >= 5e-3, device=dev)
            tpl_table = torch.where(dcmask, ch.templates.reshape(C * 3, -1), 0.0)
            chain_rows = (ch_major(spec.real)[:, :K_int].contiguous(),
                          ch_major(spec.imag)[:, :K_int].contiguous(),
                          ch_major(att_vals), ch_major(combined.real), ch_major(combined.imag))
            chain_tables = (ch_major(tpl_idx), att_W[:, :K_int].contiguous(),
                            tpl_table[:, :K_int].contiguous())

    def place_window(in_w, offset):
        """Step 7 of one sub-event readout window (pipeline.py:1174-1268):
        the in-window pulses placed on the common time base; every
        channel's raw spectrum [G, C_all, F_base] on every rank of the axis."""
        if factored:
            place = (placement.chain_placement_reduce if kernel
                     else placement.chain_placement_reduce_plain)
            out_re, out_im = place(
                *chain_rows, ch_major(in_w), chain_tables[0], ch_major(offset),
                *chain_tables[1:],
                s2=s2, df=df_base, n_int=s.n_internal, n_base=s.n_base, K_place=K_place)
        else:
            # the in-window voltage spectrum, placed as it is (pipeline.py:1262-1268)
            V = ch_major(torch.where(in_w[..., None], volt_spec, 0.0)[..., :K_int])
            place = placement.placement_reduce if kernel else placement.placement_reduce_plain
            out_re, out_im = place(V.real.contiguous(), V.imag.contiguous(), ch_major(offset),
                                   s2=s2, df=df_base, n_int=s.n_internal, n_base=s.n_base,
                                   K_place=K_place)
        raw_spec = torch.complex(out_re, out_im)
        if K_place < F_base:
            raw_spec = torch.nn.functional.pad(raw_spec, (0, F_base - K_place))
        return mesh_util.all_gather(raw_spec.reshape(G, C, F_base), 1, ch_axis)

    def trigger_window(raw_spec, t0_w, want_traces):
        """Step 8 of one window (pipeline.py:1294-1460), on all C_all
        channels: add noise, apply the chains, run every trigger. Returns
        (fired per trigger, time per trigger, amp [G, C], the readout traces
        [G, C, n_base] with ``want_traces``, else None)."""
        if s.add_noise:
            # one realization per (group, channel), added before the filter
            # (pipeline.py:1294-1310); each window draws anew
            # (drawn on the generator's device, which may be the host's)
            draws = noise_ops.draw_noise(noise_generator, (G, C_all), s.n_base, real_dtype,
                                         s.noise_type, s.noise_sampler)
            raw_spec = raw_spec + noise_ops.noise_spectrum_from_draws(
                [d.to(raw_spec.device) for d in draws], s.n_base, s.sampling_rate,
                ch_all.noise_amplitude[None, :, None], None, s.sampling_rate / 2,
                type=s.noise_type, sampler=s.noise_sampler)

        def rows_of(response, K):
            k = (raw_spec * response[None, :, :]).reshape(G * C_all, F_base)[:, :K]
            return k.real.contiguous(), k.imag.contiguous()

        readout = rows_of(ch_all.filter_response, K_base)
        # a separate trigger chain reads the same raw spectrum through its
        # own response (pipeline.py:1437-1447); max_amplitude stays the
        # readout chain's
        trig = rows_of(ch_all.trigger_filter_response, K_trig) if separate_chain else readout
        fired, frames, amp = _run_triggers(trig, readout if separate_chain else None,
                                           s, ch_all, G, C_all)
        traces = None
        if want_traces:
            traces = fft.freq2time(torch.complex(*readout).reshape(G, C_all, K_base),
                                   s.sampling_rate, n=s.n_base)
        return fired, [t0_w + f for f in frames], amp, traces

    # ---- 7b. sub-event windows (pipeline.py:1462-1489) ----------------------
    remaining = valid
    per_window = []
    name_to_col = {t.name: i for i, t in enumerate(s.triggers)}
    for w in range(max(1, s.n_windows)):
        with timing.span("step.placement"):
            any_rem = mesh_util.all_reduce_or(torch.any(remaining.reshape(G, -1), dim=-1),
                                              ch_axis)
            # anchored at the earliest arrival that is still to be read out
            t0_w = mesh_util.all_reduce_min(
                torch.amin(torch.where(remaining, t_start, 1e30).reshape(G, -1), dim=-1),
                ch_axis)
            t0_w = torch.where(any_rem, t0_w, 0.0)
            offset = t_start - t0_w[:, None, None, None]
            in_w = remaining & (offset <= cap)
            raw_spec = place_window(in_w, offset)
        with timing.span("step.trigger"):
            # only window 0's traces are kept
            fired, times, amp_w, traces_w = trigger_window(raw_spec, t0_w,
                                                           keep_traces and w == 0)
            # a window without pulses never triggers; requires-gating ANDs a
            # trigger with an earlier-declared one inside each window
            # (pipeline.py:1491-1512)
            gated = []
            for i, t in enumerate(s.triggers):
                c = fired[i] & any_valid & candidate & any_rem
                if t.requires:
                    c = c & gated[name_to_col[t.requires]]
                gated.append(c)
            per_window.append((gated, times))
            if w == 0:
                base_t0, max_amp_tr, traces0 = t0_w, amp_w, traces_w
            else:
                max_amp_tr = torch.maximum(max_amp_tr, amp_w)
        remaining = remaining & ~in_w

    with timing.span("step.trigger"):
        # decisions OR across windows, the time is the earliest fired window's
        cols, times = [], []
        for i in range(len(s.triggers)):
            fired = per_window[0][0][i]
            tmin = torch.where(fired, per_window[0][1][i], torch.inf)
            for gated_w, times_w in per_window[1:]:
                fired = fired | gated_w[i]
                tmin = torch.minimum(tmin, torch.where(gated_w[i], times_w[i], torch.inf))
            cols.append(fired)
            times.append(torch.where(fired, tmin, per_window[0][1][i]))
        triggered_per = torch.stack(cols, dim=-1)
        trigger_times_per = torch.stack(times, dim=-1)
        triggered = torch.any(triggered_per, dim=-1)
        tt_masked = torch.where(triggered_per, trigger_times_per, torch.inf)
        trigger_time = torch.where(triggered, torch.amin(tt_masked, dim=-1),
                                   trigger_times_per[..., 0])

    def gathered(x, dim=2):
        # a per-solution output [G, S, C, R, ...] over all channels
        return None if x is None else mesh_util.all_gather(x, dim, ch_axis)

    return PipelineOutput(
        triggered=triggered,
        candidate=candidate & any_valid,
        triggered_per=triggered_per,
        trigger_times_per=trigger_times_per,
        max_efield=mesh_util.all_reduce_max(torch.amax(ef_max.reshape(G, -1), dim=-1), ch_axis),
        trigger_time=trigger_time,
        max_amplitude=max_amp_tr,
        traces=traces0,
        base_t0=base_t0,
        sol_mask=gathered(valid),
        c0=gathered(sols.c0), c1=gathered(sols.c1), sol_type=gathered(sols.sol_type),
        travel_time=gathered(sols.travel_time), path_length=gathered(sols.path_length),
        launch_vector=gathered(launch), receive_vector=gathered(receive),
        polarization=gathered(pol_onsky), viewing_angle=gathered(viewing_angle),
        max_amp_per_solution=gathered(max_amp_sol),
        focusing=gathered(foc),
        reflection=gathered(sols.reflection), refl_case=gathered(sols.refl_case),
        efields=gathered(torch.stack([e_theta, e_phi]), 3) if keep_efields else None,
    )
