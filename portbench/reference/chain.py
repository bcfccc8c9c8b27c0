# frozen copy of nuradiomc_tpu_torch/sim/pipeline.py:78-143, :165-302, :373-824
# (commit 493e4d9), cut to the paths the benchmark's configurations take: the
# factored chain with analytic antennas, one readout window, no bottom
# reflections, no birefringence, no emitter, no channel split, and the plain
# (dense-matrix) versions of the three kernels.
"""The reference chain over one padded chunk [group G x shower S x channel C
x ray 2]: ray tracing, viewing angle and delta_C cut, Askaryan spectra,
polarization, SP1 attenuation, Fresnel and focusing factors, the candidate
cut, the antenna response, placement on the common time base, noise, the
filter chain and the named triggers (high/low on the dense irfft; the phased
array through its trigger ADC). Returns per group the decisions per trigger,
their times, the readout chain's maximum |trace| per channel."""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from portbench.reference import (antenna, askaryan, fft, geometry, kernels_plain,
                                 noise as noise_ops, raytrace)
from portbench.reference.ice import IceModelSimple


@dataclasses.dataclass(frozen=True)
class TriggerSettings:
    name: str
    trigger_type: str
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
    pa_adc_fs: float = 0.5
    pa_adc_nbits: int = 8
    pa_adc_range: float = 0.0


@dataclasses.dataclass(frozen=True)
class Settings:
    ice: IceModelSimple
    triggers: tuple
    askaryan_model: str
    n_internal: int
    n_base: int
    sampling_rate: float
    delta_C_cut: float
    n_freq_attenuation: int
    max_detector_freq: float
    apply_focusing: bool
    focusing_limit: float
    add_noise: bool
    attenuation_model: str = "SP1"
    attenuation_steps: int = 16
    attenuation_quadrature: str = "gauss"
    n_bisect: int = 96

    @property
    def dt(self) -> float:
        return 1.0 / self.sampling_rate


@functools.lru_cache(maxsize=8)
def _interp_matrix(x_sparse: tuple, x_dense: tuple):
    """W[s, d] with (v_sparse @ W) == np.interp(x_dense, x_sparse, v_sparse)."""
    xs = np.asarray(x_sparse)
    xd = np.asarray(x_dense)
    W = np.zeros((len(xs), len(xd)))
    idx = np.clip(np.searchsorted(xs, xd) - 1, 0, len(xs) - 2)
    x0, x1 = xs[idx], xs[idx + 1]
    t = np.clip((xd - x0) / (x1 - x0), 0.0, 1.0)
    W[idx, np.arange(len(xd))] = 1.0 - t
    W[idx + 1, np.arange(len(xd))] = t
    return W


def _attenuation_freq_grid(ff, n_freq, max_detector_freq=None):
    """n_freq points over the positive detector band plus n_freq//2 over the
    rest of the internal band (analyticraytracing.py:885-931)."""
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
                freqs = np.append(freqs, np.linspace(above.min(), above.max(), n // 2))
            return freqs
    return np.linspace(pos.min(), pos.max(), n)


def _run_triggers(trig_list, spec_re, spec_im, s: Settings, G: int, C: int):
    """Every trigger on the window's filtered spectra [G*C, K]: (fired [G]
    per trigger, time after the window start [G] per trigger, amp [G, C])."""
    real_dtype, dev = spec_re.dtype, spec_re.device
    dt = s.dt
    scale = s.sampling_rate / math.sqrt(2.0)
    hl = [i for i, t in enumerate(trig_list) if t.trigger_type != "phased_array"]
    pa = [i for i, t in enumerate(trig_list) if t.trigger_type == "phased_array"]
    fired_cols, time_cols = {}, {}
    amp = None
    if hl:
        th_hi_cols, th_lo_cols, kspecs = [], [], []
        for t in (trig_list[i] for i in hl):
            hi = torch.full((C,), t.threshold_high, dtype=real_dtype, device=dev)
            if t.trigger_type == "high_low":
                lo = torch.full((C,), t.threshold_low, dtype=real_dtype, device=dev)
                nb_hl = max(int(round(t.highlow_coincidence / dt)), 1)
            else:
                lo = torch.zeros((C,), dtype=real_dtype, device=dev)
                nb_hl = 1
            th_hi_cols.append(hi.repeat(G))
            th_lo_cols.append(lo.repeat(G))
            kspecs.append(kernels_plain.TriggerSpecStatic(
                kind=t.trigger_type, n_bins_hl=nb_hl,
                n_bins_maj=min(max(int(round(t.channel_coincidence / dt)), 1), s.n_base),
                n_coinc=t.number_of_coincidences))
        fired, first, amp = kernels_plain.fused_irfft_trigger_plain(
            spec_re, spec_im, torch.stack(th_hi_cols, dim=-1),
            torch.stack(th_lo_cols, dim=-1), n_base=s.n_base, scale=scale,
            triggers=tuple(kspecs), C=C)
        for j, i in enumerate(hl):
            fired_cols[i] = fired[:, j]
            time_cols[i] = first[:, j].to(real_dtype) * dt
    for i in pa:
        t = trig_list[i]
        fs_hi = 5.0
        n_hi = int(round(s.n_base * fs_hi / s.sampling_rate))
        up = int(t.pa_upsampling)
        fired, frame, amp_i = kernels_plain.fused_pa_trigger_plain(
            spec_re, spec_im, n_base=s.n_base, n_hi=n_hi,
            decim=int(round(fs_hi / t.pa_adc_fs)), up=up, scale_full=scale,
            scale_dec=fs_hi / math.sqrt(2.0), rolls=t.pa_rolls,
            threshold=t.pa_threshold, window=t.pa_window, step=t.pa_step,
            v_min=-t.pa_adc_range / 2, lsb=t.pa_adc_range / (2 ** t.pa_adc_nbits - 1),
            n_counts=2 ** t.pa_adc_nbits, C=C)
        fired_cols[i] = fired
        time_cols[i] = frame.to(real_dtype) * (t.pa_step / (t.pa_adc_fs * up))
        if not hl:
            amp = amp_i if amp is None else torch.maximum(amp, amp_i)
    order = range(len(trig_list))
    return [fired_cols[i] for i in order], [time_cols[i] for i in order], amp


def simulate_chunk(batch: dict, ch: dict, s: Settings, noise_generator=None):
    """The chain on one padded chunk. ``batch``: vertices [G, S, 3], energies,
    is_em, shower_mask, prop_dir [G, S, 3], k_L, vertex_times [G, S];
    ``ch``: positions [C, 3], cable_delays, rot [C, 3, 3], kind, templates
    [C, 3, F_int], filter_response [C, F_base], noise_amplitude,
    min_efield_amplitude [C]. Returns (triggered_per [G, T],
    trigger_times_per [G, T], max_amplitude [G, C])."""
    trig_list = s.triggers
    G, S = batch["energies"].shape
    C = ch["positions"].shape[0]
    dt = s.dt
    real_dtype = batch["vertices"].dtype
    dev = batch["vertices"].device
    ctype = torch.complex64 if real_dtype == torch.float32 else torch.complex128
    ff_int_np = np.fft.rfftfreq(s.n_internal, dt)
    ff_int = torch.as_tensor(ff_int_np, dtype=real_dtype, device=dev)

    # 1. ray tracing
    x1 = batch["vertices"][:, :, None, :].expand(G, S, C, 3)
    x2 = ch["positions"][None, None, :, :].expand(G, S, C, 3)
    geom = raytrace.to_2d(x1, x2)
    sols = raytrace.find_solutions_all(geom.x1y, geom.x1z, geom.x2y, geom.x2z, s.ice,
                                       n_reflections=0, n_bisect=s.n_bisect)
    n_rays = sols.c0.shape[-1]
    bshape = (G, S, C, n_rays)
    launch, receive = raytrace.launch_receive_vectors(geom, sols)

    # 2. viewing angle and delta_C cut
    n_vertex = s.ice.index_of_refraction(batch["vertices"][..., 2])
    cherenkov = torch.arccos(1.0 / n_vertex)
    cos_view = torch.sum(batch["prop_dir"][:, :, None, None, :] * launch, dim=-1)
    viewing_angle = torch.arccos(torch.clamp(cos_view, -1.0, 1.0))
    delta_C = viewing_angle - cherenkov[:, :, None, None]
    R_safe = torch.where(sols.path_length > 1.0, sols.path_length, 1.0)

    def per_pair(x):
        return x[:, :, None, None].expand(bshape)

    valid = (sols.mask & (torch.abs(delta_C) <= s.delta_C_cut)
             & batch["shower_mask"][:, :, None, None])

    # 3. Askaryan spectra
    spec = askaryan.get_frequency_spectrum(
        per_pair(batch["energies"]), viewing_angle, s.n_internal, dt,
        per_pair(batch["is_em"]), per_pair(n_vertex), R_safe, s.askaryan_model,
        k_L=per_pair(batch["k_L"]))

    # 4. polarization on-sky at the vertex
    axis = batch["prop_dir"][:, :, None, None, :].expand(*bshape, 3)
    pol = torch.linalg.cross(launch, torch.linalg.cross(axis, launch, dim=-1), dim=-1)
    pol = pol / torch.clamp(torch.linalg.vector_norm(pol, dim=-1, keepdim=True), min=1e-30)
    zen_l, az_l = geometry.cartesian_to_spherical(launch)
    pol_onsky = geometry.ground_to_onsky(pol, zen_l, az_l)

    # 5. attenuation on the sparse grid
    sparse_np = _attenuation_freq_grid(tuple(ff_int_np), s.n_freq_attenuation,
                                       s.max_detector_freq)
    sparse = torch.as_tensor(sparse_np, dtype=real_dtype, device=dev)
    att_vals = raytrace.attenuation_factor(
        sols.c0, geom.x1y[..., None], geom.x1z[..., None],
        geom.x2y[..., None], geom.x2z[..., None], s.ice, sparse,
        s.attenuation_model, n_steps=s.attenuation_steps,
        quadrature=s.attenuation_quadrature)
    att_W = torch.as_tensor(_interp_matrix(tuple(sparse_np), tuple(ff_int_np)),
                            dtype=real_dtype, device=dev)
    att = torch.where(ff_int > 0, att_vals @ att_W, 1.0)
    spec_att = spec * att

    # surface-reflection Fresnel factors
    n_surf = s.ice.index_of_refraction(torch.tensor(-1e-5, dtype=real_dtype, device=dev))
    refl_zenith = torch.atan(1.0 / torch.sqrt(torch.clamp(
        sols.c0 ** 2 * n_surf ** 2 - 1.0, min=1e-12)))
    r_p = geometry.fresnel_r_p(refl_zenith, n_2=1.0, n_1=n_surf)
    r_s = geometry.fresnel_r_s(refl_zenith, n_2=1.0, n_1=n_surf)
    z_turn_slots = raytrace.turning_depth(sols.c0, s.ice)
    n_touch = raytrace.surface_touches_slots(sols.sol_type, sols.reflection,
                                             sols.refl_case, z_turn_slots)
    a_p = torch.where(n_touch > 0, r_p, torch.ones_like(r_p))
    a_s = torch.where(n_touch > 0, r_s, torch.ones_like(r_s))
    if s.apply_focusing:
        # the exact dz -> 0 derivative of the launch angle at the solved root
        lau_ang = torch.arccos(torch.clamp(launch[..., 2], -1.0, 1.0))
        rec_ang = torch.arccos(torch.clamp(-receive[..., 2], -1.0, 1.0))
        d_launch_dz = raytrace.focusing_dtheta_dz(geom, sols, s.ice)
        r_h = torch.abs(geom.x2y - geom.x1y)[..., None]
        dist = torch.clamp(sols.path_length, min=1.0)
        foc = torch.sqrt(dist / torch.clamp(torch.sin(rec_ang), min=1e-6) * d_launch_dz)
        foc = foc * torch.sqrt(dist * torch.sin(lau_ang) / torch.clamp(r_h, min=1e-6))
        foc = torch.clamp(torch.where(sols.mask, foc, 1.0), max=s.focusing_limit)
        n1 = s.ice.index_of_refraction(batch["vertices"][..., 2])[:, :, None, None]
        n2 = s.ice.index_of_refraction(ch["positions"][:, 2])[None, None, :, None]
        foc = foc * torch.sqrt(n1 / n2)
    else:
        foc = torch.ones(bshape, dtype=real_dtype, device=dev)
    amp_t_c = (pol_onsky[..., 1] * foc).to(ctype) * a_p
    amp_p_c = (pol_onsky[..., 2] * foc).to(ctype) * a_s

    # 6a. candidate cut on the efield's peak
    if bool(torch.all(ch["min_efield_amplitude"] <= 0)):
        candidate = torch.ones((G,), dtype=torch.bool, device=dev)
    else:
        pols = [amp_t_c[..., None] * spec_att, amp_p_c[..., None] * spec_att]
        ef_traces = fft.freq2time(torch.stack(pols), s.sampling_rate, n=s.n_internal)
        ef_max = torch.amax(torch.abs(ef_traces), dim=(0, -1))
        ef_max = torch.where(valid, ef_max, 0.0)
        candidate = torch.any((ef_max > ch["min_efield_amplitude"][None, None, :, None])
                              .reshape(G, -1), dim=-1)

    # 6b. antenna response: mixing scalars and the template of each sector
    zen_r, az_r = geometry.cartesian_to_spherical(receive)
    rot_b = ch["rot"][None, None, :, None, :, :].expand(*bshape, 3, 3)
    kind_b = ch["kind"][None, None, :, None].expand(bshape)
    mix_t, mix_p, sector = antenna.analytic_vel_mix(zen_r, az_r, rot_b, kind_b,
                                                    direction=receive)
    c_idx = torch.arange(C, device=dev)[None, None, :, None].expand(bshape)
    combined = mix_t.to(ctype) * amp_t_c + mix_p.to(ctype) * amp_p_c

    # 7. placement into the common time base, one readout window
    t_start = (batch["vertex_times"][:, :, None, None] + sols.travel_time
               - 0.5 * s.n_internal * dt + ch["cable_delays"][None, None, :, None])
    any_valid = torch.any(valid.reshape(G, -1), dim=-1)
    cap = (s.n_base - s.n_internal) * dt
    F_int = ff_int.shape[0]
    F_base = s.n_base // 2 + 1
    s2 = S * n_rays
    R = G * C * s2

    def ch_major(x):
        # [G, S, C, 2, ...] -> rows (g, c, s, r), (s, r) fastest
        return torch.movedim(x, 2, 1).reshape(R, *x.shape[4:]).contiguous()

    tpl_idx = (c_idx * 3 + sector).to(torch.int32)
    dcmask = torch.as_tensor(ff_int_np >= 5e-3, device=dev)
    tpl_table = torch.where(dcmask, ch["templates"].reshape(C * 3, -1), 0.0)
    t0 = torch.amin(torch.where(valid, t_start, 1e30).reshape(G, -1), dim=-1)
    t0 = torch.where(any_valid, t0, 0.0)
    offset = t_start - t0[:, None, None, None]
    in_w = valid & (offset <= cap)
    out_re, out_im = kernels_plain.chain_placement_reduce_plain(
        ch_major(spec.real)[:, :F_int].contiguous(), ch_major(spec.imag)[:, :F_int].contiguous(),
        ch_major(att_vals), ch_major(combined.real), ch_major(combined.imag),
        ch_major(in_w), ch_major(tpl_idx), ch_major(offset), att_W.contiguous(),
        tpl_table.contiguous(), s2=s2, df=float(s.sampling_rate / s.n_base),
        n_int=s.n_internal, n_base=s.n_base, K_place=F_base)
    raw_spec = torch.complex(out_re, out_im).reshape(G, C, F_base)

    # 8. noise, filter multiply, triggers
    if s.add_noise:
        draws = noise_ops.draw_noise(noise_generator, (G, C), s.n_base, real_dtype,
                                     "rayleigh", "phase")
        raw_spec = raw_spec + noise_ops.noise_spectrum_from_draws(
            [d.to(raw_spec.device) for d in draws], s.n_base, s.sampling_rate,
            ch["noise_amplitude"][None, :, None], None, s.sampling_rate / 2,
            type="rayleigh", sampler="phase")
    k = (raw_spec * ch["filter_response"][None, :, :]).reshape(G * C, F_base)
    fired, frames, amp = _run_triggers(trig_list, k.real.contiguous(), k.imag.contiguous(),
                                       s, G, C)
    # a window without pulses never triggers
    cols = [f & any_valid & candidate for f in fired]
    times = [t0 + f for f in frames]
    triggered_per = torch.stack(cols, dim=-1)
    trigger_times_per = torch.stack(times, dim=-1)
    return triggered_per, trigger_times_per, amp

