# frozen copy of the plain versions of the port's three kernels (commit 493e4d9):
#   nuradiomc_tpu_torch/ops/placement.py:68-102 (chain_placement_reduce_plain,
#     placement_reduce_plain),
#   nuradiomc_tpu_torch/ops/trigger_fused.py:56-95 (TriggerSpecStatic,
#     fused_irfft_trigger_plain),
#   nuradiomc_tpu_torch/ops/pa_trigger.py:59-91 (n_dec_of, adc_plain,
#     fused_pa_trigger_plain).
"""Dense-matrix versions of the placement chain (kernel 1), the fused
irfft trigger (kernel 2) and the phased-array chain (kernel 3), the way the
reference computes those stages. Contracts as in the port's modules. On the
card the matrix products run in full precision:
``torch.backends.cuda.matmul.allow_tf32`` stays False."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from portbench.reference import adc, fft_plan, phased_array
from portbench.reference.trace import time_shift_phase_uniform
from portbench.reference.triggers import _sliding_window_any


def chain_placement_reduce_plain(spec_re, spec_im, att_sparse, comb_re,
                                 comb_im, mask, tpl_idx, offsets, W,
                                 templates, *, s2: int, df: float, n_int: int,
                                 n_base: int, K_place: int):
    att = att_sparse @ W                                        # [R, K_int]
    sa_re = spec_re * att
    sa_im = spec_im * att
    cr = comb_re[:, None]
    ci = comb_im[:, None]
    cs_re = cr * sa_re - ci * sa_im
    cs_im = cr * sa_im + ci * sa_re
    tpl = templates[tpl_idx.long()]
    tr, ti = tpl.real, tpl.imag
    m = mask[:, None]
    v_re = torch.where(m, tr * cs_re - ti * cs_im, 0.0)
    v_im = torch.where(m, tr * cs_im + ti * cs_re, 0.0)
    return placement_reduce_plain(v_re, v_im, offsets, s2=s2, df=df, n_int=n_int,
                                  n_base=n_base, K_place=K_place)


def placement_reduce_plain(volt_re, volt_im, offsets, *, s2: int, df: float, n_int: int,
                           n_base: int, K_place: int):
    D_r, D_i = fft_plan.placement_dense(n_int, n_base, volt_re.shape[1], K_place,
                                        volt_re.dtype, volt_re.device)
    xb = torch.complex(volt_re @ D_r.real + volt_im @ D_i.real,
                       volt_re @ D_r.imag + volt_im @ D_i.imag)   # [R, K_place]
    xb = xb * time_shift_phase_uniform(D_r.shape[1], df, offsets)
    R = volt_re.shape[0]
    out = xb.reshape(R // s2, s2, -1).sum(dim=1)
    return out.real, out.imag


@dataclasses.dataclass(frozen=True)
class TriggerSpecStatic:
    kind: str            # 'high_low' | 'simple_threshold'
    n_bins_hl: int       # within-channel coincidence window (bins)
    n_bins_maj: int      # cross-channel coincidence window (bins)
    n_coinc: int         # number of channels required


def fused_irfft_trigger_plain(spec_re, spec_im, th_hi, th_lo, *, n_base: int,
                              scale: float,
                              triggers: Tuple[TriggerSpecStatic, ...], C: int):
    R, K = spec_re.shape
    G = R // C
    I_r, I_i = fft_plan.irfft_dense(n_base, K, spec_re.dtype, spec_re.device)
    v = (spec_re @ I_r + spec_im @ I_i) * scale                 # [R, n_base]
    amp = torch.amax(torch.abs(v), dim=-1).reshape(G, C)
    v = v.reshape(G, C, n_base)
    fired, first = [], []
    for t, spec in enumerate(triggers):
        hi = th_hi[:, t].reshape(G, C, 1)
        if spec.kind == "high_low":
            lo = th_lo[:, t].reshape(G, C, 1)
            tts = (_sliding_window_any(v >= hi, spec.n_bins_hl)
                   & _sliding_window_any(v <= lo, spec.n_bins_hl))
        elif spec.kind == "simple_threshold":
            tts = torch.abs(v) >= hi
        else:
            raise NotImplementedError(f"trigger kind {spec.kind}")
        wid = _sliding_window_any(tts, min(spec.n_bins_maj, n_base))
        ttt = torch.sum(wid.to(torch.int32), dim=1) >= spec.n_coinc
        f = torch.any(ttt, dim=-1)
        fired.append(f)
        first.append(torch.where(
            f, torch.argmax(ttt.to(torch.int8), dim=-1), 0).to(torch.int32))
    if not triggers:
        return (torch.zeros((G, 0), dtype=torch.bool, device=v.device),
                torch.zeros((G, 0), dtype=torch.int32, device=v.device), amp)
    return torch.stack(fired, dim=-1), torch.stack(first, dim=-1), amp


def n_dec_of(n_hi: int, decim: int) -> int:
    return -(-n_hi // decim)


def adc_plain(spec_re, spec_im, *, n_base: int, n_hi: int, decim: int, scale_dec: float,
              v_min: float, lsb: float, n_counts: int):
    Dd_r, Dd_i = fft_plan.decimate_dense(n_base, n_hi, decim, spec_re.shape[1],
                                         spec_re.dtype, spec_re.device)
    dec = (spec_re @ Dd_r + spec_im @ Dd_i) * scale_dec
    q = adc.quantize_counts(dec, v_min, lsb, n_counts)
    return q - math.floor(v_min / lsb), q * lsb


def fused_pa_trigger_plain(spec_re, spec_im, *, n_base: int, n_hi: int, decim: int,
                           up: int, scale_full: float, scale_dec: float, rolls,
                           threshold: float, window: int, step: int, v_min: float,
                           lsb: float, n_counts: int, C: int):
    R, K = spec_re.shape
    G = R // C
    I_r, I_i = fft_plan.irfft_dense(n_base, K, spec_re.dtype, spec_re.device)
    full = (spec_re @ I_r + spec_im @ I_i) * scale_full
    amp = torch.amax(torch.abs(full), dim=-1).reshape(G, C)
    _, q = adc_plain(spec_re, spec_im, n_base=n_base, n_hi=n_hi, decim=decim,
                     scale_dec=scale_dec, v_min=v_min, lsb=lsb, n_counts=n_counts)
    U = fft_plan.upsample_dense(q.shape[1], up, spec_re.dtype, spec_re.device)
    fired, frame, max_power, _ = phased_array.phased_power_trigger(
        (q @ U).reshape(G, C, -1), rolls, threshold, window, step)
    return fired, frame.to(torch.int32), amp
