"""Fused phased-array trigger chain (kernel 3).

Replaces ``nuradiomc_tpu/ops/pa_pallas.py::fused_pa_trigger``
(pa_pallas.py:130, kernel ``_kernel`` :61, ``_sliding_sum_fwd`` :45). The
CUDA kernel is ``csrc/pa_trigger.cu``; its source note says what bounds it on
the H100 and how the design answers that. :func:`fused_pa_trigger` launches
it for CUDA tensors and runs :func:`fused_pa_trigger_plain` for CPU tensors;
there is no other fallback.

Contract (rows (group, channel), channel fastest, R = G * C):

    spec_re, spec_im  [R, K]        filtered (noise-added) rFFT spectra
    I_r, I_i          [K, n_base]   full irfft (fft_plan._irfft_matrices)
    Dd_r, Dd_i        [K, n_dec]    decimating irfft to the ADC rate
                                    (pipeline._decimating_irfft_matrices)
    U                 [n_dec, n_up] FFT upsampling (pipeline._fft_upsample_matrix)
    rolls             static (B, C) integer beam delays (phased_array.beam_rolls)
    returns (fired [G] bool, first frame [G] int32 (0 when quiet), amp [G, C])

with ``amp = max|scale_full * full irfft|``, the ADC
``floor((scale_dec * dec - v_min) / lsb)`` clipped to [0, n_counts - 1] plus
``floor(v_min / lsb)``, times ``lsb``, and the trigger
``phased_array.phased_power_trigger`` on the upsampled trace:
``sum / window > threshold`` on the frames ``f * step``,
``f < (n_up - window) // step``.

The plain version is that chain in matmul form (pipeline.py:575-632,
trigger_irfft="matmul"). Its power sum is a cumsum difference and the
kernel's a direct sum over the window, so decisions can differ where the
best beam power lies within ~1e-7 (float32) of the threshold.
On the card the plain version runs in full FP32:
``torch.backends.cuda.matmul.allow_tf32`` must stay False (PyTorch's
default), which ``chip_smoke.py`` sets.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from nuradiomc_tpu_torch.ops import _build, adc, phased_array

# kernel launches since the count was last set to 0
launches = 0

_SMEM_LIMIT = 232448          # bytes of shared memory one block may use


def fused_pa_trigger_plain(spec_re, spec_im, I_r, I_i, Dd_r, Dd_i, U, *,
                           scale_full: float, scale_dec: float, rolls,
                           threshold: float, window: int, step: int,
                           v_min: float, lsb: float, n_counts: int, C: int):
    """Plain PyTorch version (same contract); returns also the maximum
    windowed beam power per group [G], as ``phased_power_trigger`` does."""
    R = spec_re.shape[0]
    G = R // C
    full = (spec_re @ I_r + spec_im @ I_i) * scale_full
    amp = torch.amax(torch.abs(full), dim=-1).reshape(G, C)
    dec = (spec_re @ Dd_r + spec_im @ Dd_i) * scale_dec
    q = adc.quantize_counts(dec, v_min, lsb, n_counts) * lsb
    up = (q @ U).reshape(G, C, -1)
    fired, frame, max_power, _ = phased_array.phased_power_trigger(
        up, rolls, threshold, window, step)
    return fired, frame.to(torch.int32), amp, max_power


def _kernel_fn(dtype):
    lib = _build.load("pa_trigger")
    if dtype == torch.float32:
        fn, rbmax = lib.pa_trigger_f32, lib.pa_trigger_rows_per_pass_f32()
        scalar = ctypes.c_float
    else:
        fn, rbmax = lib.pa_trigger_f64, lib.pa_trigger_rows_per_pass_f64()
        scalar = ctypes.c_double
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [scalar] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, rbmax, lib.pa_trigger_spec_tile()


def _smem_bytes(gpb, C, n_dec, n_up, B, elem, rbmax, spec_tile):
    """Shared memory of one block (the layout in csrc/pa_trigger.cu)."""
    return (gpb * C * (n_dec + n_up) * elem + spec_tile * rbmax * 2 * elem
            + 8 * rbmax * elem + B * C * 4 + gpb * 4)


def _groups_per_block(C, n_dec, n_up, B, elem, rbmax, spec_tile):
    """Groups per block whose decimated and upsampled traces fit shared
    memory; raises when one group's do not."""
    gpb = max(1, rbmax // C)
    while gpb > 1 and _smem_bytes(gpb, C, n_dec, n_up, B, elem, rbmax,
                                  spec_tile) > _SMEM_LIMIT:
        gpb -= 1
    if _smem_bytes(gpb, C, n_dec, n_up, B, elem, rbmax, spec_tile) > _SMEM_LIMIT:
        raise ValueError(
            f"phased-array trigger: C * (n_dec + n_up) * sizeof = {C} * "
            f"({n_dec} + {n_up}) * {elem} bytes of traces do not fit the "
            f"{_SMEM_LIMIT} bytes of shared memory of one block")
    return gpb


def fused_pa_trigger(spec_re, spec_im, I_r, I_i, Dd_r, Dd_i, U, *,
                     scale_full: float, scale_dec: float, rolls,
                     threshold: float, window: int, step: int,
                     v_min: float, lsb: float, n_counts: int, C: int):
    """Fused phased-array trigger: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (see the module docstring)."""
    global launches
    kw = dict(scale_full=scale_full, scale_dec=scale_dec, rolls=rolls,
              threshold=threshold, window=window, step=step, v_min=v_min,
              lsb=lsb, n_counts=n_counts, C=C)
    if spec_re.device.type == "cpu":
        return fused_pa_trigger_plain(spec_re, spec_im, I_r, I_i, Dd_r, Dd_i, U,
                                      **kw)[:3]
    if spec_re.device.type != "cuda":
        raise ValueError(f"phased-array trigger: unsupported device {spec_re.device}")
    dtype = spec_re.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"phased-array trigger: dtype {dtype} is not float32/float64")
    R, K = spec_re.shape
    n_base = I_r.shape[1]
    n_dec, n_up = U.shape
    if C < 1 or R % C:
        raise ValueError(f"phased-array trigger: R={R} is not a multiple of C={C}")
    expect = {"spec_re": (spec_re, (R, K)), "spec_im": (spec_im, (R, K)),
              "I_r": (I_r, (K, n_base)), "I_i": (I_i, (K, n_base)),
              "Dd_r": (Dd_r, (K, n_dec)), "Dd_i": (Dd_i, (K, n_dec)),
              "U": (U, (n_dec, n_up))}
    for name, (t, shape) in expect.items():
        if t.device != spec_re.device:
            raise ValueError(f"phased-array trigger: {name} on {t.device}, "
                             f"spec on {spec_re.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"phased-array trigger: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"phased-array trigger: {name} is not contiguous")
    rolls = np.asarray(rolls, dtype=np.int64)
    if rolls.ndim != 2 or rolls.shape[1] != C:
        raise ValueError(f"phased-array trigger: rolls {rolls.shape}, expected (B, {C})")
    if window < 1 or step < 1 or n_up < window:
        raise ValueError(f"phased-array trigger: window={window}, step={step}, n_up={n_up}")
    B = rolls.shape[0]
    fn, rbmax, spec_tile = _kernel_fn(dtype)
    gpb = _groups_per_block(C, n_dec, n_up, B, spec_re.element_size(), rbmax,
                            spec_tile)
    G = R // C
    dev = spec_re.device
    # rolls as torch.roll shifts in [0, n_up)
    rolls_t = torch.as_tensor(rolls % n_up, dtype=torch.int32, device=dev)
    fired = torch.empty((G,), dtype=torch.uint8, device=dev)
    frame = torch.empty((G,), dtype=torch.int32, device=dev)
    amp = torch.empty((R,), dtype=dtype, device=dev)
    ptrs = [t.data_ptr() for t in (spec_re, spec_im, I_r, I_i, Dd_r, Dd_i, U,
                                   rolls_t, fired, frame, amp)]
    scalar = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
    err = fn(*ptrs, G, C, K, n_base, n_dec, n_up, B, window, step, gpb, n_counts,
             scalar(scale_full), scalar(scale_dec), scalar(threshold),
             scalar(v_min), scalar(lsb), scalar(math.floor(v_min / lsb)),
             _build.current_stream_ptr(dev))
    _build.check(err, "phased-array trigger kernel")
    launches += 1
    return fired.bool(), frame, amp.reshape(G, C)
