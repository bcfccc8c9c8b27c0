"""Fused phased-array trigger chain (kernel 3).

Replaces ``nuradiomc_tpu/ops/pa_pallas.py::fused_pa_trigger``
(pa_pallas.py:130, kernel ``_kernel`` :61, ``_sliding_sum_fwd`` :45,
pallas_call :181). The CUDA kernel is ``csrc/pa_trigger.cu``, a chain of
shared-memory FFTs (``csrc/fft_common.cuh``); its source note says what
bounds it on the H100 and how the design answers that. A group whose C
upsampled traces do not fit one block's shared memory is split over a
thread-block cluster of up to 8 blocks (:func:`cluster_size`); beyond that
the wrapper raises (at n_up 1024, 11 beams and K 512: C > 368 in float32,
C > 168 in float64). :func:`fused_pa_trigger` launches it for CUDA tensors
and runs :func:`fused_pa_trigger_plain` for CPU tensors; there is no other
fallback.

Contract (rows (group, channel), channel fastest, R = G * C):

    spec_re, spec_im  [R, K]   filtered (noise-added) rFFT spectra, K <= n_base/2 + 1
    n_base            the full-rate trace: irfft(X, n_base)
    n_hi, decim       the ADC-rate trace: irfft(X, n_hi)[::decim], n_dec =
                      ceil(n_hi / decim) samples
    up                the upsampling: up * irfft(rfft(q), n_dec * up)
    rolls             static (B, C) integer beam delays (phased_array.beam_rolls)
    returns (fired [G] bool, first frame [G] int32 (0 when quiet), amp [G, C])

with ``amp = max|scale_full * full trace|``, the ADC
``floor((scale_dec * dec - v_min) / lsb)`` clipped to [0, n_counts - 1] plus
``floor(v_min / lsb)``, times ``lsb``, and the trigger
``phased_array.phased_power_trigger`` on the upsampled trace:
``sum / window > threshold`` on the frames ``f * step``,
``f < (n_up - window) // step``.

The plain version is that chain in matmul form (pipeline.py:575-632,
trigger_irfft="matmul"), with the dense matrices of ``fft_plan``
(``irfft_dense``, ``decimate_dense``, ``upsample_dense``). An FFT and a
dense product round differently, so an ADC sample within rounding of a count
boundary may get another count, and the power sum is a cumsum difference in
the plain version and a direct sum in the kernel: decisions can differ
where the best beam power lies near the threshold. On the card the plain
version runs in full FP32: ``torch.backends.cuda.matmul.allow_tf32`` must
stay False (PyTorch's default), which ``chip_smoke.py`` sets.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from nuradiomc_tpu_torch.ops import _build, adc, fft_plan, phased_array

# kernel launches since the count was last set to 0
launches = 0

MAX_CLUSTER = 8               # blocks a group's cluster may have (the portable size)


def n_dec_of(n_hi: int, decim: int) -> int:
    """Samples of the decimated trace irfft(X, n_hi)[::decim]."""
    return -(-n_hi // decim)


def adc_plain(spec_re, spec_im, *, n_base: int, n_hi: int, decim: int, scale_dec: float,
              v_min: float, lsb: float, n_counts: int):
    """The plain version's ADC: (counts before the offset [R, n_dec], the
    quantized trace in volts)."""
    Dd_r, Dd_i = fft_plan.decimate_dense(n_base, n_hi, decim, spec_re.shape[1],
                                         spec_re.dtype, spec_re.device)
    dec = (spec_re @ Dd_r + spec_im @ Dd_i) * scale_dec
    q = adc.quantize_counts(dec, v_min, lsb, n_counts)
    return q - math.floor(v_min / lsb), q * lsb


def fused_pa_trigger_plain(spec_re, spec_im, *, n_base: int, n_hi: int, decim: int,
                           up: int, scale_full: float, scale_dec: float, rolls,
                           threshold: float, window: int, step: int, v_min: float,
                           lsb: float, n_counts: int, C: int):
    """Plain PyTorch version (same contract); returns also the maximum
    windowed beam power per group [G], as ``phased_power_trigger`` does."""
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
    return fired, frame.to(torch.int32), amp, max_power


def _kernel_fn(dtype):
    lib = _build.load("pa_trigger")
    if dtype == torch.float32:
        fn, scalar = lib.pa_trigger_f32, ctypes.c_float
    else:
        fn, scalar = lib.pa_trigger_f64, ctypes.c_double
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [ip, ctypes.c_int] * 4
                   + [scalar] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.pa_trigger_smem_bytes.argtypes = [ctypes.c_int] * 8
    lib.pa_trigger_smem_bytes.restype = ctypes.c_long
    lib.pa_trigger_cluster.argtypes = [ctypes.c_int] * 8
    lib.pa_trigger_cluster.restype = ctypes.c_int
    return fn, scalar, lib


def cluster_size(C: int, K: int, n_base: int, n_hi: int, decim: int, up: int, B: int,
                 dtype) -> int:
    """Blocks of the thread-block cluster that holds one group on the card
    (1 when its C upsampled traces fit one block's shared memory), or 0 when
    even eight blocks cannot hold them."""
    lib = _kernel_fn(dtype)[2]
    return lib.pa_trigger_cluster(C, K, n_base, n_hi, decim, up, B,
                                  int(dtype == torch.float64))


def fused_pa_trigger(spec_re, spec_im, *, n_base: int, n_hi: int, decim: int, up: int,
                     scale_full: float, scale_dec: float, rolls, threshold: float,
                     window: int, step: int, v_min: float, lsb: float, n_counts: int,
                     C: int, adc_counts=None):
    """Fused phased-array trigger: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (see the module docstring). ``adc_counts``
    (CUDA only, a diagnostic): an int32 tensor [R, n_dec] that receives the
    kernel's ADC counts before the offset."""
    global launches
    kw = dict(n_base=n_base, n_hi=n_hi, decim=decim, up=up, scale_full=scale_full,
              scale_dec=scale_dec, rolls=rolls, threshold=threshold, window=window,
              step=step, v_min=v_min, lsb=lsb, n_counts=n_counts, C=C)
    if spec_re.device.type == "cpu":
        return fused_pa_trigger_plain(spec_re, spec_im, **kw)[:3]
    if spec_re.device.type != "cuda":
        raise ValueError(f"phased-array trigger: unsupported device {spec_re.device}")
    dtype = spec_re.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"phased-array trigger: dtype {dtype} is not float32/float64")
    R, K = spec_re.shape
    if C < 1 or R % C:
        raise ValueError(f"phased-array trigger: R={R} is not a multiple of C={C}")
    if not (n_base >= 2 and 1 <= K <= n_base // 2 + 1 and n_hi >= 2 and decim >= 1
            and up >= 1):
        raise ValueError(f"phased-array trigger: K={K}, n_base={n_base}, n_hi={n_hi}, "
                         f"decim={decim}, up={up} need 1 <= K <= n_base/2 + 1, n_hi >= 2, "
                         "decim >= 1 and up >= 1")
    n_dec = n_dec_of(n_hi, decim)
    n_up = n_dec * up
    if n_dec < 2:
        raise ValueError(f"phased-array trigger: n_hi={n_hi}, decim={decim} leave "
                         f"{n_dec} decimated samples")
    for name, t in (("spec_re", spec_re), ("spec_im", spec_im)):
        if t.device != spec_re.device or tuple(t.shape) != (R, K) or t.dtype != dtype:
            raise ValueError(f"phased-array trigger: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, expected {(R, K)} {dtype} on {spec_re.device}")
        if not t.is_contiguous():
            raise ValueError(f"phased-array trigger: {name} is not contiguous")
    rolls = np.asarray(rolls, dtype=np.int64)
    if rolls.ndim != 2 or rolls.shape[1] != C or rolls.shape[0] < 1:
        raise ValueError(f"phased-array trigger: rolls {rolls.shape}, expected (B, {C})")
    if window < 1 or step < 1 or n_up < window:
        raise ValueError(f"phased-array trigger: window={window}, step={step}, n_up={n_up}")
    B = rolls.shape[0]
    G = R // C
    dev = spec_re.device
    if adc_counts is not None and (adc_counts.device != dev or adc_counts.dtype != torch.int32
                                   or tuple(adc_counts.shape) != (R, n_dec)
                                   or not adc_counts.is_contiguous()):
        raise ValueError(f"phased-array trigger: adc_counts must be a contiguous int32 "
                         f"[{R}, {n_dec}] tensor on {dev}")
    fn, scalar, lib = _kernel_fn(dtype)
    elem = spec_re.element_size()
    if lib.pa_trigger_cluster(C, K, n_base, n_hi, decim, up, B, int(elem == 8)) < 1:
        smem = lib.pa_trigger_smem_bytes(C, K, n_base, n_hi, decim, up, B, int(elem == 8))
        raise ValueError(
            f"phased-array trigger: the upsampled traces C * n_up * sizeof = {C} * {n_up} * "
            f"{elem} bytes do not fit a cluster of {MAX_CLUSTER} blocks ({smem} bytes of "
            f"shared memory a block, beyond the card's limit)")
    fold = n_hi % decim == 0
    lengths = (n_base, n_hi, n_dec, n_up)
    stages = [fft_plan.plan(n)[1] for n in lengths]
    # the n_hi transform runs only where decim does not divide n_hi
    tables = [None if i == 1 and fold else fft_plan.twiddles(n, dtype, dev)
              for i, n in enumerate(lengths)]
    # rolls as torch.roll shifts in [0, n_up)
    rolls_t = torch.as_tensor(rolls % n_up, dtype=torch.int32, device=dev)
    fired = torch.empty((G,), dtype=torch.uint8, device=dev)
    frame = torch.empty((G,), dtype=torch.int32, device=dev)
    amp = torch.empty((R,), dtype=dtype, device=dev)

    def ints(vals):
        return (ctypes.c_int * max(len(vals), 1))(*vals)

    ptrs = [t.data_ptr() if t is not None else None
            for t in (spec_re, spec_im, rolls_t, *tables, fired, frame, amp, adc_counts)]
    plans = [a for st in stages for a in (ints(st), len(st))]
    err = fn(*ptrs, G, C, K, n_base, n_hi, decim, up, B, window, step, n_counts, *plans,
             scalar(scale_full / n_base), scalar(1.0 / n_hi), scalar(1.0 / n_dec),
             scalar(scale_dec), scalar(threshold), scalar(v_min), scalar(lsb),
             scalar(math.floor(v_min / lsb)), _build.current_stream_ptr(dev))
    _build.check(err, "phased-array trigger kernel")
    launches += 1
    return fired.bool(), frame, amp.reshape(G, C)
