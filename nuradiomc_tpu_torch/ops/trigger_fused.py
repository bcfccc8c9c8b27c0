"""Fused trigger-trace irfft + trigger evaluation (kernel 2).

Replaces ``nuradiomc_tpu/ops/trigger_pallas.py::fused_irfft_trigger``
(trigger_pallas.py:123, kernel ``_kernel`` :68, ``_swa`` :49, pallas_call
:172). The CUDA kernel is ``csrc/irfft_trigger.cu``, which makes the traces
by an inverse real FFT in shared memory; its source note says what bounds it
on the H100 and how the design answers that. :func:`fused_irfft_trigger`
launches it for CUDA tensors and runs :func:`fused_irfft_trigger_plain` for
CPU tensors; there is no other fallback.

Contract:

    spec_re, spec_im  [R, K]   filtered rFFT spectra, rows (group, channel),
                               channel fastest, R = G * C, K <= n_base/2 + 1
                               (the bins from K on are zero)
    th_hi, th_lo      [R, T]   absolute thresholds per row and trigger
                               (th_lo unused by simple_threshold)
    n_base            trace length: trace = scale * numpy's irfft(X, n_base)
    scale             trace scale, sampling_rate / sqrt(2)
    triggers          T static trigger specs
    returns (fired [G, T] bool, first_bin [G, T] int32, amp [G, C])

The plain version is the JAX pipeline's irfft matmul (pipeline.py:1312-1327)
with the dense matrices of ``fft_plan._irfft_matrices(n_base)[:K]``,
followed by ``_eval_trigger``'s high/low or threshold logic and majority
(pipeline.py:541-573, ops/triggers.py). On the card it runs in full FP32:
``torch.backends.cuda.matmul.allow_tf32`` must stay False (PyTorch's
default), which ``chip_smoke.py`` sets.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from nuradiomc_tpu_torch.ops import _build, fft_plan
from nuradiomc_tpu_torch.ops.triggers import _sliding_window_any

# kernel launches since the count was last set to 0
launches = 0

_SMEM_LIMIT = 232448          # bytes of shared memory one block may use
_KINDS = {"high_low": 0, "simple_threshold": 1}


@dataclasses.dataclass(frozen=True)
class TriggerSpecStatic:
    """Static per-trigger parameters (trigger_pallas.TriggerSpecStatic)."""

    kind: str            # 'high_low' | 'simple_threshold'
    n_bins_hl: int       # within-channel coincidence window (bins)
    n_bins_maj: int      # cross-channel coincidence window (bins)
    n_coinc: int         # number of channels required


def fused_irfft_trigger_plain(spec_re, spec_im, th_hi, th_lo, *, n_base: int,
                              scale: float,
                              triggers: Tuple[TriggerSpecStatic, ...], C: int):
    """Plain PyTorch version of the fused trigger (same contract)."""
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
    return torch.stack(fired, dim=-1), torch.stack(first, dim=-1), amp


def _kernel_fn(dtype):
    lib = _build.load("irfft_trigger")
    if dtype == torch.float32:
        fn, scalar = lib.irfft_trigger_f32, ctypes.c_float
    else:
        fn, scalar = lib.irfft_trigger_f64, ctypes.c_double
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ip] * 4 + [ctypes.c_int] * 5 + [ip, ctypes.c_int]
                   + [scalar, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.irfft_trigger_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.irfft_trigger_smem_bytes.restype = ctypes.c_long
    return fn, scalar, lib


def fused_irfft_trigger(spec_re, spec_im, th_hi, th_lo, *, n_base: int,
                        scale: float,
                        triggers: Tuple[TriggerSpecStatic, ...], C: int):
    """Fused irfft + trigger: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see the module docstring for the contract)."""
    global launches
    if spec_re.device.type == "cpu":
        return fused_irfft_trigger_plain(spec_re, spec_im, th_hi, th_lo, n_base=n_base,
                                         scale=scale, triggers=triggers, C=C)
    if spec_re.device.type != "cuda":
        raise ValueError(f"fused trigger: unsupported device {spec_re.device}")
    dtype = spec_re.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused trigger: dtype {dtype} is not float32/float64")
    R, K = spec_re.shape
    T = len(triggers)
    if C < 1 or R % C:
        raise ValueError(f"fused trigger: R={R} is not a multiple of C={C}")
    if not 1 <= K <= n_base // 2 + 1:
        raise ValueError(f"fused trigger: K={K} bins, n_base={n_base} takes 1..{n_base // 2 + 1}")
    expect = {"spec_im": (spec_im, (R, K)), "th_hi": (th_hi, (R, T)),
              "th_lo": (th_lo, (R, T))}
    for name, (t, shape) in expect.items():
        if t.device != spec_re.device:
            raise ValueError(f"fused trigger: {name} on {t.device}, spec on {spec_re.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"fused trigger: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused trigger: {name} is not contiguous")
    if not spec_re.is_contiguous():
        raise ValueError("fused trigger: spec_re is not contiguous")
    for spec in triggers:
        if spec.kind not in _KINDS:
            raise NotImplementedError(f"fused trigger: trigger kind {spec.kind}")
    fn, scalar, lib = _kernel_fn(dtype)
    max_trig, max_samples = lib.irfft_trigger_max_triggers(), lib.irfft_trigger_max_samples()
    if not 1 <= T <= max_trig:
        raise ValueError(f"fused trigger: {T} triggers, the kernel takes 1..{max_trig}")
    if not 2 <= n_base <= max_samples:
        raise ValueError(f"fused trigger: n_base={n_base} outside 2..{max_samples}")
    elem = spec_re.element_size()
    smem = lib.irfft_trigger_smem_bytes(C, n_base, K, int(elem == 8))
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"fused trigger: C * n_base * sizeof = {C} * {n_base} * {elem} bytes of "
            f"traces and the FFT's buffers ({smem} bytes) do not fit the {_SMEM_LIMIT} "
            "bytes of shared memory of one block (ROADMAP kernel work item 1: lift the "
            "trigger kernel's shared-memory limit)")
    G = R // C
    _, stages = fft_plan.plan(n_base)
    table = fft_plan.twiddles(n_base, dtype, spec_re.device)
    fired = torch.empty((G, T), dtype=torch.uint8, device=spec_re.device)
    first = torch.empty((G, T), dtype=torch.int32, device=spec_re.device)
    amp = torch.empty((R,), dtype=dtype, device=spec_re.device)

    def ints(vals):
        return (ctypes.c_int * max(len(vals), 1))(*vals)

    ptrs = [t.data_ptr() for t in (spec_re, spec_im, th_hi, th_lo, table, fired, first, amp)]
    err = fn(*ptrs, ints([_KINDS[s.kind] for s in triggers]),
             ints([s.n_bins_hl for s in triggers]),
             ints([min(s.n_bins_maj, n_base) for s in triggers]),
             ints([s.n_coinc for s in triggers]),
             T, G, C, K, n_base, ints(stages), len(stages), scalar(scale / n_base),
             _build.current_stream_ptr(spec_re.device))
    _build.check(err, "fused trigger kernel")
    launches += 1
    return fired.bool(), first, amp.reshape(G, C)
