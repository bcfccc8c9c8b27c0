"""Fused trigger-trace irfft + trigger evaluation (kernel 2).

Replaces ``nuradiomc_tpu/ops/trigger_pallas.py::fused_irfft_trigger``
(trigger_pallas.py:123, kernel ``_kernel`` :68, ``_swa`` :49, pallas_call
:172). The CUDA kernel is ``csrc/irfft_trigger.cu``, which makes the traces
by an inverse real FFT in shared memory; its source note says what bounds it
on the H100 and how the design answers that. :func:`fused_irfft_trigger`
launches it for CUDA tensors and runs :func:`fused_irfft_trigger_plain` for
CPU tensors; there is no other fallback. The kernel's shared memory holds one
trace whatever C is, so the limits that remain are ``n_base`` (one trace, its
FFT buffer and the staged bins must fit a block: 8192 in float64 does) and
65535 channels; a trigger list longer than one launch takes is cut into
slices, one launch of the same kernel each.

Contract:

    spec_re, spec_im  [R, K]   filtered rFFT spectra, rows (group, channel),
                               channel fastest, R = G * C, K <= n_base/2 + 1
                               (the bins from K on are zero)
    th_hi, th_lo      [R, T]   absolute thresholds per row and trigger
                               (th_lo unused by simple_threshold); th_hi =
                               +inf takes the row's channel out of that
                               trigger (a per-trigger channel subset)
    n_base            trace length: trace = scale * numpy's irfft(X, n_base)
    scale             trace scale, sampling_rate / sqrt(2)
    triggers          T static trigger specs, T >= 0
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
    if not triggers:                 # no column: the max amplitude alone
        return (torch.zeros((G, 0), dtype=torch.bool, device=v.device),
                torch.zeros((G, 0), dtype=torch.int32, device=v.device), amp)
    return torch.stack(fired, dim=-1), torch.stack(first, dim=-1), amp


def _kernel_fn(dtype):
    lib = _build.load("irfft_trigger")
    if dtype == torch.float32:
        fn, scalar = lib.irfft_trigger_f32, ctypes.c_float
    else:
        fn, scalar = lib.irfft_trigger_f64, ctypes.c_double
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ip] * 4 + [ctypes.c_int] * 7 + [ip, ctypes.c_int]
                   + [scalar, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.irfft_trigger_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.irfft_trigger_smem_bytes.restype = ctypes.c_long
    return fn, scalar, lib


def triggers_per_launch(lib, C: int, n_base: int, K: int, f64: bool, T: int) -> int:
    """How many of ``T`` trigger columns one launch takes: the kernel's own
    maximum, or fewer where their per-sample counts do not fit the block's
    shared memory beside the trace, the FFT buffer and the staging rows."""
    def smem(n_trig):
        return lib.irfft_trigger_smem_bytes(C, n_base, K, n_trig, int(f64))

    per = min(T, lib.irfft_trigger_max_triggers())
    while per > 1 and smem(per) > _SMEM_LIMIT:
        per -= 1
    if smem(per) > _SMEM_LIMIT:
        raise ValueError(
            f"fused trigger: one trace of n_base={n_base} samples of {8 if f64 else 4} bytes, "
            f"its FFT buffer, {K} staged bins and one trigger's counts need {smem(per)} bytes "
            f"of shared memory, a block has {_SMEM_LIMIT}")
    return per


def fused_irfft_trigger(spec_re, spec_im, th_hi, th_lo, *, n_base: int,
                        scale: float,
                        triggers: Tuple[TriggerSpecStatic, ...], C: int):
    """Fused irfft + trigger: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see the module docstring for the contract).
    Any number of triggers (none: the max amplitude alone), of channels and
    of groups; a list longer than one launch takes is cut into slices, one
    launch of the same kernel each."""
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
    if C < 1 or R % C or C > 0xffff:
        raise ValueError(f"fused trigger: R={R} is not a multiple of C={C} in 1..65535")
    if not 2 <= n_base <= 0xffff:
        raise ValueError(f"fused trigger: n_base={n_base} outside 2..65535")
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
    per = triggers_per_launch(lib, C, n_base, K, dtype == torch.float64, T)
    G = R // C
    _, stages = fft_plan.plan(n_base)
    table = fft_plan.twiddles(n_base, dtype, spec_re.device)
    fired = torch.empty((G, T), dtype=torch.uint8, device=spec_re.device)
    first = torch.empty((G, T), dtype=torch.int32, device=spec_re.device)
    amp = torch.empty((R,), dtype=dtype, device=spec_re.device)

    def ints(vals):
        return (ctypes.c_int * max(len(vals), 1))(*vals)

    ptrs = [t.data_ptr() for t in (spec_re, spec_im, th_hi, th_lo, table, fired, first, amp)]
    # one launch per slice of ``per`` columns; with no column, one for amp
    for t0 in range(0, max(T, 1), max(per, 1)):
        part = triggers[t0:t0 + per]
        err = fn(*ptrs, ints([_KINDS[s.kind] for s in part]),
                 ints([s.n_bins_hl for s in part]),
                 ints([min(s.n_bins_maj, n_base) for s in part]),
                 ints([s.n_coinc for s in part]),
                 len(part), t0, T, G, C, K, n_base, ints(stages), len(stages),
                 scalar(scale / n_base), _build.current_stream_ptr(spec_re.device))
        _build.check(err, "fused trigger kernel")
        launches += 1
    return fired.bool(), first, amp.reshape(G, C)
