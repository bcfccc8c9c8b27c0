"""Placement: the placement DFT onto the common time base + phase ramp +
(shower, ray) reduction, with the factored propagation chain in front
(kernel 1) or on a materialized voltage spectrum (kernel 4).

Kernel 1 replaces ``nuradiomc_tpu/ops/placement_pallas.py::
chain_placement_reduce_v3`` (placement_pallas.py:365, kernel
``_chain_kernel_v3`` :282, pallas_call :452) and, with the same contract,
the v2 ``chain_placement_reduce`` (:142, pallas_call :209); its CUDA source
is ``csrc/placement_chain.cu``. Kernel 4 replaces ``placement_reduce``
(:465, kernel ``_kernel`` :33, pallas_call :512) and the profiling tool's
epilogue variants (tools/profile_placement_variants.py); its CUDA source is
``csrc/placement_reduce.cu``. Both place each row by two FFTs in shared
memory (``csrc/placement_fft.cuh`` on ``csrc/fft_common.cuh``). Each source
note says what bounds the kernel on the H100 and how the design answers
that. Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; there is no other fallback. Both take any ``s2``.

Kernel 1 contract (rows channel-major, (shower, ray) fastest, ``s2`` rows
per output row; R = G*C*s2):

    spec_re, spec_im  [R, K_int]      Askaryan spectra (may be NaN where masked)
    att_sparse        [R, n_sparse]   attenuation at the sparse frequencies
    comb_re, comb_im  [R]             polarization x Fresnel x VEL-mix scalar
    mask              [R] bool        select (not multiply)
    tpl_idx           [R] int32       row of ``templates``
    offsets           [R]             pulse start relative to the time base (ns)
    W                 [n_sparse, K_int]  sparse -> dense interpolation
    templates         [n_tpl, K_int]  complex VEL templates, DC bins zeroed
    n_int, n_base     the placement: rfft(pad(irfft(V, n_int), n_base)),
                      K_int <= n_int/2 + 1 <= n_base/2 + 1
    K_place           output bins, <= n_base/2 + 1
    returns (out_re, out_im) [R // s2, K_place]

Kernel 4 contract (same row order):

    volt_re, volt_im  [R, K_int]      the voltage spectrum, rows already masked
                                      (a zero row adds nothing: the kernel skips it)
    offsets           [R]
    n_int, n_base, K_place            the placement, as kernel 1's
    returns (out_re, out_im) [R // s2, K_place], the K_place columns (not the
    TPU kernel's 128-padded width)

The plain versions are the XLA path of the JAX pipeline (pipeline.py:
1280-1289, einsum with the dense placement matrices
``fft_plan.placement_dense(n_int, n_base, ...)``, plus the factored phase
ramp of ``trace.time_shift_phase_uniform``). On the card they run in
full FP32: ``torch.backends.cuda.matmul.allow_tf32`` must stay False
(PyTorch's default), which ``chip_smoke.py`` sets.
"""

from __future__ import annotations

import ctypes
import math

import torch

from nuradiomc_tpu_torch.ops import _build, fft_plan
from nuradiomc_tpu_torch.ops.trace import time_shift_phase_uniform

# kernel launches since the count was last set to 0: kernel 1, kernel 4
launches = 0
reduce_launches = 0

_SMEM_LIMIT = 232448          # bytes of shared memory one block may use


def chain_placement_reduce_plain(spec_re, spec_im, att_sparse, comb_re,
                                 comb_im, mask, tpl_idx, offsets, W,
                                 templates, *, s2: int, df: float, n_int: int,
                                 n_base: int, K_place: int):
    """Plain PyTorch version of the placement chain (same contract)."""
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
                           n_base: int, K_place: int, phase: bool = True):
    """Plain PyTorch version of kernel 4 (see the module docstring for the
    contract); ``phase=False`` drops the phase ramp (the profiling
    variant)."""
    D_r, D_i = fft_plan.placement_dense(n_int, n_base, volt_re.shape[1], K_place,
                                        volt_re.dtype, volt_re.device)
    xb = torch.complex(volt_re @ D_r.real + volt_im @ D_i.real,
                       volt_re @ D_r.imag + volt_im @ D_i.imag)   # [R, K_place]
    if phase:
        xb = xb * time_shift_phase_uniform(D_r.shape[1], df, offsets)
    R = volt_re.shape[0]
    out = xb.reshape(R // s2, s2, -1).sum(dim=1)
    return out.real, out.imag


def _typed(dtype):
    """(symbol suffix, ctypes scalar) of a dtype's kernel instantiation."""
    return ("f32", ctypes.c_float) if dtype == torch.float32 else ("f64", ctypes.c_double)


def _chain_fn(dtype):
    lib = _build.load("placement_chain")
    tag, scalar = _typed(dtype)
    fn = getattr(lib, f"placement_chain_{tag}")
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_int] * 2
                   + [scalar, scalar, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.placement_chain_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.placement_chain_smem_bytes.restype = ctypes.c_long
    return fn, lib, scalar


def _reduce_fn(dtype):
    lib = _build.load("placement_reduce")
    tag, scalar = _typed(dtype)
    fn = getattr(lib, f"placement_reduce_{tag}")
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_int] * 2
                   + [ctypes.c_int, scalar, scalar, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.placement_reduce_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.placement_reduce_smem_bytes.restype = ctypes.c_long
    return fn, lib, scalar


def _check(what, ref, raw, split):
    """Device, shape, dtype (and for ``raw``, contiguity) of the kernel's
    inputs: {name: (tensor, shape, dtype)}."""
    for name, (t, shape, dt) in {**raw, **split}.items():
        if t.device != ref.device:
            raise ValueError(f"{what}: {name} on {t.device}, {ref.device} expected")
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dt}")
        if name in raw and not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _check_smem(what, smem):
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{what}: needs {smem} bytes of shared memory, more than "
                         f"{_SMEM_LIMIT}")


def _check_lengths(what, K_int, n_int, n_base, K_place):
    if not (2 <= n_int <= n_base and 1 <= K_int <= n_int // 2 + 1
            and 1 <= K_place <= n_base // 2 + 1):
        raise ValueError(f"{what}: K_int={K_int}, n_int={n_int}, n_base={n_base}, "
                         f"K_place={K_place} need K_int <= n_int/2 + 1, n_int <= n_base "
                         "and K_place <= n_base/2 + 1")


def _ints(vals):
    return (ctypes.c_int * max(len(vals), 1))(*vals)


def _fft_args(n_int, n_base, dtype, dev):
    """The two transforms' twiddle tables and (radices, count) plan arguments."""
    st_int, st_base = fft_plan.plan(n_int)[1], fft_plan.plan(n_base)[1]
    tables = (fft_plan.twiddles(n_int, dtype, dev), fft_plan.twiddles(n_base, dtype, dev))
    return tables, (_ints(st_int), len(st_int), _ints(st_base), len(st_base))


def chain_placement_reduce(spec_re, spec_im, att_sparse, comb_re, comb_im,
                           mask, tpl_idx, offsets, W, templates, *, s2: int,
                           df: float, n_int: int, n_base: int, K_place: int):
    """Placement chain: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see the module docstring for the contract)."""
    global launches
    if spec_re.device.type == "cpu":
        return chain_placement_reduce_plain(
            spec_re, spec_im, att_sparse, comb_re, comb_im, mask, tpl_idx,
            offsets, W, templates, s2=s2, df=df, n_int=n_int, n_base=n_base,
            K_place=K_place)
    if spec_re.device.type != "cuda":
        raise ValueError(f"placement chain: unsupported device {spec_re.device}")
    dtype = spec_re.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"placement chain: dtype {dtype} is not float32/float64")
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    R, K_int = spec_re.shape
    n_sparse = att_sparse.shape[1]
    n_tpl = templates.shape[0]
    _check_lengths("placement chain", K_int, n_int, n_base, K_place)
    if s2 < 1 or R % s2:
        raise ValueError(f"placement chain: R={R} is not a multiple of s2={s2}")
    raw = {   # passed to the kernel as they are: checked for contiguity
        "spec_re": (spec_re, (R, K_int), dtype), "spec_im": (spec_im, (R, K_int), dtype),
        "att_sparse": (att_sparse, (R, n_sparse), dtype),
        "comb_re": (comb_re, (R,), dtype), "comb_im": (comb_im, (R,), dtype),
        "mask": (mask, (R,), torch.bool), "tpl_idx": (tpl_idx, (R,), torch.int32),
        "offsets": (offsets, (R,), dtype), "W": (W, (n_sparse, K_int), dtype),
    }
    _check("placement chain", spec_re, raw,
           {"templates": (templates, (n_tpl, K_int), ctype)})
    fn, lib, scalar = _chain_fn(dtype)
    _check_smem("placement chain", lib.placement_chain_smem_bytes(
        K_int, n_sparse, K_place, n_int, n_base, int(dtype == torch.float64)))
    tpl_re, tpl_im = templates.real.contiguous(), templates.imag.contiguous()
    dev = spec_re.device
    tables, plans = _fft_args(n_int, n_base, dtype, dev)
    out_re = torch.empty((R // s2, K_place), dtype=dtype, device=dev)
    out_im = torch.empty_like(out_re)
    ptrs = [t.data_ptr() for t, _, _ in raw.values()] + [
        t.data_ptr() for t in (tpl_re, tpl_im, *tables, out_re, out_im)]
    err = fn(*ptrs, R, s2, K_int, n_sparse, K_place, n_int, n_base, *plans,
             scalar(-2.0 * math.pi * df), scalar(1.0 / n_int),
             _build.current_stream_ptr(dev))
    _build.check(err, "placement chain kernel")
    launches += 1
    return out_re, out_im


def placement_reduce(volt_re, volt_im, offsets, *, s2: int, df: float, n_int: int,
                     n_base: int, K_place: int, phase: bool = True):
    """Placement of a materialized voltage spectrum: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors (see the module docstring for
    the contract); ``phase=False`` launches the no-phase profiling variant."""
    global reduce_launches
    kw = dict(s2=s2, df=df, n_int=n_int, n_base=n_base, K_place=K_place, phase=phase)
    if volt_re.device.type == "cpu":
        return placement_reduce_plain(volt_re, volt_im, offsets, **kw)
    if volt_re.device.type != "cuda":
        raise ValueError(f"placement reduce: unsupported device {volt_re.device}")
    dtype = volt_re.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"placement reduce: dtype {dtype} is not float32/float64")
    R, K_int = volt_re.shape
    _check_lengths("placement reduce", K_int, n_int, n_base, K_place)
    _check("placement reduce", volt_re,
           {"volt_re": (volt_re, (R, K_int), dtype), "volt_im": (volt_im, (R, K_int), dtype),
            "offsets": (offsets, (R,), dtype)}, {})
    if s2 < 1 or R % s2:
        raise ValueError(f"placement reduce: R={R} is not a multiple of s2={s2}")
    fn, lib, scalar = _reduce_fn(dtype)
    _check_smem("placement reduce", lib.placement_reduce_smem_bytes(
        K_int, K_place, n_int, n_base, int(dtype == torch.float64)))
    dev = volt_re.device
    tables, plans = _fft_args(n_int, n_base, dtype, dev)
    out_re = torch.empty((R // s2, K_place), dtype=dtype, device=dev)
    out_im = torch.empty_like(out_re)
    err = fn(*[t.data_ptr() for t in (volt_re, volt_im, offsets, *tables, out_re, out_im)],
             R, s2, K_int, K_place, n_int, n_base, *plans, int(phase),
             scalar(-2.0 * math.pi * df), scalar(1.0 / n_int),
             _build.current_stream_ptr(dev))
    _build.check(err, "placement reduce kernel")
    reduce_launches += 1
    return out_re, out_im
