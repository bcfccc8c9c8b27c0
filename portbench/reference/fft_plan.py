# frozen copy of nuradiomc_tpu_torch/ops/fft_plan.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
"""Host tables of the placement and trigger transforms.

Two kinds of tables live here, both built on the host with numpy in float64
and cached on the device per (length, dtype, device):

* the FFT plan of the hand-written kernels (``csrc/fft_common.cuh``): the
  stage radices of a real length's complex transform (:func:`radices`,
  :func:`plan`) and its twiddle table E[k] = exp(+2 pi i k / n), k < n
  (:func:`twiddles`), from which the kernels take every factor;
* the dense real-linear matrices of the same maps -- numpy's own irfft,
  rfft o pad o irfft, the decimating irfft and the FFT upsampling written
  out as matrices (copies of the JAX package's ``_irfft_matrices``,
  ``_placement_matrices``, ``_decimating_irfft_matrices`` and
  ``_fft_upsample_matrix``) -- which the kernels' plain versions multiply
  by: they are the reference the FFTs are held to.
"""

from __future__ import annotations

import functools

import torch


# copied from nuradiomc_tpu/sim/pipeline.py:336 (_irfft_matrices)
@functools.lru_cache(maxsize=8)
def _irfft_matrices(n_base: int):
    """Real-linear irfft as two dense [F_base, n_base] matrices:
    x = I_r Re(X) + I_i Im(X) (irfft is real-linear in (Re, Im))."""
    import numpy as _np
    F = n_base // 2 + 1
    eye = _np.eye(F)
    I_r = _np.fft.irfft(eye, n=n_base, axis=1)
    I_i = _np.fft.irfft(1j * eye, n=n_base, axis=1)
    return I_r, I_i


# copied from nuradiomc_tpu/sim/pipeline.py:396 (_placement_matrices)
@functools.lru_cache(maxsize=8)
def _placement_matrices(n_int: int, n_base: int):
    """Dense real-linear maps from a short rFFT spectrum to the spectrum of
    the zero-padded trace on the n_base grid: X_base = D_r Re(V) + D_i Im(V)
    (irfft is real-linear, not complex-linear, so two matrices are needed).
    Built column-by-column with numpy's own irfft/rfft, so edge-bin handling
    matches the FFT exactly."""
    import numpy as _np
    F_int = n_int // 2 + 1
    eye = _np.eye(F_int)
    x_r = _np.fft.irfft(eye, n=n_int, axis=1)
    x_i = _np.fft.irfft(1j * eye, n=n_int, axis=1)
    pad = ((0, 0), (0, n_base - n_int))
    D_r = _np.fft.rfft(_np.pad(x_r, pad), axis=1)
    D_i = _np.fft.rfft(_np.pad(x_i, pad), axis=1)
    return D_r, D_i


# copied from nuradiomc_tpu/sim/pipeline.py:349 (_decimating_irfft_matrices)
@functools.lru_cache(maxsize=8)
def _decimating_irfft_matrices(n_base: int, n_hi: int, decim: int):
    """irfft(spec, n=n_hi)[::decim] as two [F_base, n_hi//decim] matrices
    (spectrum zero-padding is implicit in irfft's n= argument)."""
    import numpy as _np
    F = n_base // 2 + 1
    eye = _np.eye(F)
    D_r = _np.fft.irfft(eye, n=n_hi, axis=1)[:, ::decim]
    D_i = _np.fft.irfft(1j * eye, n=n_hi, axis=1)[:, ::decim]
    return D_r, D_i


# copied from nuradiomc_tpu/sim/pipeline.py:361 (_fft_upsample_matrix)
@functools.lru_cache(maxsize=8)
def _fft_upsample_matrix(n_in: int, factor: int):
    """rfft -> zero-pad -> irfft FFT upsampling as one [n_in, n_in*factor]
    matrix; the V/GHz density convention makes the net scale = factor."""
    import numpy as _np
    eye = _np.eye(n_in)
    return _np.fft.irfft(_np.fft.rfft(eye, axis=1),
                         n=n_in * factor, axis=1) * factor


@functools.lru_cache(maxsize=32)
def irfft_dense(n_base: int, K: int, dtype, device):
    """(I_r, I_i) [K, n_base] on the device: the trigger kernel's plain
    version multiplies by them."""
    return tuple(torch.as_tensor(m[:K], dtype=dtype, device=device).contiguous()
                 for m in _irfft_matrices(n_base))


@functools.lru_cache(maxsize=32)
def placement_dense(n_int: int, n_base: int, K_int: int, K_place: int, dtype, device):
    """(D_r, D_i) [K_int, K_place] complex on the device (``dtype`` is the
    real dtype): the placement kernels' plain versions multiply by them."""
    ctype = torch.complex64 if dtype == torch.float32 else torch.complex128
    return tuple(torch.as_tensor(m[:K_int, :K_place], dtype=ctype, device=device).contiguous()
                 for m in _placement_matrices(n_int, n_base))


@functools.lru_cache(maxsize=32)
def decimate_dense(n_base: int, n_hi: int, decim: int, K: int, dtype, device):
    """(Dd_r, Dd_i) [K, n_dec] on the device, n_dec = ceil(n_hi / decim):
    irfft(X, n_hi)[::decim] of the first K bins; the phased-array trigger's
    plain version multiplies by them."""
    return tuple(torch.as_tensor(m[:K], dtype=dtype, device=device).contiguous()
                 for m in _decimating_irfft_matrices(n_base, n_hi, decim))


@functools.lru_cache(maxsize=32)
def upsample_dense(n_in: int, factor: int, dtype, device):
    """U [n_in, n_in * factor] on the device: factor * irfft(rfft(x),
    n_in * factor) as x @ U."""
    return torch.as_tensor(_fft_upsample_matrix(n_in, factor), dtype=dtype,
                           device=device).contiguous()
