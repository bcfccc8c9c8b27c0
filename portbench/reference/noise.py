# frozen copy of nuradiomc_tpu_torch/ops/noise.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
"""Band-limited noise synthesis in the rFFT domain (torch).

Counterpart of ``nuradiomc_tpu/ops/noise.py::bandlimited_noise_spectrum``
(noise.py:25-91; reference channelGenericNoiseAdder.py:66-160). Noise is
built in the rFFT domain on the active band [min_freq, max_freq] with

    sigscale = n_samples / sqrt(n_active_bins)
    perfect_white: |A_k| = amplitude * sigscale
    rayleigh:      |A_k| ~ Rayleigh(amplitude * sigscale / sqrt(2))

uniform phases on bins 1..(n-1)//2 (DC and Nyquist stay real), divided by
the sampling rate, so the framework ``freq2time`` gives a trace of RMS
~= ``amplitude``.

The function is split in two so that a test can hand the transform the exact
numbers ``jax.random`` drew: :func:`draw_noise` takes a ``torch.Generator``
in place of a JAX key and returns the random numbers, and
:func:`noise_spectrum_from_draws` turns them into the spectrum. torch and JAX
draw different numbers from the same seed, so the noise is the same
distribution, not the same stream.
"""

from __future__ import annotations

import math

import torch


def draw_noise(generator: torch.Generator, shape, n_samples: int, dtype,
               type: str = "rayleigh", sampler: str = "phase"):
    """Random numbers of ``len(shape)``-batched realizations, each [..., F]:
    ``"phase"`` two uniforms (amplitude on [tiny, 1), phase on [0, 1)),
    ``"gaussian"`` two standard normals."""
    size = (*shape, n_samples // 2 + 1)
    dev = generator.device
    if type == "rayleigh" and sampler == "gaussian":
        return (torch.randn(size, generator=generator, dtype=dtype, device=dev),
                torch.randn(size, generator=generator, dtype=dtype, device=dev))
    tiny = torch.finfo(dtype).tiny
    # jax.random.uniform(minval=tiny): tiny + (1 - tiny) u, at least tiny
    u_amp = torch.clamp(torch.rand(size, generator=generator, dtype=dtype, device=dev)
                        * (1.0 - tiny) + tiny, min=tiny)
    u_phase = torch.rand(size, generator=generator, dtype=dtype, device=dev)
    return u_amp, u_phase


def noise_spectrum_from_draws(draws, n_samples: int, sampling_rate: float,
                              amplitude, min_freq=None, max_freq=None,
                              type: str = "rayleigh", sampler: str = "phase"):
    """The noise rFFT spectrum [..., F] from :func:`draw_noise`'s numbers;
    ``amplitude`` broadcasts against the batch axes (shape [..., 1])."""
    a, b = draws
    dtype = a.dtype
    freqs = torch.fft.rfftfreq(n_samples, 1.0 / sampling_rate, dtype=dtype, device=a.device)
    if min_freq is None or min_freq == 0:
        # remove DC only (channelGenericNoiseAdder.py:112-117)
        min_freq = 0.5 * (freqs[2] - freqs[1])
    if max_freq is None:
        max_freq = freqs[-1]
    selection = (freqs >= min_freq) & (freqs <= max_freq)
    sigscale = n_samples / torch.sqrt(torch.sum(selection).to(dtype))
    bin_idx = torch.arange(freqs.shape[0], device=a.device)
    phase_bins = (bin_idx >= 1) & (bin_idx <= (n_samples - 1) // 2)
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
    if type == "rayleigh" and sampler == "gaussian":
        fsigma = amplitude * sigscale / math.sqrt(2.0)
        val = torch.where(phase_bins, torch.complex(a, b),
                          torch.sqrt(a ** 2 + b ** 2).to(ctype))
        return torch.where(selection, fsigma * val, 0.0) / sampling_rate
    if type == "perfect_white":
        ampl = torch.where(selection, amplitude * sigscale, 0.0)
    elif type == "rayleigh":
        fsigma = amplitude * sigscale / math.sqrt(2.0)
        ampl = torch.where(selection, fsigma * torch.sqrt(-2.0 * torch.log(a)), 0.0)
    else:
        raise NotImplementedError(f"noise type {type}")
    phases = b * 2 * math.pi
    phasor = torch.where(phase_bins, torch.polar(torch.ones_like(phases), phases),
                         torch.ones((), dtype=ctype, device=a.device))
    return ampl * phasor / sampling_rate
