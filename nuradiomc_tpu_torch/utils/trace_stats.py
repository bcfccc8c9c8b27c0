"""Waveform summary statistics on tensors (NuRadioReco/utilities/
trace_utilities.py:342-720).

Counterpart of ``nuradiomc_tpu/utils/trace_stats.py``: every function takes
traces as tensors with time on the last axis and any leading axes, and
returns tensors on the traces' device (one value per trace where the
original returns a number).
"""

from __future__ import annotations

import math

import torch

from nuradiomc_tpu_torch.ops.trace import hilbert_envelope


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` for a number ``d`` as a true division, as numpy's: a CUDA
    tensor divided by a Python number is multiplied by its reciprocal."""
    return x / torch.as_tensor(d, dtype=x.real.dtype, device=x.device)


def _symmetric_windows(trace: torch.Tensor, size: int) -> torch.Tensor:
    """[..., n, size] windows of ``scipy.ndimage``'s 1-D filters (origin 0:
    [i - size//2, i + (size-1)//2], mode 'reflect', which repeats the edge
    sample: d c b a | a b c d | d c b a)."""
    n = trace.shape[-1]
    idx = torch.arange(n, device=trace.device)[:, None] \
        + torch.arange(size, device=trace.device) - size // 2
    period = 2 * n
    idx = torch.remainder(idx, period)
    idx = torch.where(idx >= n, period - 1 - idx, idx)
    return trace[..., idx]


def peak_to_peak_amplitudes(trace: torch.Tensor, coincidence_window_size: int) -> torch.Tensor:
    """Local peak-to-peak amplitudes: running max - running min (:420-437)."""
    win = _symmetric_windows(trace, coincidence_window_size)
    return win.amax(-1) - win.amin(-1)


def get_split_trace_noise_RMS(trace: torch.Tensor, segments=4, lowest=2) -> torch.Tensor:
    """Mean of the lowest per-segment RMS values (``np.array_split``
    segments, :440-469)."""
    n = trace.shape[-1]
    sizes = [n // segments + 1] * (n % segments) + [n // segments] * (segments - n % segments)
    rms = torch.stack([seg.std(-1, correction=0) for seg in torch.split(trace, sizes, -1)], -1)
    return torch.sort(rms, -1).values[..., :lowest].mean(-1)


def get_signal_to_noise_ratio(trace: torch.Tensor, noise_rms, window_size=3) -> torch.Tensor:
    """Max windowed peak-to-peak over twice the noise RMS (:472-500)."""
    if window_size < 2:
        raise ValueError(f"Window size must be greater-equal 2 (but is {window_size})")
    return peak_to_peak_amplitudes(trace, window_size).amax(-1) / (2 * noise_rms)


def analytic_signal(trace: torch.Tensor) -> torch.Tensor:
    """``scipy.signal.hilbert`` along the last axis (even and odd lengths)."""
    n = trace.shape[-1]
    h = torch.zeros(n, dtype=trace.dtype, device=trace.device)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return torch.fft.ifft(torch.fft.fft(trace, dim=-1) * h, dim=-1)


def get_hilbert_envelope(trace: torch.Tensor) -> torch.Tensor:
    return hilbert_envelope(trace)


def get_impulsivity(trace: torch.Tensor) -> torch.Tensor:
    """CDF-of-power concentration around the envelope maximum, scaled to
    [0, 1] (:569-605)."""
    env = hilbert_envelope(trace)
    n = env.shape[-1]
    closeness = torch.abs(torch.arange(n, device=env.device)
                          - torch.argmax(env, -1, keepdim=True))
    order = torch.argsort(closeness, dim=-1, stable=True)
    cdf = torch.cumsum(torch.gather(env, -1, order) ** 2, -1)
    cdf = cdf / cdf[..., -1:]
    return torch.clamp(cdf.mean(-1) * 2.0 - 1.0, min=0.0)


def get_entropy(trace: torch.Tensor, n_hist_bins=50) -> torch.Tensor:
    """Shannon entropy (bits) of the amplitude histogram (:656-685), with
    ``np.histogram``'s edges (``linspace`` of min..max, widened by 0.5 on
    each side for a constant trace) and its bin rule."""
    first = trace.amin(-1, keepdim=True)
    last = trace.amax(-1, keepdim=True)
    flat = first == last
    first = torch.where(flat, first - 0.5, first)
    last = torch.where(flat, last + 0.5, last)
    steps = torch.arange(n_hist_bins + 1, dtype=trace.dtype, device=trace.device)
    edges = steps * true_div(last - first, n_hist_bins) + first   # numpy's edges
    edges[..., -1:] = last
    idx = (((trace - first) / (last - first)) * n_hist_bins).to(torch.int64)
    idx = torch.where(idx == n_hist_bins, idx - 1, idx)
    idx = torch.where(trace < torch.gather(edges, -1, idx), idx - 1, idx)
    up = (trace >= torch.gather(edges, -1, idx + 1)) & (idx != n_hist_bins - 1)
    idx = torch.where(up, idx + 1, idx)
    counts = torch.zeros((*trace.shape[:-1], n_hist_bins), dtype=trace.dtype,
                         device=trace.device)
    counts.scatter_add_(-1, idx, torch.ones_like(trace))
    hist = counts / (edges[..., 1:] - edges[..., :-1]) / counts.sum(-1, keepdim=True)
    p = hist / hist.sum(-1, keepdim=True)
    p = p / p.sum(-1, keepdim=True)          # scipy.stats.entropy normalizes again
    entr = torch.where(p > 0, -p * torch.log(torch.where(p > 0, p, 1.0)), 0.0)
    return entr.sum(-1) / math.log(2)


def get_kurtosis(trace: torch.Tensor) -> torch.Tensor:
    """``scipy.stats.kurtosis`` (Fisher, biased) of the samples (:688-703)."""
    mean = trace.mean(-1, keepdim=True)
    dev = trace - mean
    m2 = (dev ** 2).mean(-1)
    m4 = (dev ** 4).mean(-1)
    eps = torch.finfo(trace.dtype).eps
    zero = m2 <= (eps * mean[..., 0]) ** 2
    return torch.where(zero, torch.nan, m4 / m2 ** 2.0) - 3


def get_teager_kaiser_energy(trace: torch.Tensor) -> torch.Tensor:
    """|TKEO|: x[i]^2 - x[i-1] x[i+1] (:706-...), 0 at both ends."""
    tkeo = torch.zeros_like(trace)
    tkeo[..., 1:-1] = trace[..., 1:-1] ** 2 - trace[..., :-2] * trace[..., 2:]
    return torch.abs(tkeo)


def _zscore(tr: torch.Tensor) -> torch.Tensor:
    return (tr - tr.mean(-1, keepdim=True)) / tr.std(-1, correction=0, keepdim=True)


def get_coherent_sum(trace_set: torch.Tensor, ref_trace: torch.Tensor,
                     use_envelope=False) -> torch.Tensor:
    """Coherently-summed waveform (:608-653): every trace of ``trace_set``
    [..., T, n] rolled by the lag of the maximum of its z-scored full
    correlation with the reference [..., n], then added to the reference in
    the reference's order; leading axes are stations. The correlations
    (``scipy.signal.correlate(ref, tr, 'full') / n``, lags -(n-1)..n-1) are
    taken through one zero-padded FFT of every trace."""
    n = ref_trace.shape[-1]
    process = (lambda tr: _zscore(hilbert_envelope(tr))) if use_envelope else _zscore
    ref_p = process(ref_trace)
    traces_p = process(trace_set)
    size = 1 << (2 * n - 2).bit_length()          # >= 2n - 1
    cyclic = torch.fft.irfft(torch.fft.rfft(ref_p, size)[..., None, :]
                             * torch.conj(torch.fft.rfft(traces_p, size)), size)
    full = torch.remainder(torch.arange(2 * n - 1, device=trace_set.device) - (n - 1), size)
    lags = torch.argmax(cyclic[..., full], -1) - (n - 1)     # the 1/n does not move it
    idx = torch.remainder(torch.arange(n, device=trace_set.device) - lags[..., None], n)
    rolled = torch.gather(trace_set, -1, idx)
    out = ref_trace
    for k in range(rolled.shape[-2]):       # the reference's order of additions
        out = out + rolled[..., k, :]
    return out


def get_stokes(trace_u: torch.Tensor, trace_v: torch.Tensor, window_samples=128,
               squeeze=True) -> torch.Tensor:
    """Stokes parameters I, Q, U, V [4, ...] of two perpendicular efield
    components from their analytic signals, optionally as a running average
    over ``window_samples`` (trace_utilities.get_stokes:342-417), the running
    sum as a ``conv1d`` with a ones kernel."""
    if trace_u.shape[-1] != trace_v.shape[-1]:
        raise ValueError("the two components must have the same length")
    h1 = analytic_signal(trace_u)
    h2 = analytic_signal(trace_v)
    uv = 2 * h1 * torch.conj(h2)
    a1, a2 = torch.abs(h1) ** 2, torch.abs(h2) ** 2
    stokes = torch.stack([a1 + a2, a1 - a2, uv.real, uv.imag])
    if window_samples == 1:
        return stokes
    if window_samples is None:
        window_samples = h1.shape[-1]
    flat = stokes.reshape(-1, 1, stokes.shape[-1])
    ones = torch.ones((1, 1, window_samples), dtype=flat.dtype, device=flat.device)
    summed = torch.nn.functional.conv1d(flat, ones)
    stokes = summed.reshape(*stokes.shape[:-1], -1) / window_samples
    return stokes.squeeze() if squeeze else stokes
