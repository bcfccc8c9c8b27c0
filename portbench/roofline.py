# frozen copy of chip_smoke.py:417-526 (commit 493e4d9): HBM_BYTES_PER_S,
# PEAK_FLOPS, _bound, _rfft_flops, _padded_rfft_flops, _placement_chain_bound,
# _trigger_bound, _pa_bound; fft_plan.complex_length from
# nuradiomc_tpu_torch/ops/fft_plan.py and pa_trigger.n_dec_of from
# nuradiomc_tpu_torch/ops/pa_trigger.py:59-61. The bounds take the problem
# sizes of an op-level call (``problem`` dicts the metric readers fill from
# the call's inputs) instead of the tensors themselves.
"""The least time one NVIDIA H100 SXM could take for each kernel's problem:
the larger of the bytes it must move over the HBM rate and its operations
over the card's peak rate for its dtype (NVIDIA's data sheet)."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
# float32 on the CUDA cores, float64 on the FP64 tensor cores (its highest rate)
PEAK_FLOPS = {4: 67e12, 8: 67e12}           # by element size in bytes


def bound_s(nbytes, flops, element_size):
    """(bound seconds, what sets it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[element_size]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def complex_length(n: int) -> int:
    """The complex FFT length of a real transform of length n."""
    return n // 2 if n % 2 == 0 else n


def rfft_flops(n):
    """A real FFT of length n through the half-length complex one:
    5 L log2 L for the L-point transform, ~10 per point for the Hermitian step."""
    L = complex_length(n)
    return 5 * L * math.log2(max(L, 2)) + 10 * L


def padded_rfft_flops(n_in, n):
    """A real FFT of length n whose input is zero past its first n_in samples:
    P/2 FFTs of n_in and their ramps where n = P n_in with P even, else the
    full transform."""
    P = n // n_in
    if n % n_in or P < 2 or P % 2:
        return rfft_flops(n)
    return P // 2 * (5 * n_in * math.log2(n_in) + 2 * n_in)


def placement_chain_bound(p):
    """Kernel 1: every row's mask read; a live row's spectra, attenuation
    nodes, scalars and offset read, chained, placed by an inverse FFT of
    n_int and a forward FFT of n_base pruned to its n_int inputs, and
    phase-summed; W and the templates read once; each output row written
    once. ``p``: R, K_int, n_sparse, K_place, live, s2, n_int, n_base,
    W_numel, tpl_numel, e (element size)."""
    e, R, K_int, K_place, live = p["e"], p["R"], p["K_int"], p["K_place"], p["live"]
    nbytes = (R + live * (2 * K_int * e + p["n_sparse"] * e + 3 * e + 4)
              + p["W_numel"] * e + p["tpl_numel"] * 2 * e + (R // p["s2"]) * K_place * 2 * e)
    flops = live * (K_int * (2 * p["n_sparse"] + 14) + rfft_flops(p["n_int"])
                    + padded_rfft_flops(p["n_int"], p["n_base"]) + 14 * K_place
                    + 20 * (32 + K_place / 32))
    return bound_s(nbytes, flops, e)


def trigger_bound(p):
    """Kernel 2: each row's K bins and thresholds read once, one inverse FFT
    of n_base and the trigger logic per row, the outputs written. ``p``: R,
    K, T, C, n_base, e."""
    e, R, K, T = p["e"], p["R"], p["K"], p["T"]
    G = R // p["C"]
    nbytes = R * K * 2 * e + 2 * R * T * e + G * T * 5 + R * e
    flops = R * (rfft_flops(p["n_base"]) + p["n_base"] * (2 + 6 * T))
    return bound_s(nbytes, flops, e)


def pa_bound(p):
    """Kernel 3: each row's K bins read once, the small outputs written once;
    per row an inverse FFT of n_base and its maximum, the decimated trace, the
    ADC, a forward FFT of n_dec and an inverse one of n_up; per group B beams
    of n_up samples from C channels and B n_frames window sums. ``p``: R, K,
    C, B, n_base, n_hi, decim, up, window, step, e."""
    e, R, K, C, B = p["e"], p["R"], p["K"], p["C"], p["B"]
    G = R // C
    n_base, n_hi, decim, up = p["n_base"], p["n_hi"], p["decim"], p["up"]
    n_dec = -(-n_hi // decim)
    n_up = n_dec * up
    n_frames = (n_up - p["window"]) // p["step"]
    nbytes = R * K * 2 * e + G * 5 + R * e
    dec = 2 * K + rfft_flops(n_dec) if n_hi % decim == 0 else rfft_flops(n_hi)
    ups = 0 if up == 1 else rfft_flops(n_dec) + rfft_flops(n_up)
    flops = (R * (rfft_flops(n_base) + n_base + dec + 6 * n_dec + ups)
             + G * B * (n_up * (C + 1) + n_frames * p["window"]))
    return bound_s(nbytes, flops, e)
