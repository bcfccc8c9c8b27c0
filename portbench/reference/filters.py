# frozen copy of nuradiomc_tpu_torch/ops/filters.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
# copied from nuradiomc_tpu/ops/filters.py:1-120 (the port keeps its own copy; it imports nothing of the JAX package)
"""Frequency-domain filter responses.

Mirrors NuRadioReco/utilities/signal_processing.get_filter_response:237-330.
Filter responses are static per detector configuration, so they are computed
once on the host (scipy analog prototypes, exactly as the reference) and
shipped to the device as complex arrays — the device-side "filter" is a single
fused multiply in the rFFT-domain signal chain.
"""

from __future__ import annotations

import numpy as np
from scipy import signal


def fir_taps(passband, filter_type: str, order: int, fs: float) -> np.ndarray:
    """scipy.signal.firwin taps exactly as the reference builds them
    (channelBandPassFilter.py:247-283): ``filter_type`` is "FIR [window
    [beta]]"; low/high/band-pass/band-stop selected from the passband
    (passband[0] > passband[1] means band-stop), scale=False.
    """
    parts = filter_type.split()
    wtype = parts[1] if len(parts) > 1 else "hamming"
    if isinstance(wtype, str) and wtype.find("kaiser") >= 0:
        beta = float(parts[2]) if len(parts) > 2 else 6.0
        wtype = ("kaiser", beta)
    n_fir = order + 1
    if passband[0] is None or passband[0] == 0:
        pass_zero, fcut = True, passband[1]
    elif passband[1] is None or passband[1] / fs >= 0.5:
        pass_zero, fcut = False, passband[0]
    elif passband[1] > passband[0]:
        pass_zero, fcut = False, list(passband)
    else:
        pass_zero, fcut = True, [passband[1], passband[0]]
    return signal.firwin(n_fir, fcut, window=wtype, scale=False,
                         pass_zero=pass_zero, fs=fs)


def get_filter_response(frequencies: np.ndarray, passband, filter_type: str,
                        order: int = 2, rp=None, roll_width=None,
                        fs=None) -> np.ndarray:
    """Complex filter response on ``frequencies`` (internal units, GHz).

    ``fs`` (sampling rate) is required only for the "FIR*" types, whose taps
    depend on it.
    """
    frequencies = np.asarray(frequencies, dtype=float)

    if isinstance(filter_type, str) and filter_type.startswith("FIR"):
        # Frequency response of the linear-phase firwin FIR the reference
        # applies in the time domain (channelBandPassFilter.py:247-290,
        # lfilter + np.roll(-ndelay) group-delay compensation). In the
        # declarative rFFT chain this is the exact circular-convolution
        # equivalent: H(f) = sum_k taps_k e^{-2 pi i f k/fs} advanced by the
        # ndelay compensation phase.
        if fs is None:
            raise ValueError("FIR filter types need fs (sampling rate)")
        taps = fir_taps(passband, filter_type, order, fs)
        ndelay = (len(taps) - 1) // 2
        k = np.arange(len(taps)) - ndelay
        return np.exp(-2j * np.pi * np.outer(frequencies / fs, k)) @ taps

    if filter_type == "rectangular":
        mask = (passband[0] <= frequencies) & (frequencies <= passband[1])
        return np.where(mask, 1.0 + 0j, 0.0 + 0j)

    if passband[0] == 0:
        scipy_args = [passband[1], "lowpass"]
    else:
        scipy_args = [list(passband), "bandpass"]

    if filter_type in ("butter", "butterabs"):
        f = np.zeros_like(frequencies, dtype=complex)
        mask = frequencies > 0
        b, a = signal.butter(order, *scipy_args, analog=True)
        _, h = signal.freqs(b, a, frequencies[mask])
        f[mask] = h
        return np.abs(f).astype(complex) if filter_type == "butterabs" else f

    if filter_type == "cheby1":
        f = np.zeros_like(frequencies, dtype=complex)
        mask = frequencies > 0
        b, a = signal.cheby1(order, rp, *scipy_args, analog=True)
        _, h = signal.freqs(b, a, frequencies[mask])
        f[mask] = h
        return f

    if filter_type == "gaussian_tapered":
        f = np.ones_like(frequencies, dtype=complex)
        f[frequencies < passband[0]] = 0.0
        f[frequencies > passband[1]] = 0.0
        gaussian_weights = signal.windows.gaussian(
            len(frequencies), int(round(roll_width / (frequencies[1] - frequencies[0]))))
        f = np.convolve(np.abs(f), gaussian_weights / np.sum(gaussian_weights), mode="same")
        return f.astype(complex)

    raise NotImplementedError(f"filter type {filter_type} not implemented")


def chain_response(frequencies: np.ndarray, chain, fs=None) -> np.ndarray:
    """Product of a list of (passband, filter_type, kwargs) filter stages.

    This is the declarative replacement for the reference's
    ``_detector_simulation_filter_amp`` hook + get_filter provenance replay
    (simulation.py:1302-1315): the signal chain is declared once, its combined
    response is precomputed here. ``fs`` is needed only for "FIR*" stages.
    """
    resp = np.ones_like(frequencies, dtype=complex)
    for passband, filter_type, kwargs in chain:
        if str(filter_type).startswith("FIR"):
            kwargs = dict(kwargs, fs=kwargs.get("fs", fs))
        resp *= get_filter_response(frequencies, passband, filter_type, **kwargs)
    return resp
