"""Phased-array trigger-efficiency (SNR) curves.

Counterpart of ``examples/07_snr_curves/run_snr_curves.py`` (NuRadioReco's
examples/PhasedArray/SNR_curves/T02RunSNR.py): an Alvarez2000 pulse 1 deg off
the Cherenkov cone, band-limited, rescaled to 20 SNR values from 0.5 to 4
(SNR = Vpp / (2 Vrms), Vrms 10 mV) with thermal noise on each of 200 trials
(or the argument's count) through the 4-channel deep phased array (11 beams,
32-sample windows at steps of 16); the power threshold is tuned to a 10 kHz
noise-trigger rate on 8192 noise traces (``sim/noise_rate.py``). The whole
study is plain torch operations on the device (the JAX example's are plain
``jnp``), float32; the noise comes from the port's generators, so the curve
is held to the JAX example's statistically. Saves ``snr_curve.npz`` into
``outdir`` (the JAX example writes it into its own source directory)::

    python -m nuradiomc_tpu_torch.examples.e07_snr_curves.run_snr_curves [n_trials]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.ops import askaryan, filters, noise as noise_ops, phased_array
from nuradiomc_tpu_torch.sim import noise_rate
from nuradiomc_tpu_torch.utils import fft, units

N_SNR = 20
SNRS = np.linspace(0.5, 4.0, N_SNR)
FS = 1.0                       # detector rate, GHz
N_SAMPLES = 512
N_CHANNELS = 4
N_INDEX = 1.78
VRMS = 10 * units.mV
WINDOW, STEP = 32, 16
SEED = 0


def study_setup():
    """(signal [C, N], band [F], noise amplitude, rolls, factor for SNR 1):
    the example's host-side set-up, in float64 numpy."""
    ant_z = -97.0 - np.arange(N_CHANNELS)
    f64 = torch.float64
    trace = askaryan.get_time_trace(
        torch.tensor(1e18, dtype=f64), torch.tensor(np.arccos(1.0 / N_INDEX) + np.deg2rad(1.0)),
        N_SAMPLES, 1.0 / FS, torch.tensor(False), torch.tensor(N_INDEX, dtype=f64),
        torch.tensor(1000.0, dtype=f64), "Alvarez2000").numpy()
    ff = np.fft.rfftfreq(N_SAMPLES, 1.0 / FS)
    band = filters.get_filter_response(ff, (96 * units.MHz, 100 * units.GHz), "butter",
                                       order=4) \
        * filters.get_filter_response(ff, (0, 220 * units.MHz), "butter", order=7)
    sig = fft.freq2time(fft.time2freq(torch.as_tensor(trace), FS) * torch.as_tensor(band),
                        FS, n=N_SAMPLES).numpy()
    signal = np.tile(sig, (N_CHANNELS, 1))          # a plane wave at the beam centre
    base_factor = VRMS / (0.5 * (signal.max() - signal.min()))
    fine = np.linspace(0, FS / 2, 10000)
    resp = filters.get_filter_response(fine, (96 * units.MHz, 100 * units.GHz), "butter",
                                       order=4) \
        * filters.get_filter_response(fine, (0, 220 * units.MHz), "butter", order=7)
    bandwidth = np.trapezoid(np.abs(resp) ** 2, fine)
    amp = VRMS / np.sqrt(bandwidth / (0.5 * FS))
    rolls = np.asarray(phased_array.beam_rolls(
        ant_z, np.zeros(N_CHANNELS), np.arcsin(np.linspace(-0.55, 0.55, 11)),
        ref_index=N_INDEX, sampling_frequency=FS), dtype=int)
    return signal, band, amp, rolls, base_factor


def snr_curve(n_trials, threshold, device, dtype, generator):
    """Trigger efficiency [N_SNR] over ``n_trials`` noise realizations per
    SNR value, all in one batch on ``device``."""
    signal, band, amp, rolls, base_factor = study_setup()
    spec = noise_ops.bandlimited_noise_spectrum(
        generator, (N_SNR, n_trials, N_CHANNELS), N_SAMPLES, FS, amp, None, FS / 2,
        "rayleigh", dtype)
    band_t = torch.as_tensor(band, device=device).to(spec.dtype)
    noise = fft.freq2time(spec * band_t, FS, n=N_SAMPLES)
    factors = torch.as_tensor(SNRS * base_factor, dtype=dtype, device=device)
    traces = torch.as_tensor(signal, dtype=dtype, device=device) * factors[:, None, None, None] \
        + noise
    trig, _, _, _ = phased_array.phased_power_trigger(traces, rolls, threshold, WINDOW, STEP)
    return trig.to(dtype).mean(dim=1).cpu().numpy()


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("n_trials", nargs="?", type=int, default=200)
    args = p.parse_args(argv)
    device, dtype = _common.setup(args, device, dtype, torch.float32, outdir)
    signal, band, amp, rolls, _ = study_setup()
    max_powers = noise_rate.run_phased_array_tuning(
        8192, N_SAMPLES, FS, amp, band, rolls, N_CHANNELS, WINDOW, STEP, seed=1, batch=2048,
        device=device, dtype=dtype)
    trace_duration = N_SAMPLES / FS
    threshold = noise_rate.tune_threshold(10 * units.kHz, max_powers, trace_duration)
    print(f"threshold tuned to 10 kHz noise rate: {threshold / VRMS ** 2:.2f} Vrms^2")

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    eff = snr_curve(args.n_trials, threshold, device, dtype, gen)
    print("SNR   efficiency")
    for s, e in zip(SNRS, eff):
        print(f"{s:4.2f}  {e:5.3f}  {'#' * int(round(e * 40))}")
    np.savez(os.path.join(outdir, "snr_curve.npz"), SNRs=SNRS, efficiency=eff,
             total_events=args.n_trials)
    if not (eff[0] < 0.3 and eff[-1] > 0.8):
        raise RuntimeError("the SNR curve should rise from ~0 to ~1")
    if not np.all(np.diff(np.convolve(eff, np.ones(3) / 3, mode="valid")) > -0.15):
        raise RuntimeError("the smoothed SNR curve falls by more than 0.15")
    print("saved snr_curve.npz")
    return {"threshold": threshold, "threshold_vrms2": threshold / VRMS ** 2,
            "efficiency": eff, "snrs": SNRS, "n_trials": args.n_trials}


if __name__ == "__main__":
    main()
