"""An aliased (higher-Nyquist-zone) phased-array SNR study.

Counterpart of ``examples/14_alias_phased_array/run_alias_snr.py``
(NuRadioReco's examples/AliasPhasedArray/SNR_study/T02SNRNyquist.py): a
trigger ADC at 0.5 GHz undersamples the 132-700 MHz band, so a band placed in
the z-th Nyquist zone folds into the first, where the beamformed power
trigger still works. Per zone z = 1, 2, 3: the analog band (Butterworth 8 /
10), the zone filter [(z-1) fs/2 + 20 MHz, z fs/2 - 20 MHz], decimation of
the 5 GHz grid to the ADC rate, x4 FFT upsampling, 30 beams over +-50 deg and
16 ns power windows at steps of 8 ns; the efficiency over 16 SNR values from
0.5 to 6 with 120 noise realizations each (or the argument's count), at a
threshold set to the 0.999 quantile of 256 noise-only traces. Plain torch
operations on the device, as the JAX example's are plain ``jnp``, in
float64; the noise comes from the port's generators, so each zone is held to
the JAX example's statistically. Saves ``alias_snr.npz`` into ``outdir``::

    python -m nuradiomc_tpu_torch.examples.e14_alias_phased_array.run_alias_snr [n_trials]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.ops import askaryan, filters, noise as noise_ops, phased_array
from nuradiomc_tpu_torch.sim import noise_rate
from nuradiomc_tpu_torch.utils import fft, units

N_SNR = 16
SNRS = np.linspace(0.5, 6.0, N_SNR)
FS_HI = 5.0                    # internal rate, GHz
N_HI = 4096
FS_ADC = 0.5                   # trigger-ADC rate
UPSAMPLING = 4
EDGE = 20 * units.MHz
LOW, HIGH = 132 * units.MHz, 700 * units.MHz
N_CHANNELS = 4
N_INDEX = 1.75
VRMS = 10 * units.mV
DECIM = int(round(FS_HI / FS_ADC))
WINDOW = int(16 * units.ns * FS_ADC * UPSAMPLING)
STEP = int(8 * units.ns * FS_ADC * UPSAMPLING)
N_NOISE = 256                  # noise-only traces per zone for the threshold
SEED = 42


def study_setup():
    """(signal [C, N_HI], analog response [F], noise amplitude, rolls,
    factor for SNR 1) in float64 numpy."""
    f64 = torch.float64
    trace = askaryan.get_time_trace(
        torch.tensor(1e18, dtype=f64), torch.tensor(np.arccos(1.0 / N_INDEX) + np.deg2rad(1.0)),
        N_HI, 1.0 / FS_HI, torch.tensor(False), torch.tensor(N_INDEX, dtype=f64),
        torch.tensor(1000.0, dtype=f64), "Alvarez2000").numpy()
    ff = np.fft.rfftfreq(N_HI, 1.0 / FS_HI)
    analog = filters.get_filter_response(ff, (LOW, 1150 * units.MHz), "butter", order=8) \
        * filters.get_filter_response(ff, (0, HIGH), "butter", order=10)
    sig = fft.freq2time(fft.time2freq(torch.as_tensor(trace), FS_HI) * torch.as_tensor(analog),
                        FS_HI, n=N_HI).numpy()
    base_factor = VRMS / (0.5 * (sig.max() - sig.min()))
    band_power = np.trapezoid(np.abs(analog) ** 2, ff) / (FS_HI / 2)
    rolls = phased_array.beam_rolls(
        -100.0 - np.arange(N_CHANNELS), np.zeros(N_CHANNELS),
        np.arcsin(np.linspace(np.sin(np.deg2rad(-50.0)), np.sin(np.deg2rad(50.0)), 30)),
        N_INDEX, FS_ADC * UPSAMPLING)
    return np.tile(sig, (N_CHANNELS, 1)), analog, VRMS / np.sqrt(band_power), rolls, base_factor


def max_beam_power(traces, mask, rolls):
    """Analog traces [..., C, N_HI] -> zone filter -> undersampling ->
    x4 upsampling -> beams -> the maximum windowed power [...]."""
    tr_z = torch.fft.irfft(torch.fft.rfft(traces) * mask, n=N_HI)[..., ::DECIM]
    n_adc = tr_z.shape[-1]
    tr_up = torch.fft.irfft(torch.fft.rfft(tr_z), n=n_adc * UPSAMPLING) * UPSAMPLING
    power, _ = phased_array.power_sum(phased_array.phase_signals(tr_up, rolls), WINDOW, STEP)
    return power.amax(dim=(-2, -1))


def zone_mask(z, device, dtype):
    """The analog response times zone ``z``'s filter [F] on ``device``."""
    _, analog, _, _, _ = study_setup()
    ff = np.fft.rfftfreq(N_HI, 1.0 / FS_HI)
    lo, hi = (z - 1) * FS_ADC / 2 + EDGE, z * FS_ADC / 2 - EDGE
    mask = torch.as_tensor(((ff >= lo) & (ff <= hi)) * analog, device=device)
    return mask.to(torch.complex128 if dtype == torch.float64 else torch.complex64)


def draws(z, n_trials, device, dtype):
    """Zone ``z``'s noise: (trials [T, C, N_HI], noise-only traces
    [N_NOISE, C, N_HI]), each from its own generator."""
    _, _, noise_amp, _, _ = study_setup()

    def noise(chunk, n):
        return noise_ops.bandlimited_noise_trace(
            noise_rate.chunk_generator(SEED, chunk, device), (n, N_CHANNELS), N_HI, FS_HI,
            noise_amp, None, None, "rayleigh", dtype)

    return noise(2 * z, n_trials), noise(2 * z + 1, N_NOISE)


def zone_powers(z, trials, noise):
    """(max power [T, N_SNR] of the SNR ladder on ``trials``, max power
    [N_NOISE] of ``noise``) in zone ``z``."""
    signal, _, _, rolls, base_factor = study_setup()
    mask = zone_mask(z, trials.device, trials.dtype)
    sig = torch.as_tensor(signal, dtype=trials.dtype, device=trials.device)
    factors = torch.as_tensor(SNRS * base_factor, dtype=trials.dtype, device=trials.device)
    max_power = torch.stack([max_beam_power(sig * f + trials, mask, rolls) for f in factors],
                            dim=1)
    return max_power, max_beam_power(noise, mask, rolls)


def efficiency(max_power, noise_powers):
    """(efficiency [N_SNR], threshold): the fraction of trials above the
    0.999 quantile of the noise-only maxima."""
    threshold = float(np.quantile(np.asarray(noise_powers), 0.999))
    return (np.asarray(max_power) > threshold).mean(axis=0), threshold


def snr50(eff):
    """The SNR at 50% efficiency (inf where the curve stays below)."""
    return float(np.interp(0.5, eff, SNRS)) if eff.max() >= 0.5 else np.inf


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("n_trials", nargs="?", type=int, default=120)
    args = p.parse_args(argv)
    device, dtype = _common.setup(args, device, dtype, torch.float64, outdir)
    results, snr50s, thresholds, maxima = {}, {}, {}, {}
    for z in (1, 2, 3):
        max_power, noise_powers = zone_powers(z, *draws(z, args.n_trials, device, dtype))
        maxima[z] = max_power.cpu().numpy()
        eff, thr = efficiency(maxima[z], noise_powers.cpu().numpy())
        results[z], thresholds[z], snr50s[z] = eff, thr, snr50(eff)
        print(f"Nyquist zone {z}: threshold={thr:.3g} V^2, "
              f"eff@SNR6={eff[-1]:.2f}, SNR50={snr50s[z]:.2f}")
        print("  eff:", np.round(eff, 2))
    np.savez(os.path.join(outdir, "alias_snr.npz"), snrs=SNRS,
             **{f"zone_{z}": results[z] for z in results})
    print("alias phased-array study done")
    return {"efficiency": results, "snr50": snr50s, "thresholds": thresholds,
            "max_power": maxima, "snrs": SNRS, "n_trials": args.n_trials}


if __name__ == "__main__":
    main()
