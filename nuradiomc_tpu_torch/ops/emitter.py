"""Artificial emitter (pulser) signal models (torch + numpy host helpers).

Counterpart of ``nuradiomc_tpu/ops/emitter.py`` (reference
NuRadioMC/SignalGen/emitter.py:80-250): the analytic models (delta_pulse,
cw, square, tone_burst, gaussian, efield_delta_pulse) as tensor ops,
elementwise over the batch axes of ``amplitude``, and host-side loaders for
the measured waveforms (idl1, hvsp1, ARA02_calPulser, rno_cal5C_*) and the
SPICE pulser archive. The measured waveforms are the port's own ``.npz``
copies of ``nuradiomc_tpu/data/pulser_waveforms/*.hdf5`` (arrays ``time``
and ``voltage``), so reading them needs no h5py. Export one with h5py:

    python -m nuradiomc_tpu_torch.ops.emitter \\
        nuradiomc_tpu/data/pulser_waveforms/idl1_data.hdf5 \\
        nuradiomc_tpu_torch/data/pulser_waveforms/idl1_data.npz

``_center_component``, ``load_spice_archive``, ``spice_unit_specs`` and
``load_measured_waveform`` are numpy copies of the JAX package's
(emitter.py:83, :101, :122, :163): that module imports jax.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from nuradiomc_tpu_torch.utils import fft

ANALYTIC_MODELS = ("delta_pulse", "cw", "square", "tone_burst", "gaussian",
                   "efield_delta_pulse")

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "data", "pulser_waveforms")
# measured lab waveforms shipped with the package (emitter.py:121-131)
MEASURED_MODELS = {
    "idl1": "idl1_data.npz",
    "hvsp1": "hvsp1_data.npz",
    "ARA02_calPulser": "ARA02_Cal_data.npz",
    "rno_cal5C_0dB": "rno_cal5C_0dB.npz",
    "rno_cal5C_5dB": "rno_cal5C_5dB.npz",
    "rno_cal5C_10dB": "rno_cal5C_10dB.npz",
    "rno_cal5C_15dB": "rno_cal5C_15dB.npz",
    "rno_cal5C_20dB": "rno_cal5C_20dB.npz",
}


def get_measured_time_trace(model: str, amplitude: float, N: int, dt: float) -> np.ndarray:
    """Measured pulser waveform resampled/centered (emitter.py:121-152)."""
    if model not in MEASURED_MODELS:
        raise NotImplementedError(f"no measured waveform for emitter model {model}")
    return load_measured_waveform(os.path.join(_DATA_DIR, MEASURED_MODELS[model]),
                                  amplitude, N, dt)


def _time_axis(N: int, dt: float, like: torch.Tensor):
    return torch.linspace(-(N / 2) * dt, ((N - 1) - N / 2) * dt, N,
                          dtype=like.dtype, device=like.device)


def get_time_trace(amplitude, N: int, dt: float, model: str, *,
                   emitter_frequency=None, half_width=None, polarization=0.5):
    """Voltage trace [..., N] (or 3-component efield [..., 3, N]) of an
    analytic emitter model (emitter.py:50); ``amplitude``,
    ``emitter_frequency`` and ``polarization`` are tensors of one batch
    shape (or scalars)."""
    amplitude = torch.as_tensor(amplitude)
    if not amplitude.is_floating_point():
        amplitude = amplitude.to(torch.get_default_dtype())
    time = _time_axis(N, dt, amplitude)
    amp = amplitude[..., None]

    def like_amp(x):
        return torch.as_tensor(x, dtype=amplitude.dtype, device=amplitude.device)[..., None]

    if model == "delta_pulse":
        return torch.where(torch.arange(N, device=amplitude.device) == N // 2, amp, 0.0)
    if model == "cw":
        return amp * torch.sin(2 * math.pi * like_amp(emitter_frequency) * time)
    if model in ("square", "tone_burst"):
        box = torch.where((time >= -half_width) & (time <= half_width), amp, 0.0)
        if model == "square":
            return box
        return box * torch.sin(2 * math.pi * like_amp(emitter_frequency) * time)
    if model == "gaussian":
        sigma = half_width / math.sqrt(2 * math.log(2.0))
        trace = torch.exp(-0.5 * ((time - 500) / sigma) ** 2)
        return amp * trace / torch.amax(torch.abs(trace))
    if model == "efield_delta_pulse":
        pol = like_amp(polarization)
        at_peak = torch.arange(N, device=amplitude.device) == N // 2
        zero = torch.zeros_like(amp)
        return torch.stack([
            zero.expand(*amplitude.shape, N),
            torch.where(at_peak, (1.0 - pol) ** 0.5 * amp, zero),
            torch.where(at_peak, pol ** 0.5 * amp, zero)], dim=-2)
    raise NotImplementedError(
        f"emitter model {model} unknown or requires measured-waveform data files")


def get_frequency_spectrum(amplitude, N: int, dt: float, model: str, **kwargs):
    """NuRadioMC-normalized spectrum of the emitter trace."""
    return fft.time2freq(get_time_trace(amplitude, N, dt, model, **kwargs), 1.0 / dt)


# copied from nuradiomc_tpu/ops/emitter.py:83 (_center_component)
def _center_component(v: np.ndarray, N: int) -> np.ndarray:
    """Center a measured component on the grid the reference's way
    (emitter.py:205-237): longer traces are peak-rolled to the middle then
    truncated around it; shorter ones zero-padded symmetrically (+1 left
    for odd parity); finally the peak is rolled exactly to N//2."""
    if len(v) > N:
        peak = int(np.flatnonzero(np.abs(v) == np.max(np.abs(v)))[0])
        v = np.roll(v, len(v) // 2 - peak)
        lo = int(len(v) / 2 - N / 2)
        out = v[lo:lo + N]
    else:
        pad = int((N - len(v)) / 2)
        adj = 1 if (N + len(v)) % 2 != 0 else 0
        out = np.pad(v, (pad + adj, pad))
    peak = int(np.flatnonzero(np.abs(out) == np.max(np.abs(out)))[0])
    return np.roll(out, N // 2 - peak)


# copied from nuradiomc_tpu/ops/emitter.py:101 (load_spice_archive)
def load_spice_archive(path: str) -> dict:
    """Load the SPICE pulse archive (SPice_pulses.xz: lzma-compressed pickle
    with 'efields' {launch_angle_deg: [pulse (2, n), ...]} and
    'sampling_rate'; emitter.py:159-170). The published archive ships with
    the reference under SignalProp/examples/birefringence_examples/
    extra_files/; pass its path."""
    import lzma
    import pickle

    if not os.path.exists(path):
        raise FileNotFoundError(
            f"SPICE pulse archive not found at {path}. Download "
            "SPice_pulses.xz (reference: SignalProp/examples/"
            "birefringence_examples/extra_files/SPice_pulses.xz) and drop "
            "it there, or pass spice_pulses_path=.")
    with lzma.open(path, "r") as f:
        return pickle.load(f)


# copied from nuradiomc_tpu/ops/emitter.py:122 (spice_unit_specs)
def spice_unit_specs(archive: dict, N: int, dt: float, iN=0, rng=None):
    """Per-launch-angle unit-amplitude (eTheta, ePhi) spectra of the SPICE
    pulser (emitter.py:159-250, model 'efield_idl1_spice').

    The reference picks ONE measured pulse per efield call (kwargs iN, or a
    random draw), Fourier-resamples it to the target rate, centers each
    component's peak at N//2 and scales by the event amplitude. Amplitude
    is linear, so everything per-angle is precomputed here once:
    returns (angles_rad [A] ascending, unit_specs [A, 2, F] complex) with
    the NuRadioMC rfft normalization (time2freq). ``iN`` selects the pulse
    (int, or per-angle via ``rng.integers`` when a numpy Generator is
    given).
    """
    from scipy.signal import resample as _fft_resample

    from nuradiomc_tpu_torch.utils import units as u

    sr = float(archive["sampling_rate"])
    keys = sorted(archive["efields"].keys(), key=float)
    angles, specs = [], []
    for key in keys:
        pulses = archive["efields"][key]
        i = int(rng.integers(0, len(pulses))) if rng is not None else int(iN)
        if i >= len(pulses):
            raise ValueError(f"the selected pulse iN {i} is out of range. "
                             f"Only {len(pulses)} pulses at angle {key}")
        th = np.asarray(pulses[i][0], float)
        ph = np.asarray(pulses[i][1], float)
        # ElectricField.resample: FFT resampling to 1/dt, even length
        n_out = int(round(len(th) * (1.0 / dt) / sr))
        if n_out % 2 != 0:
            n_out += 1
        th = _fft_resample(th, n_out)
        ph = _fft_resample(ph, n_out)
        comp = np.stack([_center_component(th, N), _center_component(ph, N)])
        angles.append(float(key) * u.deg)
        specs.append(np.fft.rfft(comp, axis=-1) * dt * np.sqrt(2.0))
    return np.asarray(angles), np.asarray(specs)


def _read_waveform(path: str):
    """(time, voltage) of a measured-waveform file: the ``.npz`` copy, or
    the HDF5 original (needs h5py)."""
    if str(path).endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return z["time"], z["voltage"]
    import h5py
    with h5py.File(path, "r") as f:
        return np.asarray(f["time"]), np.asarray(f["voltage"])


# copied from nuradiomc_tpu/ops/emitter.py:163 (load_measured_waveform); the
# file is read by _read_waveform
def load_measured_waveform(path: str, amplitude: float, N: int, dt: float) -> np.ndarray:
    """Host-side loader for measured pulser waveforms (idl1/hvsp1/ARA02/rno_*
    files with 'time'/'voltage'): cubic interpolation to the target rate,
    center the peak, normalize to ``amplitude`` (emitter.py:121-152)."""
    from scipy.interpolate import interp1d

    t0, v0 = _read_waveform(path)
    t_new = np.linspace(t0[0], t0[-1], int((t0[-1] - t0[0]) / dt) + 1)
    v_new = interp1d(t0, v0, kind="cubic")(t_new)
    if len(v_new) > N:
        peak = int(np.argmax(np.abs(v_new)))
        v_new = np.roll(v_new, len(v_new) // 2 - peak)
        lo = len(v_new) // 2 - N // 2
        trace = v_new[lo:lo + N]
    else:
        pad = (N - len(v_new)) // 2
        adj = 1 if (N + len(v_new)) % 2 != 0 else 0
        trace = np.pad(v_new, (pad + adj, pad))
    trace = amplitude * trace / np.max(np.abs(trace))
    peak = int(np.argmax(np.abs(trace)))
    return np.roll(trace, N // 2 - peak)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m nuradiomc_tpu_torch.ops.emitter IN.hdf5 OUT.npz",
              file=sys.stderr)
        return 2
    t, v = _read_waveform(argv[0])
    np.savez_compressed(argv[1], time=t, voltage=v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
