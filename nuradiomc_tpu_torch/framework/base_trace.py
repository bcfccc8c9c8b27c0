# copied from nuradiomc_tpu/framework/base_trace.py:1-165, with is_time_domain added (the port keeps
# its own copy; it imports nothing of the JAX package)
"""BaseTrace: lazy dual time/frequency trace container.

Re-implementation of NuRadioReco/framework/base_trace.py:16-568 with the same
semantics: a trace is stored in whichever domain it was last set, converted
lazily with the framework FFT normalization; even sample counts enforced;
sub-bin time shifts as linear phases; FFT resampling; windowed add_to_trace.
Host-side numpy (this is the user-facing object API; batched device pipelines
use ops.trace instead).
"""

from __future__ import annotations

import numpy as np

from nuradiomc_tpu_torch.utils import units


def _time2freq(trace, fs):
    return np.fft.rfft(trace, axis=-1) / fs * np.sqrt(2.0)


def _freq2time(spec, fs, n=None):
    return np.fft.irfft(spec, axis=-1, n=n) * fs / np.sqrt(2.0)


class BaseTrace:
    def __init__(self, trace=None, sampling_rate=None, trace_start_time=0.0):
        self._time_trace = None
        self._frequency_spectrum = None
        self.__time_domain_up_to_date = True
        self._sampling_rate = sampling_rate
        self._trace_start_time = trace_start_time
        if trace is not None:
            self.set_trace(trace, sampling_rate)

    # -- setters / getters ---------------------------------------------------

    def set_trace(self, trace, sampling_rate, trace_start_time=None):
        if trace is not None:
            trace = np.asarray(trace)
            if trace.shape[-1] % 2 != 0:
                raise ValueError(
                    f"the trace needs an even number of samples, got {trace.shape[-1]}")
        self._time_trace = trace
        self._sampling_rate = sampling_rate
        self._frequency_spectrum = None
        self.__time_domain_up_to_date = True
        if trace_start_time is not None:
            self._trace_start_time = trace_start_time

    def set_frequency_spectrum(self, frequency_spectrum, sampling_rate):
        self._frequency_spectrum = np.asarray(frequency_spectrum)
        if sampling_rate is not None:
            self._sampling_rate = sampling_rate
        self._time_trace = None
        self.__time_domain_up_to_date = False

    def get_trace(self):
        if not self.__time_domain_up_to_date:
            self._time_trace = _freq2time(self._frequency_spectrum, self._sampling_rate)
            self.__time_domain_up_to_date = True
        return self._time_trace

    def get_frequency_spectrum(self):
        if self.__time_domain_up_to_date:
            if self._time_trace is None:
                return None
            self._frequency_spectrum = _time2freq(self._time_trace, self._sampling_rate)
            self.__time_domain_up_to_date = False
            self._time_trace = None
        return self._frequency_spectrum

    def is_time_domain(self) -> bool:
        """True when the trace is held in the time domain (the port's
        reconstruction modules transform it on their device)."""
        return self.__time_domain_up_to_date

    def get_sampling_rate(self):
        return self._sampling_rate

    def get_trace_start_time(self):
        return self._trace_start_time

    def set_trace_start_time(self, t):
        self._trace_start_time = t

    def add_trace_start_time(self, t):
        self._trace_start_time += t

    def get_number_of_samples(self) -> int:
        if self.__time_domain_up_to_date and self._time_trace is not None:
            return self._time_trace.shape[-1]
        return 2 * (self._frequency_spectrum.shape[-1] - 1)

    def get_times(self):
        n = self.get_number_of_samples()
        return np.arange(n) / self._sampling_rate + self._trace_start_time

    def get_frequencies(self):
        n = self.get_number_of_samples()
        return np.fft.rfftfreq(n, 1.0 / self._sampling_rate)

    def get_hilbert_envelope(self):
        from scipy.signal import hilbert
        return np.abs(hilbert(self.get_trace(), axis=-1))

    def get_hilbert_envelope_mag(self):
        return np.linalg.norm(self.get_hilbert_envelope(), axis=0)

    # -- operations ----------------------------------------------------------

    def apply_time_shift(self, delta_t, silent=False):
        """Sub-bin Fourier time shift (base_trace.py:246-277)."""
        spec = self.get_frequency_spectrum()
        ff = self.get_frequencies()
        self.set_frequency_spectrum(spec * np.exp(-2j * np.pi * ff * delta_t),
                                    self._sampling_rate)

    def resample(self, sampling_rate):
        """FFT resampling (base_trace.py:278-307 / scipy.signal.resample)."""
        if sampling_rate == self._sampling_rate:
            return
        n_in = self.get_number_of_samples()
        n_out = int(round(n_in * sampling_rate / self._sampling_rate))
        if n_out % 2 != 0:
            n_out += 1
        from scipy.signal import resample
        resampled = resample(self.get_trace(), n_out, axis=-1)
        self.set_trace(resampled, sampling_rate)

    def add_to_trace(self, channel, min_residual_time_offset=1e-5 * units.ns):
        """Add a (shorter) trace into this one, aligned by start times with a
        sub-bin phase shift (base_trace.py:308-400)."""
        fs = self._sampling_rate
        t0 = self.get_trace_start_time()
        trace = np.array(self.get_trace())
        other_t0 = channel.get_trace_start_time()
        n_other = channel.get_number_of_samples()
        offset = other_t0 - t0
        i_start = int(round(offset * fs))
        residual = offset - i_start / fs
        tmp = BaseTrace(np.array(channel.get_trace()), fs,
                        channel.get_trace_start_time())
        if abs(residual) > min_residual_time_offset:
            tmp.apply_time_shift(residual)
        other_trace = tmp.get_trace()
        lo = max(i_start, 0)
        hi = min(i_start + n_other, trace.shape[-1])
        if hi > lo:
            trace[..., lo:hi] += other_trace[..., lo - i_start:hi - i_start]
        self.set_trace(trace, fs, trace_start_time=t0)

    def __add__(self, other):
        out = BaseTrace(np.array(self.get_trace()), self._sampling_rate,
                        self._trace_start_time)
        out.add_to_trace(other)
        return out

    def serialize(self):
        import pickle
        return pickle.dumps({
            "trace": self.get_trace(),
            "sampling_rate": self._sampling_rate,
            "trace_start_time": self._trace_start_time,
        }, protocol=4)

    def deserialize(self, data):
        import pickle
        d = pickle.loads(data)
        self.set_trace(d["trace"], d["sampling_rate"], d["trace_start_time"])
