"""Module convention of the reconstruction modules (torch).

Counterpart of ``nuradiomc_tpu/reco/base.py``: ``begin()`` / ``run(evt,
station, det, ...)`` / ``end()`` with provenance registration
(NuRadioReco/modules/base/module.py:34-118). The event data model stays host
numpy; each module's array work (FFTs and filters over traces, tables,
correlation stacks, beam scores, fit grids, the IFT optimisation) runs as
tensors on the device the module was made for: ``Module(device=...)``, the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils import fft


# copied from nuradiomc_tpu/reco/base.py:10-28
def register_run():
    """Decorator recording each module invocation into the Event, so the
    processing history (and e.g. applied filters) can be replayed
    (base/module.py:34-118, Event.iter_modules)."""

    def decorator(run_fn):
        @functools.wraps(run_fn)
        def wrapper(self, evt, station=None, det=None, *args, **kwargs):
            name = type(self).__name__
            if evt is not None and hasattr(evt, "register_module_station"):
                sid = station.get_id() if station is not None else None
                if sid is not None:
                    evt.register_module_station(sid, self, name, kwargs)
                else:
                    evt.register_module_event(self, name, kwargs)
            return run_fn(self, evt, station, det, *args, **kwargs)

        return wrapper

    return decorator


class Module:
    """Base of the port's modules: the device their array work runs on
    (``"cuda"`` by default; without a card that default raises)."""

    def __init__(self, device=device_util.DEFAULT):
        self.device = device_util.resolve(device)

    def tensor(self, x, dtype=None) -> torch.Tensor:
        """A host array (or number) as a tensor on the module's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device) if dtype is None else x.to(self.device, dtype)
        x = np.asarray(x)
        if dtype is None and x.dtype.kind == "f":
            dtype = torch.float64
        elif dtype is None and x.dtype.kind == "c":
            dtype = torch.complex128
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def begin(self, *args, **kwargs):
        pass

    def end(self):
        pass


def host(x) -> np.ndarray:
    """A tensor back on the host as numpy."""
    return x.detach().cpu().resolve_conj().resolve_neg().numpy()


def trace_tensor(bt, device) -> torch.Tensor:
    """The time trace of a BaseTrace as a tensor on ``device``; a trace held
    as a spectrum is transformed there."""
    if bt.is_time_domain():
        return torch.as_tensor(np.asarray(bt.get_trace(), dtype=float), device=device)
    spec = torch.as_tensor(np.asarray(bt.get_frequency_spectrum()), device=device)
    return fft.freq2time(spec, bt.get_sampling_rate())


def spectrum_tensor(bt, device) -> torch.Tensor:
    """The spectrum of a BaseTrace as a tensor on ``device``; a trace held in
    the time domain is transformed there."""
    if bt.is_time_domain():
        tr = torch.as_tensor(np.asarray(bt.get_trace(), dtype=float), device=device)
        return fft.time2freq(tr, bt.get_sampling_rate())
    return torch.as_tensor(np.asarray(bt.get_frequency_spectrum()), device=device)


def same_grid(bts):
    """``bts`` (channels, efields) in lists of one number of samples and
    sampling rate, in their order within each list: the batches that stack
    into one tensor."""
    groups = {}
    for bt in bts:
        groups.setdefault((bt.get_number_of_samples(), bt.get_sampling_rate()), []).append(bt)
    return list(groups.values())


def stack_traces(bts, device) -> torch.Tensor:
    """[N, n] time traces of BaseTraces of one length and sampling rate on
    ``device``: the stored arrays stacked on the host and moved in one copy,
    those held as spectra transformed there in one batch."""
    if all(bt.is_time_domain() for bt in bts):
        return torch.as_tensor(np.array([bt.get_trace() for bt in bts], dtype=float),
                               device=device)
    if not any(bt.is_time_domain() for bt in bts):
        spec = torch.as_tensor(np.array([bt.get_frequency_spectrum() for bt in bts]),
                               device=device)
        return fft.freq2time(spec, bts[0].get_sampling_rate())
    return torch.stack([trace_tensor(bt, device) for bt in bts])


def stack_spectra(bts, device) -> torch.Tensor:
    """[N, F] spectra of BaseTraces of one length and sampling rate on
    ``device``, as :func:`stack_traces` moves them."""
    if not any(bt.is_time_domain() for bt in bts):
        return torch.as_tensor(np.array([bt.get_frequency_spectrum() for bt in bts]),
                               device=device)
    if all(bt.is_time_domain() for bt in bts):
        return fft.time2freq(stack_traces(bts, device), bts[0].get_sampling_rate())
    return torch.stack([spectrum_tensor(bt, device) for bt in bts])


def correlate_full(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``scipy.signal.correlate(a, b, 'full')`` of two real 1-D traces by the
    direct sum scipy picks at these lengths: out[k] = sum_n a[n + k - (M-1)] b[n],
    as one matrix-vector product over the sliding windows."""
    m = b.shape[-1]
    padded = torch.nn.functional.pad(a, (m - 1, m - 1))
    return padded.unfold(-1, m, 1) @ b


CPU_CHUNK_BYTES = 1 << 30


def rows_per_chunk(bytes_per_row: float, device, n_rows: int) -> int:
    """How many rows of a batched grid program to run at once: half the free
    device memory (``torch.cuda.mem_get_info``) over the bytes one row takes,
    ``CPU_CHUNK_BYTES`` on the CPU; at least 1, at most ``n_rows``."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = 0.5 * free
    else:
        budget = CPU_CHUNK_BYTES
    return int(max(1, min(n_rows, budget // bytes_per_row)))
