# copied from nuradiomc_tpu/reco/ara_io.py:1-237 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""ARA raw-data access: the ``readARAData`` reader with pluggable dataset
backends.

Re-implementation of the reference's
NuRadioReco/modules/io/araroot/readARAData.py:26-127. The reference reads
ARA .root files through pyroot plus the compiled AraRoot libraries
(libAraEvent/libAraConfig/..., readARAData.py:18-24) and pulls calibrated
waveforms out of ``UsefulAtriStationEvent.getGraphFromRFChan`` (:108-111).
Neither ROOT nor AraRoot is distributable here, so the event loop is
backend-independent:

* `AraRootDataset` is an import-gated adapter that drives the real
  AraRoot chain when pyroot + AraRoot are installed (same TFile/eventTree/
  RawAtriStationEvent/kLatestCalib sequence as readARAData.begin:52-62);
* `NumpyAraDataset` reads the same per-event content from a single
  ``.npz`` export (`write_numpy_dataset`) that a one-liner with AraRoot
  produces on any machine that has it. All reader semantics (the
  per-channel interpolation onto a uniform grid, the even-length trim,
  event assembly) live here and are tested on this backend.

Waveform semantics follow readARAData.run:95-121: the calibrated graph
samples (times, voltages) are linearly interpolated onto a uniform grid
``arange(t0, t_last, sampling)`` with ``sampling`` defaulting to the ARA
0.625 ns period, and an odd trailing sample is dropped. NOTE: the
reference then passes the sample PERIOD to ``set_trace`` as the
"sampling_rate" (readARAData.py:117-121) — an apparent period/rate swap
that would mark a 1.6 GHz trace as 0.625 GHz; we store the actual rate
``1/sampling`` and document the difference here.
"""

from __future__ import annotations

import logging

import numpy as np

from ..framework import event as fw
from ..utils import units

logger = logging.getLogger("nuradiomc_tpu_torch.ara_io")

#: default ARA digitizer sample period (readARAData.run:66)
DEFAULT_SAMPLING = 0.625 * units.ns


class NumpyAraDataset:
    """One ARA run exported to ``.npz`` (see module docstring).

    npz keys: ``run_number`` (scalar), ``station_ids [N]``,
    ``event_numbers [N]``, ``times [N, C, Smax]`` + ``voltages
    [N, C, Smax]`` (ns / mV, NaN-padded past each channel's own length) or
    the ragged object arrays of the same names.
    """

    def __init__(self, path):
        data = np.load(path, allow_pickle=True)
        self.run_number = int(data["run_number"])
        self.station_ids = np.asarray(data["station_ids"])
        self.event_numbers = np.asarray(data["event_numbers"])
        self._times = data["times"]
        self._voltages = data["voltages"]

    @property
    def n_events(self):
        return len(self.event_numbers)

    @property
    def n_channels(self):
        return len(self._times[0])

    def get_graph(self, i_event, i_channel):
        """(times [ns], voltages [mV]) of one channel's calibrated graph —
        the content of getGraphFromRFChan (readARAData.py:108-111)."""
        t = np.asarray(self._times[i_event][i_channel], dtype=float)
        v = np.asarray(self._voltages[i_event][i_channel], dtype=float)
        keep = ~np.isnan(t)
        return t[keep], v[keep]


def write_numpy_dataset(path, run_number, station_ids, event_numbers,
                        times, voltages):
    """Write the `NumpyAraDataset` export. ``times``/``voltages`` are
    [N][C] ragged lists of per-channel sample arrays (ns / mV); they are
    NaN-padded to a rectangular [N, C, Smax] block."""
    n_ev = len(times)
    n_ch = len(times[0])
    smax = max(len(t) for ev in times for t in ev)
    tt = np.full((n_ev, n_ch, smax), np.nan)
    vv = np.full((n_ev, n_ch, smax), np.nan)
    for i, (ev_t, ev_v) in enumerate(zip(times, voltages)):
        for c, (t, v) in enumerate(zip(ev_t, ev_v)):
            tt[i, c, :len(t)] = t
            vv[i, c, :len(v)] = v
    np.savez_compressed(path, run_number=run_number,
                        station_ids=np.asarray(station_ids),
                        event_numbers=np.asarray(event_numbers),
                        times=tt, voltages=vv)


class AraRootDataset:
    """pyroot + AraRoot adapter (readARAData.begin:52-62, run:92-111).
    Import-gated: raises with instructions when ROOT/AraRoot are absent."""

    def __init__(self, path):
        try:
            import ROOT  # noqa: F401
        except ImportError as exc:
            raise ImportError(
                "Reading ARA .root files needs pyroot + the AraRoot "
                "libraries (libAraEvent et al., see "
                "readARAData.py:18-24 in the reference). Install AraRoot "
                "or export the run with write_numpy_dataset() on a "
                "machine that has it.") from exc
        import ROOT
        self._ROOT = ROOT
        self._f = ROOT.TFile.Open(path)
        self._raw_ptr = ROOT.RawAtriStationEvent()
        self._tree = self._f.Get("eventTree")
        self._tree.SetBranchAddress("event", self._raw_ptr)
        self._n = self._tree.GetEntries()
        self._i = -1

    @property
    def n_events(self):
        return self._n

    @property
    def run_number(self):
        self._tree.GetEntry(0)
        return int(self._tree.run)

    @property
    def station_ids(self):
        return _AraRootLazyStations(self)

    @property
    def event_numbers(self):
        return _AraRootLazyEventNumbers(self)

    def _entry(self, i):
        if i != self._i:
            self._tree.GetEntry(i)
            self._i = i

    def get_graph(self, i_event, i_channel):
        ROOT = self._ROOT
        self._entry(i_event)
        real = ROOT.UsefulAtriStationEvent(self._raw_ptr,
                                           ROOT.AraCalType.kLatestCalib)
        g = real.getGraphFromRFChan(i_channel)
        return np.array(g.GetX(), dtype=float), np.array(g.GetY(),
                                                         dtype=float)


class _AraRootLazyStations:
    def __init__(self, ds):
        self._ds = ds

    def __getitem__(self, i):
        self._ds._entry(i)
        return bytearray(self._ds._raw_ptr.stationId)[0]


class _AraRootLazyEventNumbers:
    def __init__(self, ds):
        self._ds = ds

    def __getitem__(self, i):
        self._ds._entry(i)
        return int(self._ds._raw_ptr.eventNumber)


def _open_dataset(input_file, backend):
    if backend is not None:
        if isinstance(backend, str):
            return {"araroot": AraRootDataset,
                    "numpy": NumpyAraDataset}[backend](input_file)
        return backend(input_file) if callable(backend) else backend
    if str(input_file).endswith(".npz"):
        return NumpyAraDataset(input_file)
    return AraRootDataset(input_file)


class readARAData:
    """ARA reader over a pluggable dataset backend
    (readARAData.py:26-127)."""

    def __init__(self):
        self._ds = None
        self._id_current_event = None

    def begin(self, input_file, backend=None):
        """Open ``input_file``; returns the number of events
        (readARAData.begin:40-64).

        backend: None (auto: .npz -> numpy export, else AraRoot), the
        strings "araroot"/"numpy", a callable ``path -> dataset``, or an
        already-open dataset object.
        """
        self._id_current_event = -1
        self._ds = _open_dataset(input_file, backend)
        return self._ds.n_events

    def run(self, n_channels=16, sampling=DEFAULT_SAMPLING):
        """Yield one framework Event per ARA event (readARAData.run:65-122):
        per channel, the calibrated graph is interpolated onto a uniform
        ``sampling``-spaced grid and trimmed to even length."""
        while True:
            self._id_current_event += 1
            if self._id_current_event >= self._ds.n_events:
                break
            i = self._id_current_event
            run_number = self._ds.run_number
            evt_number = int(self._ds.event_numbers[i])
            station_id = int(self._ds.station_ids[i])
            logger.info("Reading Run: %s, Event %s, Station %s",
                        run_number, evt_number, station_id)

            evt = fw.Event(run_number, evt_number)
            station = fw.Station(station_id)
            for i_ch in range(n_channels):
                t, v = self._ds.get_graph(i, i_ch)
                # uniform re-grid (readARAData.run:113-116)
                t_new = np.arange(t[0], t[-1], sampling)
                v_new = np.interp(t_new, t, v * units.mV)
                if v_new.shape[0] % 2 != 0:
                    v_new = v_new[:-1]
                channel = fw.Channel(i_ch)
                # the actual rate, NOT the reference's period/rate swap
                # (module docstring)
                channel.set_trace(v_new, 1.0 / sampling)
                station.add_channel(channel)
            evt.set_station(station)
            yield evt

    def end(self):
        pass
