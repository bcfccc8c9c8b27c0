# copied from nuradiomc_tpu/reco/arianna_io.py:1-302 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""ARIANNA raw-data access: ``readARIANNAData`` (basic) and
``readARIANNADataCalib`` (full) over pluggable snowshovel-dataset backends.

Re-implementation of the reference's
NuRadioReco/modules/io/snowshovel/readARIANNAData.py:11-71 and
readARIANNADataCalib.py:19-241. The reference reads snowshovel ROOT files
(CalibTree/ConfigTree TChains with TSnCalWvData/TSnReadoutConfig branch
objects) through pyroot plus the snowshovel scripts (AriUtils mac<->station
mapping, dacs2014 DAC->voltage conversion, readARIANNADataCalib.py:13-16).
Neither is distributable here, so every reader semantic lives in this
module over a backend protocol:

* `SnowshovelDataset` is an import-gated pyroot adapter stub that raises
  with instructions (the compiled TSn* dictionaries only exist inside a
  snowshovel build);
* `NumpyAriannaDataset` reads the same content from one ``.npz`` export
  per file (`write_numpy_dataset`), station ids and threshold voltages
  already resolved (the mac->station and DAC->volt maps are
  snowshovel-internal tables).

Reader semantics mirrored from the reference (file:line cited inline):
trigger-type / time-interval / run-number / event-id selection
(readARIANNADataCalib.run:127-157), config lookup by (station, run, seq)
with skip counting (:159-170), 'Custom' (empty) readout-config skip
(:180-184), stop-sample roll of every channel (:192-200, the
``np.roll(voltage, -stop[0])`` stop shift), missing-stop skip counting
(:201-204), and the ARIANNA station parameters (sequence times, comm
window, L1 suppression, internal clock, trigger thresholds, :206-229).
"""

from __future__ import annotations

import datetime
import logging

import numpy as np

from ..framework import event as fw
from ..framework.parameters import ARIANNAParameters as ARIpar
from ..utils import units

logger = logging.getLogger("nuradiomc_tpu_torch.arianna_io")


class NumpyAriannaDataset:
    """One snowshovel file exported to ``.npz``.

    Event block (length N): ``station_ids``, ``run_numbers``,
    ``event_numbers``, ``seq_numbers``, ``unix_times`` (s),
    ``is_thermal`` / ``is_forced`` (bool), ``dt_ms`` (internal clock),
    ``stop_samples [N]`` (-1 = missing), and per-tree waveforms
    ``waveforms_AmpOutData`` / ``waveforms_FPNSubData`` /
    ``waveforms_RawData`` as [N, C, S] (mV for calibrated trees, ADC
    otherwise; only the trees that were exported need to be present).

    Config block (length M, one row per sequence): ``cfg_station_ids``,
    ``cfg_run_numbers``, ``cfg_seq_numbers``, ``cfg_n_chans``,
    ``cfg_sampling_rates`` (GHz), ``cfg_type_names`` (str;
    'Custom' = empty config), ``cfg_seq_start`` / ``cfg_seq_stop``
    (unix s, 0 = unset), ``cfg_comm_durations`` / ``cfg_comm_periods``
    (s), ``cfg_l1_cuts``, ``cfg_thresholds [M, C, 2]`` (volts,
    low/high — already through the dacs2014 conversion).
    """

    def __init__(self, path, tree="AmpOutData"):
        data = np.load(path, allow_pickle=True)
        key = f"waveforms_{tree}"
        if key not in data:
            raise KeyError(f"export {path} has no tree {tree!r} "
                           f"(keys: {sorted(data.keys())})")
        self.waveforms = data[key]
        for name in ("station_ids", "run_numbers", "event_numbers",
                     "seq_numbers", "unix_times", "is_thermal", "is_forced",
                     "dt_ms", "stop_samples", "cfg_station_ids",
                     "cfg_run_numbers", "cfg_seq_numbers", "cfg_n_chans",
                     "cfg_sampling_rates", "cfg_type_names", "cfg_seq_start",
                     "cfg_seq_stop", "cfg_comm_durations", "cfg_comm_periods",
                     "cfg_l1_cuts", "cfg_thresholds"):
            setattr(self, name, np.asarray(data[name]))

    @property
    def n_events(self):
        return len(self.event_numbers)


def write_numpy_dataset(path, *, trees, **blocks):
    """Write a `NumpyAriannaDataset` export: ``trees`` maps tree name ->
    [N, C, S] waveform block; ``blocks`` are the event/config arrays named
    as in the class docstring."""
    payload = {f"waveforms_{name}": np.asarray(w) for name, w in trees.items()}
    payload.update({k: np.asarray(v) for k, v in blocks.items()})
    np.savez_compressed(path, **payload)


class SnowshovelDataset:
    """pyroot + snowshovel adapter. Import-gated: the TSnCalWvData /
    TSnReadoutConfig branch classes only exist inside a snowshovel build
    (readARIANNADataCalib.py:5-16)."""

    def __init__(self, path, tree="AmpOutData"):
        raise ImportError(
            "Reading snowshovel .root files needs pyroot with the compiled "
            "snowshovel dictionaries (TSnCalWvData, TSnReadoutConfig, "
            "AriUtils, dacs2014 — readARIANNADataCalib.py:5-16 in the "
            "reference). Export the file with write_numpy_dataset() on a "
            "machine that has them.")


def _open(input_file, tree, backend):
    if backend is not None:
        if isinstance(backend, str):
            return {"snowshovel": SnowshovelDataset,
                    "numpy": NumpyAriannaDataset}[backend](input_file, tree)
        return backend(input_file, tree) if callable(backend) else backend
    if str(input_file).endswith(".npz"):
        return NumpyAriannaDataset(input_file, tree)
    return SnowshovelDataset(input_file, tree)


class readARIANNAData:
    """Basic calibrated-tree reader (readARIANNAData.py:11-71): no
    selection, no stop shift, fixed station id."""

    def begin(self, input_file, station_id, backend=None):
        self._ds = _open(input_file, "AmpOutData", backend)
        self._station_id = station_id
        self._i = 0
        return self._ds.n_events

    def run(self):
        ds = self._ds
        while self._i < ds.n_events:
            i = self._i
            evt = fw.Event(int(ds.run_numbers[i]), int(ds.event_numbers[i]))
            # the reference's basic reader reads the ConfigTree at the EVENT
            # index (readARIANNAData.run:44), so mirror that (clamped — the
            # config tree has one row per sequence, not per event)
            cfg = min(i, len(ds.cfg_seq_numbers) - 1)
            sampling_rate = float(ds.cfg_sampling_rates[cfg]) * units.GHz
            n_chan = int(ds.cfg_n_chans[cfg])

            station = fw.Station(self._station_id)
            station.set_station_time(
                datetime.datetime.fromtimestamp(float(ds.unix_times[i])))
            station.set_triggered(bool(ds.is_thermal[i]))
            for i_ch in range(n_chan):
                channel = fw.Channel(i_ch)
                channel.set_trace(
                    np.asarray(ds.waveforms[i, i_ch], float) * units.mV,
                    sampling_rate)
                station.add_channel(channel)
            evt.set_station(station)
            self._i += 1
            yield evt

    def end(self):
        pass


def _config_row(ds, station_id, run_number, seq_number):
    """ConfigTree row index for (station, run, seq)
    (readARIANNADataCalib.begin:92-99); raises KeyError when absent."""
    hit = np.flatnonzero((ds.cfg_station_ids == station_id)
                         & (ds.cfg_run_numbers == run_number)
                         & (ds.cfg_seq_numbers == seq_number))
    if hit.size == 0:
        raise KeyError((station_id, run_number, seq_number))
    return int(hit[0])


class readARIANNADataCalib:
    """Full snowshovel reader (readARIANNADataCalib.py:19-241): selection
    filters, config matching, stop-sample shift, ARIANNA parameters."""

    def __init__(self):
        self.skipped_events = 0
        self.skipped_events_stop = 0

    def begin(self, input_files, trigger_types=None, time_interval=None,
              tree="AmpOutData", run_number=None, event_ids=None,
              random_iterator=False, backend=None, rng=None):
        """Open the file list; selection arguments exactly as the
        reference's begin (readARIANNADataCalib.py:28-58)."""
        if isinstance(input_files, (str, bytes)):
            input_files = [input_files]
        self._datasets = [_open(f, tree, backend) for f in input_files]
        self._trigger_types = trigger_types
        self._time_interval = time_interval
        self._run_number = run_number
        self._event_ids = event_ids
        self.skipped_events = 0
        self.skipped_events_stop = 0
        # flat (dataset, row) order, optionally shuffled
        # (readARIANNADataCalib.begin:85-88)
        order = [(d, i) for d in self._datasets for i in range(d.n_events)]
        if random_iterator:
            (rng or np.random).shuffle(order)
        self._order = order
        return len(order)

    def run(self):
        for ds, i in self._order:
            evt_time = datetime.datetime.fromtimestamp(
                float(ds.unix_times[i]))
            if self._time_interval is not None:
                if not (self._time_interval[0] <= evt_time
                        <= self._time_interval[1]):
                    continue
            if self._trigger_types is not None:
                use = (("thermal" in self._trigger_types
                        and bool(ds.is_thermal[i]))
                       or ("forced" in self._trigger_types
                           and bool(ds.is_forced[i])))
                if not use:
                    logger.debug("skipping event: trigger type not in %s",
                                 self._trigger_types)
                    continue

            station_id = int(ds.station_ids[i])
            evt_number = int(ds.event_numbers[i])
            run_number = int(ds.run_numbers[i])
            if self._run_number is not None and run_number != self._run_number:
                continue
            if self._event_ids is not None:
                if run_number not in self._event_ids:
                    continue
                if evt_number not in self._event_ids[run_number]:
                    continue

            seq_number = int(ds.seq_numbers[i])
            try:
                cfg = _config_row(ds, station_id, run_number, seq_number)
            except KeyError:
                logger.error(
                    "no config entry for station %s, run %s, sequence %s. "
                    "Skipping event...", station_id, run_number, seq_number)
                self.skipped_events += 1
                continue

            if str(ds.cfg_type_names[cfg]) == "Custom":
                # empty readout config (readARIANNADataCalib.py:180-184)
                logger.warning("Event %s of run %s skipped: ReadoutConfig "
                               "seems empty", evt_number, run_number)
                self.skipped_events += 1
                continue

            stop = int(ds.stop_samples[i])
            if stop < 0:
                logger.warning("Event %s of run %s skipped: no stop point "
                               "for rolling array!", evt_number, run_number)
                self.skipped_events_stop += 1
                continue

            evt = fw.Event(run_number, evt_number)
            station = fw.Station(station_id)
            station.set_station_time(evt_time)
            station.set_triggered(bool(ds.is_thermal[i]))
            sampling_rate = float(ds.cfg_sampling_rates[cfg]) * units.GHz
            for i_ch in range(int(ds.cfg_n_chans[cfg])):
                voltage = np.asarray(ds.waveforms[i, i_ch], float) * units.mV
                voltage = np.roll(voltage, -stop)
                channel = fw.Channel(i_ch)
                channel.set_trace(voltage, sampling_rate)
                station.add_channel(channel)

            station.set_parameter(ARIpar.seq_num, seq_number)
            start = float(ds.cfg_seq_start[cfg])
            stop_t = float(ds.cfg_seq_stop[cfg])
            # pre-1971 sentinel -> None (readARIANNADataCalib.py:211-216)
            lim = datetime.datetime(1971, 1, 1).timestamp()
            station.set_parameter(
                ARIpar.seq_start_time,
                datetime.datetime.fromtimestamp(start) if start >= lim
                else None)
            station.set_parameter(
                ARIpar.seq_stop_time,
                datetime.datetime.fromtimestamp(stop_t) if stop_t >= lim
                else None)
            station.set_parameter(ARIpar.comm_duration,
                                  float(ds.cfg_comm_durations[cfg]) * units.s)
            station.set_parameter(ARIpar.comm_period,
                                  float(ds.cfg_comm_periods[cfg]) * units.s)
            station.set_parameter(ARIpar.l1_supression_value,
                                  float(ds.cfg_l1_cuts[cfg]))
            station.set_parameter(ARIpar.internal_clock_time,
                                  float(ds.dt_ms[i]) * units.ms)
            thr = np.asarray(ds.cfg_thresholds[cfg], float)
            station.set_parameter(
                ARIpar.trigger_thresholds,
                {i_ch: {"low": thr[i_ch, 0], "high": thr[i_ch, 1]}
                 for i_ch in range(thr.shape[0])})

            evt.set_station(station)
            yield evt

    def end(self):
        if self.skipped_events > 0:
            logger.warning("Skipped %d events due to problems in config",
                           self.skipped_events)
        if self.skipped_events_stop > 0:
            logger.warning("Skipped %d events due to problems in stop bit",
                           self.skipped_events_stop)
