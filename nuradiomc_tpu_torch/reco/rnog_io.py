"""RNO-G raw-data access (torch): dataset backends, the ``readRNOGData``
reader and the ``dataProviderRNOG`` wrapper.

Counterpart of ``nuradiomc_tpu/reco/rnog_io.py`` (the reference's
NuRadioReco/modules/io/RNO_G/readRNOGDataMattak.py:114-937 and
modules/RNO_G/dataProviderRNOG.py:12-109), with the same backends: the
import-gated ``MattakDataset`` (ROOT / mattak) and ``NumpyDataset``, one
``mattak_export.npz`` per run written by ``write_numpy_dataset``.

The reader works on a chunk of events at a time (``rows_per_chunk`` events
of [channels, samples]): the selected events' waveforms are one slice of the
run's array, moved to the module's device in one copy, converted to volts
there, and the baseline correction (``channelBlockOffsets``) runs on the
whole chunk. The provider runs its block-offset fit and glitch statistic on
the chunk the same way; the framework Events are then built on the host, one
per event in the JAX package's order, and each is yielded after
``det.update(station_time)`` and its cable-delay subtraction.
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from nuradiomc_tpu_torch.framework import event as fw
from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.reco.base import Module, host, rows_per_chunk
from nuradiomc_tpu_torch.reco.channel_processing import channelAddCableDelay
from nuradiomc_tpu_torch.reco.rnog_data import channelBlockOffsets, channelGlitchDetector
from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils import units

logger = logging.getLogger("nuradiomc_tpu_torch.rnog_io")
chp = par.channelParameters

# copied from nuradiomc_tpu/reco/rnog_io.py:46-52
#: trace_start_time = trigger_time - offset (readRNOGDataMattak.py:56-61,
#: values motivated by nu-radio/NuRadioMC PR #519)
TIME_OFFSETS = {"FORCE": 0.0, "LT": 250 * units.ns,
                "RADIANT": 475 * units.ns, "UNKNOWN": 0.0}

ADC_REF_VOLTAGE_RANGE = 2.5 * units.volt    # readRNOGDataMattak.py:304
ADC_N_BITS = 12
ADC_TO_VOLT = ADC_REF_VOLTAGE_RANGE / (2 ** ADC_N_BITS - 1)

#: device bytes one event of [24, 2048] float64 takes through the chunk's
#: conversion, spectra, fit and glitch gather (a dozen copies of the trace)
BYTES_PER_SAMPLE = 8 * 12


# copied from nuradiomc_tpu/reco/rnog_io.py:55-63
def get_time_offset(trigger_type):
    """Offset between trace start time and trigger time per trigger type
    (readRNOGDataMattak.get_time_offset:34-71)."""
    if trigger_type.startswith("RADIANT"):
        trigger_type = "RADIANT"
    if trigger_type not in TIME_OFFSETS:
        raise KeyError(f"Unknown trigger type: {trigger_type}. Known are: "
                       f"{', '.join(TIME_OFFSETS)}. Abort ....")
    return TIME_OFFSETS[trigger_type]


# copied from nuradiomc_tpu/reco/rnog_io.py:66-79
@dataclass
class EventInfo:
    """Per-event header, mirroring mattak.Dataset.EventInfo."""

    station: int
    run: int
    eventNumber: int
    triggerType: str = "UNKNOWN"
    triggerTime: float = math.inf
    readoutTime: float = 0.0
    sampleRate: float = 3.2          # GHz
    readoutDelay: np.ndarray = field(
        default_factory=lambda: np.zeros(24))
    radiantStartWindows: Optional[np.ndarray] = None


# copied from nuradiomc_tpu/reco/rnog_io.py:82-129, with ``raw_block``; each
# array of the file is read once (an ``NpzFile`` decompresses a member on
# every access)
class NumpyDataset:
    """One run from a ``mattak_export.npz`` file (see module docstring).

    npz keys: ``station`` ``run`` (scalars), ``event_numbers [N]``,
    ``trigger_types [N]`` (str), ``trigger_times [N]``,
    ``readout_times [N]``, ``sample_rate`` (GHz scalar),
    ``readout_delays [N, C]`` (ns), ``waveforms [N, C, S]`` (ADC counts
    unless ``calibrated`` is stored true).
    """

    backend = "numpy"

    def __init__(self, path):
        fname = path if os.path.isfile(path) else os.path.join(
            path, "mattak_export.npz")
        if not os.path.exists(fname):
            raise FileNotFoundError(fname)
        with np.load(fname, allow_pickle=False) as z:
            d = {k: z[k] for k in z.files}
        self.station = int(d["station"])
        self.run = int(d["run"])
        self._wfs = d["waveforms"]
        self.calibrated = bool(d["calibrated"]) if "calibrated" in d else False
        n = self._wfs.shape[0]
        self._infos = [EventInfo(
            station=self.station, run=self.run,
            eventNumber=int(d["event_numbers"][i]),
            triggerType=str(d["trigger_types"][i]),
            triggerTime=float(d["trigger_times"][i]),
            readoutTime=float(d["readout_times"][i]),
            sampleRate=float(d["sample_rate"]),
            readoutDelay=np.asarray(d["readout_delays"][i], dtype=float))
            for i in range(n)]

    def N(self):
        return len(self._infos)

    def event_info(self, i):
        return self._infos[i]

    def waveforms(self, i):
        return np.asarray(self._wfs[i], dtype=float)

    def raw_block(self, indices):
        """The stored waveforms [E, C, S] of events ``indices``, one slice."""
        return self._wfs[np.asarray(indices, dtype=np.int64)]

    def iterate(self, selectors=None):
        for i in range(self.N()):
            info = self._infos[i]
            if selectors is not None and not selectors(info):
                continue
            yield info, self.waveforms(i)


# copied from nuradiomc_tpu/reco/rnog_io.py:132-156
def write_numpy_dataset(path, station, run, waveforms, event_numbers=None,
                        trigger_types=None, trigger_times=None,
                        readout_times=None, sample_rate=3.2,
                        readout_delays=None, calibrated=False):
    """Write a run directory in the `NumpyDataset` format (fixture writer /
    mattak conversion target). ``waveforms``: [N, C, S]."""
    waveforms = np.asarray(waveforms)
    n, c, _ = waveforms.shape
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(
        os.path.join(path, "mattak_export.npz"),
        station=station, run=run, waveforms=waveforms,
        calibrated=calibrated,
        event_numbers=np.arange(n) if event_numbers is None
        else np.asarray(event_numbers),
        trigger_types=np.array(["FORCE"] * n if trigger_types is None
                               else trigger_types, dtype="U16"),
        trigger_times=np.zeros(n) if trigger_times is None
        else np.asarray(trigger_times, dtype=float),
        readout_times=np.zeros(n) if readout_times is None
        else np.asarray(readout_times, dtype=float),
        sample_rate=float(sample_rate),
        readout_delays=np.zeros((n, c)) if readout_delays is None
        else np.asarray(readout_delays, dtype=float))
    return os.path.join(path, "mattak_export.npz")


# copied from nuradiomc_tpu/reco/rnog_io.py:159-188
class MattakDataset:
    """Adapter for the real ROOT-based mattak package (import-gated: the
    package and ROOT are not available in this environment)."""

    backend = "mattak"

    def __init__(self, path, **mattak_kwargs):
        try:
            import mattak.Dataset
        except ImportError as e:
            raise ImportError(
                "reading RNO-G .root runs requires the 'mattak' package "
                "(https://github.com/RNO-G/mattak) with a pyroot or uproot "
                "backend; alternatively export the run with "
                "rnog_io.write_numpy_dataset on a machine that has mattak "
                "and read the export here") from e
        self._ds = mattak.Dataset.Dataset(
            station=0, run=0, data_path=path, **mattak_kwargs)
        self.station = self._ds.station
        self.run = self._ds.run

    def N(self):
        return self._ds.N()

    def iterate(self, selectors=None):
        self._ds.setEntries((0, self._ds.N()))
        for info, wfs in self._ds.iterate():
            if selectors is not None and not selectors(info):
                continue
            yield info, wfs


# copied from nuradiomc_tpu/reco/rnog_io.py:191-197
def open_dataset(path, **kwargs):
    """Pick a backend for a run directory / file: npz export if present,
    otherwise mattak (readRNOGDataMattak.__get_dataset:435-437)."""
    if str(path).endswith(".npz") or os.path.exists(
            os.path.join(path, "mattak_export.npz")):
        return NumpyDataset(path)
    return MattakDataset(path, **kwargs)


class readRNOGData(Module):
    """Read RNO-G runs and convert them to framework Events
    (readRNOGDataMattak.readRNOGData:114-937), a chunk of events at a time
    on the module's device."""

    def __init__(self, run_table_path=None, load_run_table=False,
                 log_level=logging.NOTSET, device=device_util.DEFAULT):
        super().__init__(device)
        if log_level:
            logger.setLevel(log_level)
        self._run_table = None
        if run_table_path is not None and load_run_table:
            self._run_table = self._load_run_table(run_table_path)
        self.last_chunk = None

    # copied from nuradiomc_tpu/reco/rnog_io.py:212-222
    @staticmethod
    def _load_run_table(path):
        """CSV with at least (station, run, run_type, time_start, time_end,
        trigger_rate) columns — the rnog-runtable export format."""
        import csv

        rows = []
        with open(path) as f:
            for row in csv.DictReader(f):
                rows.append(row)
        return rows

    # copied from nuradiomc_tpu/reco/rnog_io.py:224-287 (the block-offset
    # fitter on the reader's device)
    def begin(self, dirs_files,
              read_calibrated_data=False,
              select_triggers=None,
              select_runs=False,
              apply_baseline_correction="auto",
              convert_to_voltage=True,
              selectors=(),
              run_types=("physics",),
              run_time_range=None,
              max_trigger_rate=0 * units.Hz,
              mattak_kwargs=None,
              overwrite_sampling_rate=None,
              max_in_mem=256,
              use_fallback_time=True):
        self._read_calibrated_data = read_calibrated_data
        valid = ["auto", "approximate", "fit", "median", "none"]
        if apply_baseline_correction is None:
            apply_baseline_correction = "none"
        if apply_baseline_correction.lower() not in valid:
            raise ValueError(
                f"Value for apply_baseline_correction "
                f"({apply_baseline_correction}) not recognized. Valid "
                f"options are {valid}")
        self._apply_baseline_correction = apply_baseline_correction.lower()
        self._convert_to_voltage = convert_to_voltage
        if self._apply_baseline_correction != "none":
            self._blockoffsetfitter = channelBlockOffsets(device=self.device)
        self._overwrite_sampling_rate = overwrite_sampling_rate
        self._use_fallback_time = use_fallback_time

        self._selectors = [self._check_for_valid_information_in_event_info]
        self.add_selectors(list(selectors), select_triggers)

        self._run_types = run_types
        self._max_trigger_rate = max_trigger_rate
        self._run_time_range = run_time_range

        if not isinstance(dirs_files, (list, tuple, np.ndarray)):
            dirs_files = [dirs_files]

        self._datasets = []
        skipped = 0
        for dir_file in dirs_files:
            if not os.path.exists(dir_file):
                logger.error("The directory/file %s does not exist", dir_file)
                continue
            try:
                ds = open_dataset(dir_file, **(mattak_kwargs or {}))
            except (FileNotFoundError, KeyError, ImportError) as e:
                logger.error("Could not read run %s: %s", dir_file, e)
                continue
            if select_runs and self._run_table is not None \
                    and not self._select_run(ds):
                skipped += 1
                continue
            self._datasets.append(ds)

        if not self._datasets:
            raise FileNotFoundError("Found no valid datasets. Stop!")
        self._n_per_dataset = np.array([ds.N() for ds in self._datasets])
        self._cum_events = np.cumsum(self._n_per_dataset)
        self._events_information = None
        logger.info("%d events in %d runs/datasets (skipped %d runs)",
                    self._cum_events[-1], len(self._datasets), skipped)

    # -- selection: copied from nuradiomc_tpu/reco/rnog_io.py:290-345 ------
    def add_selectors(self, selectors, select_triggers=None):
        """Add event selectors (lambda(EventInfo) -> bool) and/or a
        trigger-name selection (readRNOGDataMattak.add_selectors:439-471)."""
        if selectors is None:
            selectors = []
        if not isinstance(selectors, (list, tuple)):
            selectors = [selectors]
        selectors = list(selectors)
        if select_triggers is not None:
            if isinstance(select_triggers, str):
                select_triggers = [select_triggers]
            wanted = list(select_triggers)
            selectors.append(
                lambda info: any(info.triggerType.startswith(t)
                                 for t in wanted))
        self._selectors.extend(selectors)

    def _check_for_valid_information_in_event_info(self, event_info):
        """Reject events with no usable time or sampling rate
        (readRNOGDataMattak:712-742)."""
        if math.isinf(event_info.triggerTime) and not self._use_fallback_time:
            logger.warning("Event %d (st %d, run %d) has inf trigger time, "
                           "skipping it", event_info.eventNumber,
                           event_info.station, event_info.run)
            return False
        if (event_info.sampleRate in (0, None)
                and self._overwrite_sampling_rate is None):
            raise ValueError(
                f"Event {event_info.eventNumber} has invalid sampling rate "
                f"{event_info.sampleRate}; pass overwrite_sampling_rate=")
        return True

    def _select_events(self, event_info):
        return all(sel(event_info) for sel in self._selectors)

    def _select_run(self, dataset):
        """Run-table selection: type, time overlap, trigger rate
        (readRNOGDataMattak.__select_run:473-523)."""
        for row in self._run_table:
            if int(row["station"]) == dataset.station \
                    and int(row["run"]) == dataset.run:
                if row.get("run_type") not in self._run_types:
                    return False
                if self._run_time_range is not None:
                    lo, hi = self._run_time_range
                    if lo is not None and float(row["time_end"]) < lo:
                        return False
                    if hi is not None and float(row["time_start"]) > hi:
                        return False
                rate = float(row.get("trigger_rate", 0.0)) * units.Hz
                if self._max_trigger_rate and rate > self._max_trigger_rate:
                    return False
                return True
        logger.warning("Run %d (station %d) not in run table; keeping it",
                       dataset.run, dataset.station)
        return True

    # -- event access: copied from nuradiomc_tpu/reco/rnog_io.py:348-372 ---
    def get_run_numbers(self):
        return np.array([ds.run for ds in self._datasets])

    def get_station_id(self, except_multiple_stations=False):
        ids = sorted({ds.station for ds in self._datasets})
        if except_multiple_stations and len(ids) > 1:
            raise ValueError(f"Multiple stations in datasets: {ids}")
        return ids[0] if len(ids) == 1 else ids

    def get_n_events(self):
        return int(self._cum_events[-1])

    def get_events_information(self, keys=("station", "run", "eventNumber")):
        """{event_index: {key: value}} over ALL events (before selectors),
        readRNOGDataMattak:583-641."""
        if self._events_information is None:
            self._events_information = {}
            idx = 0
            for ds in self._datasets:
                for i in range(ds.N()):
                    info = ds.event_info(i)
                    self._events_information[idx] = {
                        k: getattr(info, k) for k in keys}
                    idx += 1
        return self._events_information

    # -- the chunked path --------------------------------------------------
    def _sampling_rate(self, event_info):
        sampling_rate = event_info.sampleRate
        if self._overwrite_sampling_rate is not None and sampling_rate in (0, None):
            sampling_rate = self._overwrite_sampling_rate
        return sampling_rate * units.GHz

    def rows(self, n_channels, n_samples, n_events):
        """Events per chunk: ``rows_per_chunk`` of the chunk's device bytes."""
        self.last_chunk = rows_per_chunk(n_channels * n_samples * BYTES_PER_SAMPLE,
                                         self.device, max(n_events, 1))
        return self.last_chunk

    def _dataset_index(self, event_index):
        ds_idx = int(np.searchsorted(self._cum_events, event_index, side="right"))
        local = event_index - (0 if ds_idx == 0 else self._cum_events[ds_idx - 1])
        return ds_idx, int(local)

    def event_info_by_index(self, event_index):
        ds_idx, local = self._dataset_index(event_index)
        return self._datasets[ds_idx].event_info(local)

    def chunks(self):
        """(event infos, waveforms [E, C, S] on the device, as stored) of the
        selected events of every dataset, ``rows`` events at a time."""
        for ds in self._datasets:
            if hasattr(ds, "raw_block"):
                sel = [i for i in range(ds.N()) if self._select_events(ds.event_info(i))]
                if not sel:
                    continue
                _, n_ch, n_s = ds.raw_block(sel[:1]).shape
                rows = self.rows(n_ch, n_s, len(sel))
                for at in range(0, len(sel), rows):
                    part = sel[at:at + rows]
                    yield [ds.event_info(i) for i in part], self.tensor(ds.raw_block(part))
            else:
                infos, wfs = [], []
                for info, wf in ds.iterate(selectors=self._select_events):
                    infos.append(info)
                    wfs.append(np.asarray(wf, dtype=float))
                    if len(infos) == self.rows(*wfs[0].shape, ds.N()):
                        yield infos, self.tensor(np.stack(wfs))
                        infos, wfs = [], []
                if infos:
                    yield infos, self.tensor(np.stack(wfs))

    def volts(self, raw: torch.Tensor) -> torch.Tensor:
        """Stored waveforms as float64 traces (ADC -> volts by 2.5 V / 4095,
        readRNOGDataMattak.py:303-306, unless calibrated data is read or
        ``convert_to_voltage`` is off)."""
        wf = raw.to(torch.float64)
        if not self._read_calibrated_data and self._convert_to_voltage:
            wf = wf * ADC_TO_VOLT
        return wf

    def per_rate(self, infos, traces, fn):
        """``fn(traces[rows], sampling rate)`` for the rows of each sampling
        rate of a chunk; its outputs, tensors [rows, ...], gathered back into
        the chunk's order."""
        groups = {}
        for k, info in enumerate(infos):
            groups.setdefault(self._sampling_rate(info), []).append(k)
        outs = None
        for fs, rows in groups.items():
            idx = torch.as_tensor(rows, device=traces.device)
            part = fn(traces[idx], fs)
            if outs is None:
                outs = [p.new_empty((len(infos), *p.shape[1:])) for p in part]
            for out, p in zip(outs, part):
                out[idx] = p
        return outs

    def process(self, infos, raw):
        """The chunk's traces [E, C, S] in volts with the reader's baseline
        correction, and its offsets [E, C, n_blocks] (None without one), on
        the device."""
        traces = self.volts(raw)
        mode = self._apply_baseline_correction
        if mode == "none":
            return traces, None
        offsets, traces, _ = self.per_rate(
            infos, traces,
            lambda tr, fs: self._blockoffsetfitter.offsets_and_traces(tr, fs, mode))
        return traces, offsets

    def make_event(self, event_info, traces, offsets=None):
        """EventInfo + [C, S] traces in volts (+ the block offsets [C, B]
        that were removed from them) -> framework Event
        (readRNOGDataMattak._get_event:744-806)."""
        if self._use_fallback_time and math.isinf(event_info.triggerTime):
            logger.warning("Event %d (st %d, run %d) has inf trigger time, "
                           "readout time will be used instead.",
                           event_info.eventNumber, event_info.station,
                           event_info.run)
            trigger_time = event_info.readoutTime
        else:
            trigger_time = event_info.triggerTime

        sampling_rate = self._sampling_rate(event_info)
        evt = fw.Event(event_info.run, event_info.eventNumber)
        station = fw.Station(event_info.station)
        station.set_station_time(trigger_time)

        trigger = fw.Trigger(event_info.triggerType)
        trigger.set_triggered()
        trigger.set_trigger_time(0)   # relative to the event/station time
        station.set_trigger(trigger)

        readout_delays = event_info.readoutDelay
        for channel_id, wf in enumerate(traces):
            channel = fw.Channel(channel_id)
            channel.set_trace(wf, sampling_rate)
            time_offset = (get_time_offset(event_info.triggerType)
                           + readout_delays[channel_id])
            channel.set_trace_start_time(-time_offset)
            if offsets is not None:
                channel.set_parameter(chp.block_offsets, offsets[channel_id])
            station.add_channel(channel)

        evt.set_station(station)
        return evt

    def _events(self, infos, raw):
        traces, offsets = self.process(infos, raw)
        traces = host(traces)
        offsets = None if offsets is None else host(offsets)
        for k, info in enumerate(infos):
            yield self.make_event(info, traces[k], None if offsets is None else offsets[k])

    def run(self):
        """Yield all (selected) events across the datasets."""
        for infos, raw in self.chunks():
            yield from self._events(infos, raw)

    def _one(self, ds, local):
        info = ds.event_info(local)
        raw = ds.raw_block([local]) if hasattr(ds, "raw_block") else ds.waveforms(local)[None]
        return next(self._events([info], self.tensor(raw)))

    def get_event_by_index(self, event_index):
        """Global index across datasets (selectors still apply),
        readRNOGDataMattak:833-864."""
        ds_idx, local = self._dataset_index(event_index)
        ds = self._datasets[ds_idx]
        if not self._select_events(ds.event_info(local)):
            logger.info("Event %d does not pass the selectors", event_index)
            return None
        return self._one(ds, local)

    def events_by_index(self, event_indices):
        """The traces [U, C, S] (volts, baseline-corrected) on the device of
        the events ``event_indices`` (global indices, selectors not
        applied), read per dataset as one slice each, with their infos."""
        infos, parts, order = [], [], []
        by_ds = {}
        for k, e in enumerate(event_indices):
            ds_idx, local = self._dataset_index(e)
            by_ds.setdefault(ds_idx, []).append((k, local))
        for ds_idx, items in by_ds.items():
            ds = self._datasets[ds_idx]
            locals_ = [local for _, local in items]
            raw = ds.raw_block(locals_) if hasattr(ds, "raw_block") else \
                np.stack([ds.waveforms(i) for i in locals_])
            part_infos = [ds.event_info(i) for i in locals_]
            traces, _ = self.process(part_infos, self.tensor(raw))
            parts.append(traces)
            infos += part_infos
            order += [k for k, _ in items]
        traces = torch.cat(parts)[torch.as_tensor(np.argsort(order), device=self.device)]
        return [infos[i] for i in np.argsort(order)], traces

    def get_event(self, run_nr, event_id):
        """Look up one event by (run, eventNumber),
        readRNOGDataMattak:867-916."""
        for ds in self._datasets:
            for i in range(ds.N()):
                info = ds.event_info(i)
                if info.run == run_nr and info.eventNumber == event_id:
                    if not self._select_events(info):
                        return None
                    return self._one(ds, i)
        logger.error("Could not find event with run %s and id %s",
                     run_nr, event_id)
        return None

    def end(self):
        pass


class dataProviderRNOG(Module):
    """Read RNO-G data and run the standard processing sequence on each
    event: block-offset removal -> glitch detection -> cable-delay
    subtraction, with the detector updated to the station time
    (dataProviderRNOG.py:12-109). The first two run on a chunk of events on
    the device; each event is then yielded in the reader's order."""

    def __init__(self, reader=None, device=device_util.DEFAULT):
        super().__init__(device)
        self.reader = reader if reader is not None else readRNOGData(device=self.device)
        self.channelGlitchDetector = channelGlitchDetector(device=self.device)
        self.channelBlockOffsetFitter = channelBlockOffsets(device=self.device)
        self.channelCableDelayAdder = channelAddCableDelay(device=self.device)
        self.n_fitted = 0
        self.n_glitch = 0

    def begin(self, files, det, reader_kwargs=None):
        reader_kwargs = dict(reader_kwargs or {})
        self.files = files
        self.detector = det
        if reader_kwargs.pop("apply_baseline_correction", None) is not None:
            logger.warning(
                "The 'apply_baseline_correction' argument in kwargs will be "
                "ignored. Instead the 'channelBlockOffsetFitter' is used "
                "explicitly in the module sequence.")
        self.reader.begin(self.files, apply_baseline_correction=None,
                          **reader_kwargs)
        self.channelBlockOffsetFitter.begin()
        self.channelGlitchDetector.begin()
        self.channelCableDelayAdder.begin()

    def end(self):
        self.reader.end()
        self.channelGlitchDetector.end()
        self.channelBlockOffsetFitter.end()

    def process(self, traces: torch.Tensor, sampling_rate):
        """Block offsets ("auto") and the glitch statistic of traces
        [..., n] on the device: (corrected traces, offsets, fitted, glitch
        flags)."""
        offsets, out, fitted = self.channelBlockOffsetFitter.offsets_and_traces(
            traces, sampling_rate, "auto")
        glitch = self.channelGlitchDetector.statistic(out) > self.channelGlitchDetector.cut
        return out, offsets, fitted, glitch

    def run(self):
        fitter, glitcher = self.channelBlockOffsetFitter, self.channelGlitchDetector
        cable = self.channelCableDelayAdder
        for infos, raw in self.reader.chunks():
            traces, offsets, fitted, glitch = self.reader.per_rate(
                infos, self.reader.volts(raw), self.process)
            self.n_fitted += int(fitted.sum())
            self.n_glitch += int(glitch.sum())
            traces, offsets, glitch = host(traces), host(offsets), host(glitch)
            for k, info in enumerate(infos):
                event = self.reader.make_event(info, traces[k], offsets[k])
                station = event.get_station()
                for channel, flag in zip(station.iter_channels(), glitch[k]):
                    channel.set_parameter(chp.glitch, bool(flag))
                if hasattr(self.detector, "update"):
                    self.detector.update(station.get_station_time())
                sid = station.get_id()
                event.register_module_station(sid, fitter, type(fitter).__name__, {})
                event.register_module_station(sid, glitcher, type(glitcher).__name__, {})
                cable.run(event, station, self.detector, mode="subtract")
                yield event
