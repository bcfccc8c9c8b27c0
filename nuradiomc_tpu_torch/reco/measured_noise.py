"""Experiment-specific measured-noise importers (torch).

Counterpart of ``nuradiomc_tpu/reco/measured_noise.py``: real recorded
noise (forced triggers) superimposed on simulated channel traces.

* :class:`RNOGNoiseImporter` (measured_noise/RNO_G/noiseImporter.py:14-219):
  random forced-trigger events of RNO-G runs read by the port's
  :class:`reco.rnog_io.readRNOGData`.
* :class:`ARIANNANoiseImporter` (measured_noise/ARIANNA/
  noiseImporterROOT.py:10-57): one random CalibTree entry per channel, from
  a ``caltree_export.npz`` (``amp_out [N, C, S]`` in mV) or, when pyroot is
  installed, the ROOT tree.

The draws are the JAX package's: ``np.random.Generator(np.random.Philox(
seed))`` on the host, one scalar draw at a time in its loops' order. A
chunk of simulated events (``run_events``; ``run`` is a chunk of one) then
takes its noise in one step on the device: the drawn noise traces are read
as one slice per run (RNO-G, baseline-corrected there by the reader) or
gathered from the table on the device (ARIANNA), and added to the stacked
simulated traces, one addition per sample as in the JAX package.
"""
from __future__ import annotations

import collections
import glob
import logging
import os

import numpy as np
import torch

from nuradiomc_tpu_torch.reco.base import Module, host, register_run, rows_per_chunk
from nuradiomc_tpu_torch.utils import units

logger = logging.getLogger("nuradiomc_tpu_torch.reco.measured_noise")


class RNOGNoiseImporter(Module):
    """Imports recorded traces from RNO-G stations (forced triggers).

    API-compatible with the reference's
    ``measured_noise.RNO_G.noiseImporter.noiseImporter``.
    """

    # copied from nuradiomc_tpu/reco/measured_noise.py:43-99 (the reader on
    # the module's device)
    def begin(self, noise_folders, file_pattern="*",
              match_station_id=False, station_ids=None,
              channel_mapping=None, scramble_noise_file_order=True,
              log_level=logging.NOTSET, random_seed=None, reader_kwargs=None):
        """
        noise_folders: folder(s) containing noise runs; searched
            recursively for ``{pattern}root`` (mattak) and ``{pattern}npz``
            (the in-repo export backend).
        match_station_id: only add noise from the simulated station's id.
        station_ids: restrict the allowed data station ids.
        channel_mapping: MC channel id -> data channel id (None = 1:1).
        scramble_noise_file_order: shuffle run folders before reading.
        random_seed: seeds the Philox generator (reference:63).
        reader_kwargs: forwarded to readRNOGData.begin (overrides the
            FORCE-trigger / physics-run defaults).
        """
        from nuradiomc_tpu_torch.reco.rnog_io import readRNOGData

        if log_level:
            logger.setLevel(log_level)
        self._rng = np.random.Generator(np.random.Philox(random_seed))
        self._match_station_id = match_station_id
        self._station_ids = station_ids
        self._channel_mapping = channel_mapping

        if not isinstance(noise_folders, (list, tuple)):
            noise_folders = [noise_folders]
        noise_files = []
        for folder in noise_folders:
            if not folder:
                continue
            for ext in ("root", "npz"):
                noise_files += glob.glob(f"{folder}/**/{file_pattern}{ext}",
                                         recursive=True)
        self._noise_folders = np.unique(
            [os.path.dirname(e) for e in noise_files])
        if not len(self._noise_folders):
            raise FileNotFoundError(
                f"No noise run folders found under {noise_folders}")
        if scramble_noise_file_order:
            self._rng.shuffle(self._noise_folders)

        self._noise_reader = readRNOGData(device=self.device)
        kwargs = {
            "selectors": [lambda einfo: einfo.triggerType == "FORCE"],
            "select_runs": True,
            "max_trigger_rate": 2 * units.Hz,
            "run_types": ("physics",),
        }
        kwargs.update(reader_kwargs or {})
        self._noise_reader.begin(list(self._noise_folders), **kwargs)

        info = self._noise_reader.get_events_information(keys=("station",))
        self._event_index_list = np.array(list(info.keys()))
        self._station_id_list = np.array(
            [e["station"] for e in info.values()])
        self._n_use_event = collections.defaultdict(int)

    def _get_noise_channel(self, channel_id):
        if self._channel_mapping is None:
            return channel_id
        return self._channel_mapping[channel_id]

    def _draw_noise_event(self, mask):
        """Redraw (<=100 tries) while the drawn event fails the reader's
        selectors, where the reader would return None (reference:124-157)."""
        reader = self._noise_reader
        for _ in range(100):
            i_noise = int(self._rng.choice(self._event_index_list[mask]))
            if reader._select_events(reader.event_info_by_index(i_noise)):
                self._n_use_event[i_noise] += 1
                return i_noise
        raise ValueError("Could not draw a random station which is not "
                         "None after 100 tries. Stop.")

    def _station_mask(self, station):
        if not self._match_station_id:
            return np.ones(len(self._event_index_list), dtype=bool)
        station_mask = self._station_id_list == station.get_id()
        if not np.any(station_mask):
            raise ValueError(f"No station with id {station.get_id()} "
                             "in noise data.")
        return station_mask

    def draw(self, stations):
        """One noise event (global reader index) per simulated station, in
        order."""
        draws = []
        for station in stations:
            i_noise = self._draw_noise_event(self._station_mask(station))
            station_id = self._noise_reader.event_info_by_index(i_noise).station
            if self._station_ids is not None and station_id not in self._station_ids:
                raise ValueError(f"Station id {station_id} not in list of "
                                 f"allowed ids: {self._station_ids}")
            draws.append(i_noise)
        return draws

    def run_events(self, pairs):
        """Noise onto every (event, station) of ``pairs``, in chunks of
        ``rows_per_chunk`` stations; returns the drawn noise event indices."""
        all_draws = []
        at = 0
        while at < len(pairs):
            n_ch = max(pairs[at][1].get_number_of_channels(), 1)
            rows = rows_per_chunk(2 * n_ch * 2048 * 8 * 4, self.device, len(pairs) - at)
            chunk = pairs[at:at + rows]
            at += rows
            draws = self.draw([st for _, st in chunk])
            all_draws += draws
            uniq, pos = np.unique(draws, return_inverse=True)
            infos, noise = self._noise_reader.events_by_index(uniq)
            sims, rows_ev, rows_ch, chans = [], [], [], []
            for k, (_, station) in enumerate(chunk):
                info = infos[pos[k]]
                fs_noise = self._noise_reader._sampling_rate(info)
                logger.debug("Selected noise event %d (run %s, event %s)", draws[k],
                             info.run, info.eventNumber)
                for channel in station.iter_channels():
                    trace = channel.get_trace()
                    data_ch = self._get_noise_channel(channel.get_id())
                    if not 0 <= data_ch < noise.shape[1]:
                        raise KeyError(data_ch)
                    n_noise = noise.shape[-1]
                    if len(trace) > 2048:
                        logger.warning("Simulated trace is longer than 2048 bins..."
                                       " trim with :2048")
                        trace = trace[:2048]
                    if len(trace) != n_noise:
                        raise ValueError(
                            f"Mismatch in trace length: Noise has "
                            f"{n_noise} and simulation has {len(trace)} "
                            "samples")
                    if channel.get_sampling_rate() != fs_noise:
                        raise ValueError(
                            "Mismatch in sampling rate: Noise has {} and simulation"
                            " has {} GHz".format(
                                fs_noise / units.GHz,
                                channel.get_sampling_rate() / units.GHz))
                    sims.append(trace)
                    rows_ev.append(pos[k])
                    rows_ch.append(data_ch)
                    chans.append(channel)
            if not chans:
                continue
            noisy = self.tensor(np.array(sims, dtype=float)) + noise[
                torch.as_tensor(rows_ev, device=self.device),
                torch.as_tensor(rows_ch, device=self.device)]
            for channel, tr in zip(chans, host(noisy)):
                channel.set_trace(tr, channel.get_sampling_rate())
        return all_draws

    @register_run()
    def run(self, evt, station, det):
        self.run_events([(evt, station)])

    def end(self):
        self._noise_reader.end()
        n_use = np.array(list(self._n_use_event.values()))
        if len(n_use):
            top = np.sort(n_use)[::-1][:5]
            logger.info("The five most used noise events have been used: "
                        "%s", ", ".join(str(v) for v in top))


class ARIANNANoiseImporter(Module):
    """ARIANNA measured-noise importer (noiseImporterROOT.py:10-57).

    The recorded noise must match the station geometry and sampling (use
    channelResampler / channelLengthAdjuster first). Per CHANNEL a random
    CalibTree entry is drawn (the reference redraws inside the channel
    loop) and its mV waveform added. Backends: ROOT TChain("CalibTree")
    when pyroot is importable, else ``caltree_export.npz`` with
    ``amp_out [N_events, N_channels, N_samples]`` in mV.
    """

    # copied from nuradiomc_tpu/reco/measured_noise.py:187-205 (the table
    # on the module's device)
    def begin(self, noise_files, random_seed=None):
        self._rng = np.random.Generator(np.random.Philox(random_seed))
        if len(noise_files) > 1:
            logger.warning("Only using the first noise file, more is not "
                           "implemented yet")
        path = noise_files[0]
        if str(path).endswith(".npz"):
            data = np.load(path)
            self._amp_out = self.tensor(np.asarray(data["amp_out"], dtype=float))
            self._nevts = self._amp_out.shape[0]
            self._root = None
        else:
            import ROOT  # import-gated: experiment raw data needs pyroot

            self._root = ROOT.TChain("CalibTree")
            self._root.Add(path)
            self._data = ROOT.TSnCalWvData()
            self._root.SetBranchAddress("AmpOutData.", self._data)
            self._nevts = self._root.GetEntries()

    def _entry(self):
        """One CalibTree entry, the reference's ``integers(0, nevts + 1)``
        clamped to the last entry."""
        return min(int(self._rng.integers(0, self._nevts + 1)), self._nevts - 1)

    def _root_noise(self, i, channel_id, n_samples):
        self._root.GetEntry(i)
        if self._data.GetNumSamplesOn(0) != n_samples:
            return None
        return np.array(self._data.GetDataOnCh(channel_id)) * units.mV

    def run_events(self, pairs):
        """Noise onto every channel of every (event, station) of ``pairs``:
        the draws in the JAX loops' order, then one gather and one addition
        on the device. Returns the drawn entries, one per channel."""
        draws, chans, sims, rows_i, rows_ch = [], [], [], [], []
        for _, station in pairs:
            for channel in station.iter_channels():
                trace = channel.get_trace()
                i = self._entry()
                draws.append(i)
                if self._root is not None:
                    noise = self._root_noise(i, channel.get_id(), trace.shape[0])
                    if noise is None:
                        logger.warning("Mismatch in sample count — not adding noise!")
                        continue
                    channel.set_trace(noise + trace, channel.get_sampling_rate())
                    continue
                if not 0 <= channel.get_id() < self._amp_out.shape[1]:
                    raise IndexError(f"channel {channel.get_id()} is not in the noise table")
                if self._amp_out.shape[-1] != trace.shape[0]:
                    logger.warning("Mismatch in sample count — not adding noise!")
                    continue
                chans.append(channel)
                sims.append(trace)
                rows_i.append(i)
                rows_ch.append(channel.get_id())
        if chans:
            n = len(sims[0])
            rows = rows_per_chunk(n * 8 * 4, self.device, len(chans))
            for at in range(0, len(chans), rows):
                idx_i = torch.as_tensor(rows_i[at:at + rows], device=self.device)
                idx_c = torch.as_tensor(rows_ch[at:at + rows], device=self.device)
                noisy = (self._amp_out[idx_i, idx_c] * units.mV
                         + self.tensor(np.array(sims[at:at + rows], dtype=float)))
                for channel, tr in zip(chans[at:at + rows], host(noisy)):
                    channel.set_trace(tr, channel.get_sampling_rate())
        return draws

    @register_run()
    def run(self, evt, station, det):
        self.run_events([(evt, station)])

    def end(self):
        pass


# reference-compatible aliases (module-path class name is `noiseImporter`)
noiseImporter = RNOGNoiseImporter
noiseImporterARIANNA = ARIANNANoiseImporter
