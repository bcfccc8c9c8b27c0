# frozen copy of the parts of nuradiomc_tpu_torch/sim/simulation.py (commit
# 493e4d9) that one job of the benchmark's configurations takes: the Vrms
# calibration (:221-256), the channel tensors (:448-553), the trigger
# settings (:410-446), the padded batch with the Alvarez2009 draws
# (:119-136, :555-649), the noise generator per chunk (:670-681), the chunk
# loop (:698-770) and the Veff sum (:772-812); nuradiomc_tpu_torch/sim/
# evtgen.py:536-551 (group_into_events); the detector fields of
# nuradiomc_tpu_torch/detector/detector.py:147-200.
"""One job of the reference: what ``Simulation(list, detector, config=...,
filter_chain=..., trigger=..., antenna_replacements=..., chunk_size=...,
dtype=...).run()`` returns for a single station with analytic antennas,
worked out anew from the event list and the configuration file.

This is the reference of a configuration whose file names none (the
harness's default for the key ``"reference"``). Any module that a
configuration names there keeps this module's contract: ``Job(cfg, device,
dtype)`` with ``Vrms`` (the noise RMS) and ``run(list_path, seed)``
returning ``group_ids``, ``triggered``, ``multiple_triggers``,
``trigger_times_per_trigger``, ``trigger_times``, ``max_amplitude``,
``weights`` and ``veff`` as below, and ``triggered_per_station`` ({station
id: decision per group}) where it decides per station; it imports nothing of
the program."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import (antenna, askaryan, filters, ice as ice_models,
                                 phased_array, units, weights as weights_ref)
from portbench.reference.chain import Settings, TriggerSettings, simulate_chunk
from portbench.reference.constants import boltzmann


def read_list(path) -> dict:
    """The columns (``col_<name>``) and attributes (``attr_<name>``) of an
    event-list ``.npz`` as one dict of numpy arrays and scalars."""
    with np.load(path, allow_pickle=False) as z:
        out = {k[4:]: z[k] for k in z.files if k.startswith("col_")}
        out["attrs"] = {k[5:]: z[k][()] for k in z.files if k.startswith("attr_")}
    return out


def _detector_channels(det: dict):
    """Station id, absolute position and the per-channel fields, channels
    ordered by id, angles in radians, sampling frequency in GHz."""
    st = list(det["stations"].values())[0]
    sid = int(st["station_id"])
    chs = sorted((c for c in det["channels"].values() if int(c["station_id"]) == sid),
                 key=lambda c: int(c["channel_id"]))

    def col(key, default=None, dtype=float):
        return np.array([default if c.get(key) is None else c[key] for c in chs], dtype=dtype)

    return {
        "positions": np.stack([col("ant_position_x"), col("ant_position_y"),
                               col("ant_position_z")], axis=-1),
        "orientation_theta": np.deg2rad(col("ant_orientation_theta")),
        "orientation_phi": np.deg2rad(col("ant_orientation_phi")),
        "rotation_theta": np.deg2rad(col("ant_rotation_theta")),
        "rotation_phi": np.deg2rad(col("ant_rotation_phi")),
        "cable_delay": col("cab_time_delay", 0.0),
        "n_samples": col("adc_n_samples", dtype=int),
        "sampling_frequency": col("adc_sampling_frequency") * units.GHz,
        "antenna_model": [c["ant_type"] for c in chs],
        "adc_nbits": col("adc_nbits", -1, dtype=int),
        "absolute_position": np.array([st.get("pos_easting") or 0.0,
                                       st.get("pos_northing") or 0.0,
                                       st.get("pos_altitude") or 0.0], dtype=float),
    }


def _group_into_events(start_times, split_time_gap):
    start_times = np.asarray(start_times)
    order = np.argsort(start_times, kind="stable")
    event_idx = np.zeros(len(start_times), dtype=int)
    current = 0
    for k in range(1, len(order)):
        if start_times[order[k]] - start_times[order[k - 1]] > split_time_gap:
            current += 1
        event_idx[order[k]] = current
    return event_idx


class Job:
    """The reference's set-up of one configuration (``cfg``: the
    configuration file's dict) in ``dtype`` on ``device``."""

    def __init__(self, cfg: dict, device, dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.config = cfg["config"]
        self.chunk_size = int(cfg["chunk_size"])
        self.filter_chain = [(tuple(f["passband"]), f["filter_type"], f.get("kwargs", {}))
                             for f in cfg["filter_chain"]]
        self.trigger = cfg["trigger"]
        self.replacements = cfg.get("antenna_replacements", {})
        self.ch = _detector_channels(cfg["detector"])
        conf = self.config
        ch = self.ch
        self.rate = float(conf["sampling_rate"])
        dt = 1.0 / self.rate
        n = ch["n_samples"][0] / ch["sampling_frequency"][0] / dt
        self.n_internal = int(np.ceil(n / 2.0) * 2)
        pad = int(np.ceil(0.25 * self.n_internal / 128.0) * 128)
        self.n_base = max(2048, self.n_internal + pad)

        # Vrms from the filter chain's bandwidth (thermal noise at the
        # configured temperature)
        ff_cal = np.linspace(0, 0.5 * self.rate, 10000)
        filt = filters.chain_response(ff_cal, self.filter_chain, fs=self.rate)
        bw = np.trapezoid(np.abs(filt) ** 2, ff_cal)
        vrms_cfg = conf["trigger"]["Vrms"]
        self.Vrms = (float(vrms_cfg) if vrms_cfg is not None else float(np.sqrt(
            float(conf["trigger"]["noise_temperature"]) * 50 * units.ohm * bw * boltzmann)))
        max_amp = float(np.abs(filt).max()) if self.filter_chain else 1.0
        self.Vrms_efield = self.Vrms / max_amp / units.m
        noise_amp = self.Vrms / np.sqrt(bw / (0.5 * self.rate))
        C = len(ch["antenna_model"])

        freqs_int = np.fft.rfftfreq(self.n_internal, dt)
        freqs_base = np.fft.rfftfreq(self.n_base, dt)
        rot = np.zeros((C, 3, 3))
        kind = np.zeros(C, dtype=np.int64)
        templates = np.zeros((C, 3, len(freqs_int)), dtype=complex)
        for i in range(C):
            model = self.replacements.get(ch["antenna_model"][i], ch["antenna_model"][i])
            kind[i] = antenna.ANALYTIC_MODELS[model][0]
            tpl = antenna.build_analytic_template(model, freqs_int)
            templates[i, :tpl.shape[0]] = tpl
            if tpl.shape[0] == 1:
                templates[i, 1:] = tpl[0]
            rot[i] = antenna.antenna_rotation_matrix(
                ch["orientation_theta"][i], ch["orientation_phi"][i],
                ch["rotation_theta"][i], ch["rotation_phi"][i],
                model_orientation=antenna._MODEL_ORIENTATION)
        ctype = torch.complex64 if dtype == torch.float32 else torch.complex128

        def real(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                                   device=self.device)

        resp_base = filters.chain_response(freqs_base, self.filter_chain, fs=self.rate)
        self.chan = {
            "positions": real(ch["positions"] + ch["absolute_position"]),
            "cable_delays": real(ch["cable_delay"]),
            "rot": real(rot),
            "kind": torch.as_tensor(kind, device=self.device),
            "templates": torch.as_tensor(templates, dtype=ctype, device=self.device),
            "filter_response": torch.as_tensor(np.stack([resp_base] * C), dtype=ctype,
                                               device=self.device),
            "noise_amplitude": real(np.full(C, noise_amp)),
            "min_efield_amplitude": real(np.full(
                C, float(conf["speedup"]["min_efield_amplitude"]) * self.Vrms_efield)),
        }
        prop = conf["propagation"]
        if prop["attenuation_model"] != "SP1" or int(prop.get("n_reflections") or 0):
            raise NotImplementedError("the reference covers SP1 without reflections")
        self.settings = Settings(
            ice=ice_models.get_ice_model(prop["ice_model"]),
            triggers=(self._trigger_settings(),),
            askaryan_model=conf["signal"]["model"],
            n_internal=self.n_internal, n_base=self.n_base, sampling_rate=self.rate,
            delta_C_cut=float(conf["speedup"]["delta_C_cut"]),
            n_freq_attenuation=int(prop["n_freq"]),
            max_detector_freq=float(np.max(ch["sampling_frequency"])) * 0.5,
            apply_focusing=bool(prop["focusing"]),
            focusing_limit=float(prop["focusing_limit"]),
            add_noise=bool(conf["noise"]))

    def _trigger_settings(self) -> TriggerSettings:
        t = self.trigger
        ch = self.ch
        if t["trigger_type"] == "phased_array":
            det_fs = float(ch["sampling_frequency"][0])
            up = int(t["pa_upsampling"])
            rolls = phased_array.beam_rolls(ch["positions"][:, 2], ch["cable_delay"],
                                            np.asarray(t["pa_phasing_angles"]),
                                            t["pa_ref_index"], det_fs * up)
            n_bits = int(ch["adc_nbits"][0]) if ch["adc_nbits"][0] > 0 else 8
            return TriggerSettings(
                name=t["name"], trigger_type="phased_array",
                pa_rolls=tuple(tuple(int(v) for v in row) for row in rolls),
                pa_window=int(t["pa_window_ns"] * det_fs * up),
                pa_step=int(t["pa_step_ns"] * det_fs * up), pa_upsampling=up,
                pa_threshold=t["pa_threshold_factor"] * self.Vrms ** 2,
                pa_adc_fs=det_fs, pa_adc_nbits=n_bits,
                pa_adc_range=self.Vrms * (2 ** n_bits - 1) / (t["pa_adc_noise_count"] or 15))
        return TriggerSettings(
            name=t["name"], trigger_type=t["trigger_type"],
            threshold_high=float(t["threshold_high_sigma"] * self.Vrms),
            threshold_low=float(t["threshold_low_sigma"] * self.Vrms),
            highlow_coincidence=t["highlow_coincidence"],
            number_of_coincidences=t["number_of_coincidences"],
            channel_coincidence=t["channel_coincidence"])

    def batches(self, lst: dict, seed: int):
        """(group ids, first row of each group, the padded host batch)."""
        gids = np.asarray(lst["event_group_ids"], dtype=np.int64)
        order = np.argsort(gids, kind="stable")
        group_ids, start, count = np.unique(gids[order], return_index=True,
                                            return_counts=True)
        split_gap = float(self.config.get("split_event_time_diff", 1e6))
        if np.any(count > 1):
            new_order, new_start, new_count, new_gids = [], [], [], []
            pos = 0
            for g in range(len(group_ids)):
                rows = order[start[g]:start[g] + count[g]]
                sub = _group_into_events(lst["vertex_times"][rows], split_gap)
                for s_idx in np.unique(sub):
                    sel = rows[sub == s_idx]
                    new_order.append(sel)
                    new_start.append(pos)
                    new_count.append(len(sel))
                    new_gids.append(group_ids[g])
                    pos += len(sel)
            order = np.concatenate(new_order)
            start = np.asarray(new_start, dtype=np.int64)
            count = np.asarray(new_count, dtype=np.int64)
            group_ids = np.asarray(new_gids, dtype=group_ids.dtype)
        S = int(count.max())
        slot = np.arange(S)[None, :]
        mask = slot < count[:, None]
        rows = order[np.minimum(start[:, None] + slot, len(order) - 1)]

        def pad(col):
            return np.where(mask, np.asarray(col, dtype=np.float64)[rows], 0.0)

        dt = np.float64 if self.dtype == torch.float64 else np.float32
        energies = pad(lst["shower_energies"]).astype(dt)
        mask = mask & (energies > 0)
        zen, az = pad(lst["zeniths"]).astype(dt), pad(lst["azimuths"]).astype(dt)
        axis = np.stack([np.sin(zen) * np.cos(az), np.sin(zen) * np.sin(az), np.cos(zen)],
                        axis=-1)
        is_em = pad(lst["shower_type"] == "em") > 0.5
        k_L = np.zeros_like(energies)
        if self.config["signal"]["model"] == "Alvarez2009":
            rng = np.random.default_rng(np.random.Philox(int(seed)))
            k_L = askaryan.draw_alvarez2009_k_L(np.maximum(energies, 1.0), is_em,
                                                rng).astype(dt)
        batch = {
            "vertices": np.stack([pad(lst["xx"]), pad(lst["yy"]), pad(lst["zz"])],
                                 axis=-1).astype(dt),
            "energies": energies, "is_em": is_em, "shower_mask": mask,
            "prop_dir": (-axis).astype(dt), "k_L": k_L,
            "vertex_times": pad(lst["vertex_times"]).astype(dt)}
        return group_ids, order[start], batch

    def noise_generator(self, seed, chunk_index):
        """Chunk i's generator, seeded from SeedSequence([seed, 0, i])."""
        if not self.settings.add_noise:
            return None
        seq = np.random.SeedSequence([int(seed), 0, int(chunk_index)])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seq.generate_state(1, np.uint64)[0]))
        return gen

    def run(self, list_path, seed: int, weight_dtype=np.float64) -> dict:
        """The results of one job: per group the decision, the decision per
        trigger, the trigger times, the readout amplitude per channel, the
        weight; and the job's Veff. ``seed`` is the configuration's seed."""
        lst = read_list(list_path)
        group_ids, first, batch = self.batches(lst, seed)
        G = len(group_ids)
        C = self.chan["positions"].shape[0]
        w = weights_ref.get_weight(
            lst["zeniths"][first], lst["energies"][first], lst["flavors"][first],
            mode=self.config["weights"]["weight_mode"],
            cross_section_type=self.config["weights"]["cross_section_type"],
            vertex_position=np.c_[lst["xx"][first], lst["yy"][first], lst["zz"][first]],
            phi_nu=lst["azimuths"][first], dtype=weight_dtype)
        trig_per = np.zeros((G, 1), dtype=bool)
        tt_per = np.zeros((G, 1))
        max_amp = np.zeros((G, C))
        for i in range(-(-G // self.chunk_size)):
            sl = slice(i * self.chunk_size, min((i + 1) * self.chunk_size, G))
            chunk = {k: torch.as_tensor(np.ascontiguousarray(v[sl]), device=self.device)
                     for k, v in batch.items()}
            tp, ttp, amp = simulate_chunk(chunk, self.chan, self.settings,
                                          self.noise_generator(seed, i))
            trig_per[sl] = tp.cpu().numpy()
            tt_per[sl] = ttp.cpu().numpy()
            max_amp[sl] = amp.cpu().numpy()
        triggered = trig_per.any(axis=1)
        min_weight = float(self.config["speedup"]["minimum_weight_cut"])
        eff = np.where(w < min_weight, 0.0, w)
        uniq, inv = np.unique(group_ids, return_inverse=True)
        trig_parent = np.zeros(len(uniq), dtype=bool)
        np.logical_or.at(trig_parent, inv, triggered)
        w_parent = np.zeros(len(uniq), dtype=eff.dtype)
        w_parent[inv] = eff
        attrs = lst["attrs"]
        veff = float(attrs["volume"]) * float(np.sum(w_parent * trig_parent)) / int(
            attrs["n_events"])
        return {"group_ids": group_ids, "triggered": triggered,
                "multiple_triggers": trig_per,
                "trigger_times_per_trigger": np.where(trig_per, tt_per, np.nan),
                "trigger_times": np.where(triggered, tt_per[:, 0], 0.0),
                "max_amplitude": max_amp, "weights": w, "veff": veff}
