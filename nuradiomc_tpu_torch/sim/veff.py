# copied from nuradiomc_tpu/sim/veff.py:1-408, with projected_area and aeff_from_results
# added and get_Veff_Aeff_single split into read_veff_rows and veff_aeff_of_rows (the
# port keeps its own copy; it imports nothing of the JAX package)
"""Effective-volume / effective-area post-processing.

Re-implementation of NuRadioMC/utilities/Veff.py: per-file Veff/Aeff with
weights, Feldman-Cousins count limits (FC_limits:56), water-equivalent
conversion (get_Veff_water_equivalent:132), zenith binning, and multi-file
aggregation (get_Veff_Aeff:484). Operates on the per-shower output HDF5
written by sim.io_hdf5 (reference schema subset).

Each function that reads or writes HDF5 imports h5py inside itself, so the
module imports without h5py; these tables are the campaign's last step and
are computed where h5py is installed, from the output file of
``Simulation(outputfilename=)``.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from nuradiomc_tpu_torch.utils import units

# Feldman-Cousins 68.27% intervals for low counts (Veff.py:56-130 table)
_FC_LOW = [0.0, 0.37, 0.74, 1.10, 2.34, 2.75, 3.82, 4.25, 5.30, 6.33, 6.78,
           7.81, 8.83, 9.28, 10.30, 11.32, 12.33, 12.79, 13.81, 14.82, 15.83]
_FC_HIGH = [1.29, 2.75, 4.25, 5.30, 6.78, 7.81, 9.28, 10.30, 11.32, 12.79,
            13.81, 14.82, 16.29, 17.30, 18.32, 19.32, 20.80, 21.81, 22.82,
            23.82, 25.30]


def FC_limits(counts):
    """68.27% Feldman-Cousins confidence belt on a Poisson count."""
    n = int(round(counts))
    if n < len(_FC_LOW):
        return _FC_LOW[n], _FC_HIGH[n]
    return counts - np.sqrt(counts), counts + np.sqrt(counts)


def get_Veff_water_equivalent(veff, density_medium=0.917 * units.g / units.cm ** 3,
                              density_water=1 * units.g / units.cm ** 3):
    """Scale to water-equivalent volume (Veff.py:132-151)."""
    return veff * density_medium / density_water


def get_veff_output(volume, counts, all_events):
    v_eff = volume * counts / all_events
    fc_low, fc_high = FC_limits(counts)
    v_eff_error = v_eff / np.sqrt(counts) if counts else 0.0
    return [v_eff, v_eff_error, counts,
            volume * fc_low / all_events, volume * fc_high / all_events]


def projected_area(area, thetamin, thetamax):
    """The generation area of surface muons projected perpendicular to the
    flux (Veff.py:268-275, T03check_output.py:11-31)."""
    return area * 0.5 * (abs(np.cos(thetamin)) + abs(np.cos(thetamax)))


def aeff_from_results(results: dict, min_weight: float = 0.0) -> float:
    """Aeff of a surface-muon run from ``Simulation.run``'s results dict
    (no file, no h5py): the projected generation area times the weighted
    count of triggered event groups over the number of events, as
    ``get_Veff_Aeff_single(..., veff_aeff="aeff_surface_muons")`` computes
    it from the output file; weights below ``min_weight`` count as 0."""
    gids, first = np.unique(results["group_ids"], return_index=True)
    trig = np.zeros(len(gids), dtype=bool)
    np.logical_or.at(trig, np.searchsorted(gids, results["group_ids"]), results["triggered"])
    w = np.asarray(results["weights"], dtype=float)[first]
    w = np.where(w < min_weight, 0.0, w)
    return (projected_area(results["area"], results["thetamin"], results["thetamax"])
            * float(np.sum(w[trig])) / results["n_events"])


def remove_duplicate_triggers(triggered, gids):
    """At most one True per event group (Veff.py:19-54): the HDF5 has one row
    per shower; counting every shower of a multi-shower event would
    overestimate the effective volume."""
    gids = np.asarray(gids)
    triggered = np.asarray(triggered, dtype=bool)
    out = np.zeros_like(triggered)
    # first triggered row of each triggered gid
    trig_gids = np.where(triggered, gids + 0.5, 0.0)
    _, idx = np.unique(trig_gids, return_index=True)
    sel = idx[trig_gids[idx] > 0]
    out[sel] = True
    return out


# the top-level datasets and attributes of an output file that the tables read
ROW_KEYS = ("event_group_ids", "triggered", "weights", "zeniths", "energies",
            "multiple_triggers", "shower_ids")
ATTR_KEYS = ("n_events", "thetamin", "thetamax", "trigger_names", "Vrms", "volume", "area")


def read_veff_rows(filename, station=None) -> dict:
    """What :func:`veff_aeff_of_rows` reads of one output file: its
    top-level per-shower datasets and attributes under their HDF5 names,
    and, with ``station=``, the station's per-group amplitudes
    (``station_amps``) and per-ray data (``station_rays``)."""
    import h5py

    with h5py.File(filename, "r") as f:
        rows = {k: np.asarray(f[k]) for k in ROW_KEYS if k in f}
        rows.update({k: f.attrs[k] for k in ATTR_KEYS if k in f.attrs})
        if station is not None and f"station_{station}" in f:
            sg = f[f"station_{station}"]
            if "event_group_ids" in sg:
                rows["station_amps"] = {
                    "gids": np.asarray(sg["event_group_ids"]),
                    "amps": np.asarray(sg["maximum_amplitudes_envelope"]),
                }
            if "max_amp_shower_and_ray" in sg:
                rows["station_rays"] = {
                    "gid": np.asarray(sg["event_group_id_per_shower"]),
                    "sid": np.asarray(sg["shower_id"]),
                    "amps": np.asarray(sg["max_amp_shower_and_ray"]),
                    "sol_type": np.asarray(sg["ray_tracing_solution_type"]),
                    "reflection": np.asarray(sg["ray_tracing_reflection"]),
                }
    return rows


def get_Veff_Aeff_single(filename, trigger_combinations=None,
                         bounds_theta=(0, np.pi), min_weight=1e-5,
                         station=None, veff_aeff="veff"):
    """Veff/Aeff of one output file (Veff.py:168-480): :func:`veff_aeff_of_rows`
    of the file's :func:`read_veff_rows`.

    Top-level keys (veff, n_triggered, weight_sum, ...) describe the OR of
    all named triggers. ``veffs`` holds per-trigger-name entries
    ``[veff, veff_error, weighted_count, fc_low, fc_high]`` from the
    ``multiple_triggers`` matrix (one column per ``trigger_names`` attr), plus
    one entry per ``trigger_combinations`` item.

    trigger_combinations : dict, optional
        name -> {'triggers': [names] OR'd together,
                 'triggerAND': name, 'notriggers': [names],
                 'efficiency': {'func': SNR->eff, 'channel_ids': [...],
                                'scale': float}}
        (Veff.py:341-480 semantics), plus 'min_sigma'/'channels'/'n_channels'
        (pre-noise per-ray amplitude cut, SNR reported in out['SNR']),
        'ray_solution'/'ray_channel' (strongest-solution type selection) and
        'n_reflections' (strongest solution's bottom-bounce count) — these
        three need ``station=`` to reach the per-ray station data.

    veff_aeff : 'veff' | 'aeff_surface_muons'
        For surface muons the generation *area* attr is projected
        perpendicular to the flux (Veff.py:268-275).
    """
    return veff_aeff_of_rows(read_veff_rows(filename, station), trigger_combinations,
                             bounds_theta, min_weight, veff_aeff)


def veff_aeff_of_rows(rows, trigger_combinations=None, bounds_theta=(0, np.pi),
                      min_weight=1e-5, veff_aeff="veff"):
    """:func:`get_Veff_Aeff_single`'s table from the rows and attributes of
    an output file (a mapping with :func:`read_veff_rows`'s keys, or the
    ``.npz`` of the same rows), with no file and no h5py."""
    gid = np.asarray(rows["event_group_ids"])
    triggered = np.asarray(rows["triggered"])
    weights = np.asarray(rows["weights"])
    zeniths = np.asarray(rows["zeniths"])
    energies = np.asarray(rows["energies"])
    n_events = int(rows["n_events"])
    thetamin = float(rows.get("thetamin", 0.0))
    thetamax = float(rows.get("thetamax", np.pi))
    trigger_names = [t.decode() if isinstance(t, bytes) else str(t)
                     for t in rows.get("trigger_names", [])]
    mt = (np.asarray(rows["multiple_triggers"])
          if "multiple_triggers" in rows else triggered[:, None])
    vrms = float(rows.get("Vrms", 1.0))
    if veff_aeff == "veff":
        volume = float(rows["volume"])
    elif veff_aeff == "aeff_surface_muons":
        volume = projected_area(float(rows["area"]), thetamin, thetamax)
    else:
        raise AttributeError(veff_aeff)
    station_amps = rows.get("station_amps", {})
    station_rays = rows.get("station_rays", {})
    shower_ids = (np.asarray(rows["shower_ids"]) if "shower_ids" in rows
                  else np.arange(len(gid)))

    if not trigger_names:
        trigger_names = [f"trigger_{i}" for i in range(mt.shape[1])]
    name_to_col = {n: i for i, n in enumerate(trigger_names)}

    # zenith-band restriction: events outside are zero-weighted and n_events
    # rescaled by the cos(theta) fraction (Veff.py:256-266, 320-326)
    w_all = weights.copy()
    if bounds_theta is not None:
        b0, b1 = max(min(bounds_theta), thetamin), min(max(bounds_theta), thetamax)
        frac = (abs(np.cos(b0) - np.cos(b1))
                / max(abs(np.cos(thetamin) - np.cos(thetamax)), 1e-12))
        if frac < 1:
            n_events = n_events * frac
            w_all = w_all * ((zeniths > b0) & (zeniths < b1))
        thetamin, thetamax = b0, b1

    def veff_of(mask):
        mask = remove_duplicate_triggers(mask, gid)
        return get_veff_output(volume, float(np.sum(w_all[mask])), n_events)

    def _rays_per_row(key):
        """Station per-(shower, channel, solution) array mapped onto the
        top-level row order (NaN where the station has no row): the station
        group stores only simulated/triggered showers, Veff row masks index
        the full per-shower table (Veff.py:375-405 uses the same quantity)."""
        if not station_rays:
            return None
        src = station_rays[key]
        out_arr = np.full((len(gid),) + src.shape[1:], np.nan, src.dtype
                          if np.issubdtype(src.dtype, np.floating)
                          else np.float64)
        row_of = {(int(g), int(s)): i for i, (g, s) in
                  enumerate(zip(station_rays["gid"], station_rays["sid"]))}
        for i, (g, s) in enumerate(zip(gid, shower_ids)):
            j = row_of.get((int(g), int(s)))
            if j is not None:
                out_arr[i] = src[j]
        return out_arr

    veffs = {}
    snr_out = {}
    for name, col in name_to_col.items():
        veffs[name] = veff_of(mt[:, col].astype(bool))

    for name, values in (trigger_combinations or {}).items():
        indiv = values["triggers"]
        if isinstance(indiv, str):
            indiv = [indiv]
        mask = np.zeros(mt.shape[0], dtype=bool)
        for t in indiv:
            mask |= mt[:, name_to_col[t]].astype(bool)
        if "triggerAND" in values:
            mask &= mt[:, name_to_col[values["triggerAND"]]].astype(bool)
        for t in np.atleast_1d(values.get("notriggers", [])):
            mask &= ~mt[:, name_to_col[str(t)]].astype(bool)
        if "min_sigma" in values:
            # pre-noise per-ray amplitude cut (Veff.py:366-393): at least
            # n_channels of `channels` must exceed min_sigma*Vrms on their
            # best ray solution; the SNR of the n-th-largest channel is
            # reported per surviving row
            amps = _rays_per_row("amps")
            if amps is None:
                raise ValueError(
                    "min_sigma needs station= and per-ray station data")
            As = np.max(np.nan_to_num(amps), axis=-1)          # [rows, C]
            ms, chans, nch = values["min_sigma"], values["channels"], \
                values["n_channels"]
            if isinstance(ms, list):
                snr_out[name] = {}
                masks = np.zeros_like(mask)
                for iS in range(len(ms)):
                    Asub = As[:, np.asarray(chans[iS], dtype=int)]
                    m = (np.sum(Asub >= ms[iS] * vrms, axis=1) >= nch[iS])
                    masks |= m
                    snr_out[name][iS] = (np.sort(Asub, axis=1)
                                         [:, -int(nch[iS])][m] / vrms)
                mask &= masks
            else:
                Asub = As[:, np.asarray(chans, dtype=int)]
                m = np.sum(Asub >= ms * vrms, axis=1) >= nch
                snr_out[name] = np.sort(Asub, axis=1)[m] / vrms
                mask &= m
        if "ray_solution" in values:
            # keep rows whose strongest solution on `ray_channel` is of the
            # requested type (Veff.py:395-400)
            amps = _rays_per_row("amps")
            sol = _rays_per_row("sol_type")
            if amps is None:
                raise ValueError(
                    "ray_solution needs station= and per-ray station data")
            rc = int(values["ray_channel"])
            best = np.argmax(np.nan_to_num(amps[:, rc, :]), axis=-1)
            mask &= (sol[np.arange(len(best)), rc, best]
                     == float(values["ray_solution"]))
        if "n_reflections" in values:
            # keep rows whose overall strongest (channel, solution) has the
            # requested bottom-bounce count (Veff.py:402-408 intent)
            amps = _rays_per_row("amps")
            refl = _rays_per_row("reflection")
            if amps is None:
                raise ValueError(
                    "n_reflections needs station= and per-ray station data")
            flat = np.nan_to_num(amps).reshape(len(gid), -1)
            best = np.argmax(flat, axis=-1)
            mask &= (refl.reshape(len(gid), -1)[np.arange(len(best)), best]
                     == float(values["n_reflections"]))
        mask = remove_duplicate_triggers(mask, gid)
        v, v_err, c, v_lo, v_hi = get_veff_output(
            volume, float(np.sum(w_all[mask])), n_events)
        if "efficiency" in values and v > 0 and station_amps:
            # analysis-efficiency reweighting by the per-group SNR
            # (Veff.py:415-478): weight each triggered group by eff(SNR)
            eff = values["efficiency"]
            amps = station_amps["amps"]
            if "channel_ids" in eff:
                amps = amps[:, np.asarray(eff["channel_ids"], dtype=int)]
            amp_per_row = np.max(np.nan_to_num(amps), axis=-1)
            snr_of_gid = {}
            for g, a in zip(station_amps["gids"], amp_per_row):
                snr_of_gid[g] = max(snr_of_gid.get(g, 0.0), a)
            snr = np.array([snr_of_gid.get(g, 0.0) for g in gid])
            snr *= eff.get("scale", 1.0)
            e = eff["func"](snr / eff.get("Vrms", vrms))
            v, v_err, c, v_lo, v_hi = get_veff_output(
                volume, float(np.sum(w_all[mask] * e[mask])), n_events)
        veffs[name] = [v, v_err, c, v_lo, v_hi]

    # ---- OR-of-all-triggers summary (backward-compatible keys) -------------
    _, first = np.unique(gid, return_index=True)
    trig = triggered[first]
    w = weights[first]
    zen = zeniths[first]

    mask = trig & (w >= min_weight)
    if bounds_theta is not None:
        mask &= (zen >= bounds_theta[0]) & (zen <= bounds_theta[1])

    weight_sum = float(np.sum(w[mask]))
    counts = int(np.sum(mask))
    veff = volume * weight_sum / n_events
    solid_angle = 2 * np.pi * (np.cos(thetamin) - np.cos(thetamax))
    v, v_err, c, v_lo, v_hi = get_veff_output(volume, counts, n_events)
    return {
        "energy": float(np.mean(energies)),
        "energy_min": float(np.min(energies)),
        "energy_max": float(np.max(energies)),
        "thetamin": thetamin,
        "thetamax": thetamax,
        "veff": veff,
        "veff_error": veff / np.sqrt(counts) if counts else 0.0,
        "veff_low": v_lo * (weight_sum / counts if counts else 1.0),
        "veff_high": v_hi * (weight_sum / counts if counts else 1.0),
        "n_triggered": counts,
        "weight_sum": weight_sum,
        "solid_angle": abs(solid_angle),
        "n_events": n_events,
        "volume": volume,
        "trigger_names": trigger_names,
        "SNR": snr_out,
        ("veffs" if veff_aeff == "veff" else "aeff_surface_muons"): veffs,
    }


def get_Veff_Aeff(folder_or_files, **kwargs):
    """Aggregate over a folder / glob / list of output files (Veff.py:484-620)."""
    if isinstance(folder_or_files, str):
        if os.path.isdir(folder_or_files):
            files = sorted(glob.glob(os.path.join(folder_or_files, "*.hdf5")))
        else:
            files = sorted(glob.glob(folder_or_files))
    else:
        files = list(folder_or_files)
    return [get_Veff_Aeff_single(f, **kwargs) for f in files]


def get_Veff_Aeff_array(data):
    """Pack `get_Veff_Aeff` results into a dense array for fast slicing
    (Veff.py:622-711): shape (n_energies, n_zenith_bins, n_triggers, 5) with
    the last axis = [veff, error, weighted_count, fc_low, fc_high].

    Returns (output, unique_energies, unique_energies_min,
    unique_energies_max, unique_zenith_bins, unique_trigger_names).
    """
    key = "veffs" if "veffs" in data[0] else "aeff_surface_muons"
    energies = np.array([d["energy"] for d in data])
    emins = np.array([d.get("energy_min", d["energy"]) for d in data])
    emaxs = np.array([d.get("energy_max", d["energy"]) for d in data])
    zbins = np.array([[d.get("thetamin", 0.0), d.get("thetamax", np.pi)]
                      for d in data])
    names = sorted({n for d in data for n in d[key]})
    ue = np.unique(energies)
    uz = np.unique(zbins, axis=0)
    out = np.zeros((len(ue), len(uz), len(names), 5))
    for d, e, zb in zip(data, energies, zbins):
        iE = int(np.argwhere(ue == e)[0][0])
        iZ = int(np.argwhere(np.all(uz == zb, axis=1))[0][0])
        for n, v in d[key].items():
            out[iE, iZ, names.index(n)] = np.asarray(v, dtype=float)
    return (out, ue, np.unique(emins), np.unique(emaxs), uz,
            np.array(names))


def export(filename, data, trigger_names=None, export_format="yaml"):
    """Human-readable yaml/json export of `get_Veff_Aeff` results
    (Veff.py:757-800)."""
    output = []
    for d in data:
        row = {}
        for k, v in d.items():
            if k in ("veffs", "aeff_surface_muons"):
                row[k] = {n: [float(x) for x in vals]
                          for n, vals in v.items()
                          if trigger_names is None or n in trigger_names}
            elif isinstance(v, (np.generic,)):
                row[k] = v.item()
            elif isinstance(v, (int, float, str, list)):
                row[k] = v
        output.append(row)
    with open(filename, "w") as fout:
        if export_format == "yaml":
            import yaml
            yaml.safe_dump(output, fout)
        elif export_format == "json":
            import json
            json.dump(output, fout, sort_keys=True, indent=4)
        else:
            raise ValueError(export_format)
    return filename


def merge_output_hdf5(filenames, outname):
    """Merge per-batch output files (utilities/merge_hdf5.py:16 semantics):
    concatenate per-shower arrays, sum n_events, keep common attrs."""
    import h5py

    datas = {}
    attrs = None
    n_events = 0
    for fn in filenames:
        with h5py.File(fn, "r") as f:
            n_events += int(f.attrs["n_events"])
            if attrs is None:
                attrs = dict(f.attrs)
            for k in f.keys():
                if isinstance(f[k], h5py.Dataset):
                    datas.setdefault(k, []).append(np.asarray(f[k]))
    with h5py.File(outname, "w") as f:
        for k, parts in datas.items():
            f[k] = np.concatenate(parts)
        for k, v in attrs.items():
            f.attrs[k] = v
        f.attrs["n_events"] = n_events
    return outname


def split_input_hdf5(filename, out_prefix, n_events_per_file):
    """Split an input event list into batches (utilities/split_hdf5.py:11)."""
    import h5py

    from nuradiomc_tpu_torch.sim import io_hdf5

    inp = io_hdf5.read_input_hdf5(filename)
    gids = np.unique(inp.event_group_ids)
    outputs = []
    for i0 in range(0, len(gids), n_events_per_file):
        sel_g = set(gids[i0:i0 + n_events_per_file].tolist())
        rows = np.array([g in sel_g for g in inp.event_group_ids])
        out = f"{out_prefix}.part{i0 // n_events_per_file:04d}.hdf5"
        with h5py.File(out, "w") as f:
            for key in ("event_group_ids", "shower_ids", "xx", "yy", "zz",
                        "zeniths", "azimuths", "energies", "shower_energies",
                        "flavors", "inelasticity", "vertex_times"):
                f[key] = getattr(inp, key)[rows]
            f["shower_type"] = np.array(inp.shower_type[rows], dtype="S")
            f["interaction_type"] = np.array(inp.interaction_type[rows], dtype="S")
            for k, v in inp.attrs.items():
                f.attrs[k] = v
            f.attrs["n_events"] = len(sel_g)
        outputs.append(out)
    return outputs
