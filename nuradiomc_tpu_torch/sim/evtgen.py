# copied from nuradiomc_tpu/sim/evtgen.py:1-703 (generate_surface_muons from
# :368-508, BGR18 inelasticities from :76-90); the port keeps its own copy and
# imports nothing of the JAX package
"""Neutrino event-list generation (host-side numpy, fully vectorized).

Re-implementation of the reference generator
(NuRadioMC/EvtGen/generator.py:1023-1414 generate_eventlist_cylinder):
vertices uniform in a cylinder/cube volume, isotropic directions, energies
from configurable spectra (get_energies:308-390), flavor sampling, CC/NC
sampling and inelasticities with the CTW model (utilities/inelasticities.py),
and the second EM shower insertion for nu_e-CC events (generator.py:1258-1275).
Output HDF5 matches the reference per-shower table format
(write_events_to_hdf5, generator.py:88-199) so event lists are exchangeable
between the two frameworks. Secondary-interaction generation via PROPOSAL is
out of scope (requires the external lepton propagator).

The generators return ``(data, attributes)`` and write a file only when
``filename`` is not None, so a campaign can generate its list in memory
(``io_input.from_generated``) where h5py is missing.
"""

from __future__ import annotations

import numpy as np

from nuradiomc_tpu_torch.sim import cross_sections
from nuradiomc_tpu_torch.utils import units

VERSION_MAJOR = 3
VERSION_MINOR = 0


def get_energies(n_events, Emin, Emax, spectrum_type="log_uniform", rnd=None):
    """Sample neutrino energies (generator.get_energies:308-390)."""
    rnd = rnd or np.random.default_rng()
    if spectrum_type == "log_uniform":
        return 10 ** rnd.uniform(np.log10(Emin), np.log10(Emax), n_events)
    if spectrum_type.startswith("E-"):
        gamma = float(spectrum_type[1:]) + 1
        Nmin = Emin ** gamma
        Nmax = Emax ** gamma
        return np.exp(np.log(rnd.uniform(Nmax, Nmin, size=n_events)) / gamma)
    flux = _spectrum_flux(spectrum_type)
    if flux is not None:
        # inverse-CDF sampling on a fine log grid (get_energy_from_flux:242-273)
        E_grid = np.logspace(np.log10(Emin), np.log10(Emax), 100000)
        cdf = np.concatenate([[0.0], np.cumsum(flux(E_grid[:-1]) * np.diff(E_grid))])
        cdf /= cdf[-1]
        return np.interp(rnd.uniform(0, 1, n_events), cdf, E_grid)
    raise NotImplementedError(f"spectrum {spectrum_type} not implemented")


def _spectrum_flux(spectrum_type):
    """Flux function for a named spectrum (generator.get_energies:352-389),
    or None if the spectrum is not flux-based."""
    from nuradiomc_tpu_torch.sim import fluxes

    table = {
        "IceCube-nu-2017": fluxes.ice_cube_nu_fit,
        "IceCube-nu-2022": fluxes.ice_cube_nu_fit_2022,
        "GZK-1": fluxes.get_proton_10,
        "GZK-2": fluxes.get_TAGZK_flux_ICRC2021,
    }
    if spectrum_type in table:
        return table[spectrum_type]
    if "+" in spectrum_type:
        parts = [_spectrum_flux(p) for p in spectrum_type.split("+")]
        if all(p is not None for p in parts):
            return lambda E: sum(p(E) for p in parts)
    return None


def get_ccnc(n_events, energy, flavors, rnd=None, model="ctw"):
    """'cc'/'nc' sampling from the cross-section ratio (inelasticities.get_ccnc:108-160)."""
    rnd = rnd or np.random.default_rng()
    cc = cross_sections.get_nu_cross_section(energy, flavors, "cc", model)
    nc = cross_sections.get_nu_cross_section(energy, flavors, "nc", model)
    cc_fraction = cc / (cc + nc)
    return np.where(rnd.uniform(0, 1, n_events) <= cc_fraction, "cc", "nc")


def get_neutrino_inelasticity(n_events, rnd=None, model="ctw",
                              nu_energies=1e18, flavors=12, ncccs="cc"):
    """Inelasticity sampling (inelasticities.get_neutrino_inelasticity:16-95):
    CTW ShelfMC-style by default; 'hedis_bgr18'/'bgr18' draws from the BGR18
    differential tables' inverse CDF (per energy bin, flavor, cc/nc)."""
    rnd = rnd or np.random.default_rng()
    if model.lower() in ("bgr18", "hedis_bgr18", "hedis"):
        return cross_sections.get_neutrino_inelasticity_bgr18(
            n_events, rnd, nu_energies=nu_energies, flavors=flavors,
            ncccs=ncccs)
    r1 = 0.36787944
    r2 = 0.63212056
    return (-np.log(r1 + rnd.uniform(0.0, 1.0, n_events) * r2)) ** 2.5


def set_volume_attributes(volume: dict, attributes: dict):
    """Interpret the volume dict (set_volume_attributes:392-597, no-proposal path)."""
    attributes["x0"] = volume.get("x0", 0.0)
    attributes["y0"] = volume.get("y0", 0.0)
    if "fiducial_rmax" in volume:
        attributes["fiducial_rmin"] = volume.get("fiducial_rmin", 0.0)
        for key in ("fiducial_rmax", "fiducial_zmin", "fiducial_zmax"):
            attributes[key] = volume[key]
        rmin = attributes["fiducial_rmin"]
        rmax = attributes["fiducial_rmax"]
        zmin = attributes["fiducial_zmin"]
        zmax = attributes["fiducial_zmax"]
        attributes["rmin"] = rmin
        attributes["rmax"] = rmax
        attributes["zmin"] = zmin
        attributes["zmax"] = zmax
        attributes["volume"] = np.pi * (rmax ** 2 - rmin ** 2) * (zmax - zmin)
        attributes["area"] = np.pi * (rmax ** 2 - rmin ** 2)
    elif "fiducial_xmax" in volume:
        for key in ("fiducial_xmin", "fiducial_xmax", "fiducial_ymin",
                    "fiducial_ymax", "fiducial_zmin", "fiducial_zmax"):
            attributes[key] = volume[key]
        for short, fid in (("xmin", "fiducial_xmin"), ("xmax", "fiducial_xmax"),
                           ("ymin", "fiducial_ymin"), ("ymax", "fiducial_ymax"),
                           ("zmin", "fiducial_zmin"), ("zmax", "fiducial_zmax")):
            attributes[short] = volume[fid]
        dx = attributes["xmax"] - attributes["xmin"]
        dy = attributes["ymax"] - attributes["ymin"]
        dz = attributes["zmax"] - attributes["zmin"]
        attributes["volume"] = dx * dy * dz
        attributes["area"] = dx * dy
    else:
        raise AttributeError("volume must specify fiducial_rmax or fiducial_xmax")


def generate_vertex_positions(attributes, n_events, rnd=None):
    """Uniform vertices in the volume (generate_vertex_positions:598-628)."""
    rnd = rnd or np.random.default_rng()
    if "fiducial_rmax" in attributes:
        rr = rnd.uniform(attributes["rmin"] ** 2, attributes["rmax"] ** 2, n_events) ** 0.5
        phi = rnd.uniform(0, 2 * np.pi, n_events)
        xx = rr * np.cos(phi)
        yy = rr * np.sin(phi)
        zz = rnd.uniform(attributes["zmin"], attributes["zmax"], n_events)
    else:
        xx = rnd.uniform(attributes["xmin"], attributes["xmax"], n_events)
        yy = rnd.uniform(attributes["ymin"], attributes["ymax"], n_events)
        zz = rnd.uniform(attributes["zmin"], attributes["zmax"], n_events)
    return xx + attributes["x0"], yy + attributes["y0"], zz


def write_events_to_hdf5(filename, data_sets: dict, attributes: dict):
    """Write the reference per-shower table format (generator.py:88-199);
    needs h5py, which only this function imports."""
    import h5py

    with h5py.File(filename, "w") as f:
        for key, value in data_sets.items():
            value = np.asarray(value)
            if value.dtype.kind == "U":
                value = value.astype("S")
            f[key] = value
        for key, value in attributes.items():
            f.attrs[key] = value


def list_digest(data_sets: dict) -> str:
    """SHA-1 of a generated list's columns as :func:`write_events_to_hdf5`
    stores them: keys sorted, unicode columns as fixed-width bytes, each
    array's contiguous bytes after its key. It equals the digest that
    ``tests/golden/generate_veff_fullscale_golden.py`` ``input_sha1``
    reads back from the written file, without writing one."""
    import hashlib

    h = hashlib.sha1()
    for key in sorted(data_sets):
        arr = np.asarray(data_sets[key])
        if arr.dtype.kind in "OU":
            arr = arr.astype("S")
        h.update(key.encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def generate_eventlist_cylinder(
        filename, n_events, Emin, Emax, volume,
        thetamin=0.0, thetamax=np.pi,
        phimin=0.0, phimax=2 * np.pi,
        start_event_id=1,
        flavor=(12, -12, 14, -14, 16, -16),
        spectrum="log_uniform",
        start_shower_id=0,
        interaction_type="ccnc",
        cross_sections_model="ctw",
        seed=None,
        secondaries=None):
    """Generate a forced-interaction neutrino event list
    (generate_eventlist_cylinder, generator.py:1023-1414).

    ``secondaries='stochastic'`` inserts secondary showers along the outgoing
    charged lepton for nu_mu/nu_tau CC events — the reference's
    ``proposal=True`` path (generator.py:1282-1380) — using the in-repo
    stochastic propagator (sim/muon_propagation.py): muon/tau catastrophic
    losses from the 1/v spectrum, in-flight tau decay with the reference's
    decay kinematics (inelasticities.py:160-271), and daughter-muon follow-up.

    Returns the data_sets dict; writes ``filename`` if it is not None.
    """
    rnd = np.random.default_rng(np.random.Philox(seed))
    n_events = int(n_events)

    attributes = {
        "n_events": n_events,
        "start_event_id": start_event_id,
        "simulation_mode": "neutrino",
        "thetamin": thetamin, "thetamax": thetamax,
        "phimin": phimin, "phimax": phimax,
        "Emin": Emin, "Emax": Emax,
        "flavors": np.asarray(flavor),
        "deposited": False,
    }
    set_volume_attributes(volume, attributes)

    data = {}
    data["event_group_ids"] = np.arange(n_events) + start_event_id
    xx, yy, zz = generate_vertex_positions(attributes, n_events, rnd)
    data["xx"], data["yy"], data["zz"] = xx, yy, zz
    data["vertex_times"] = np.zeros(n_events)
    data["azimuths"] = rnd.uniform(phimin, phimax, n_events)
    data["zeniths"] = np.arccos(rnd.uniform(np.cos(thetamax), np.cos(thetamin), n_events))
    # flavor draw comes BEFORE the energy draw in the reference RNG stream
    # (generator.py:1226-1229) — order matters for seed-exact input replay
    data["flavors"] = np.asarray(flavor)[rnd.integers(0, len(flavor), n_events)]
    data["energies"] = get_energies(n_events, Emin, Emax, spectrum, rnd)
    data["n_interaction"] = np.ones(n_events, dtype=int)

    if interaction_type == "ccnc":
        data["interaction_type"] = get_ccnc(n_events, data["energies"],
                                            data["flavors"], rnd, cross_sections_model)
    elif interaction_type in ("cc", "nc"):
        data["interaction_type"] = np.full(n_events, interaction_type, dtype="U2")
    else:
        raise ValueError(f"illegal interaction type {interaction_type}")

    data["inelasticity"] = get_neutrino_inelasticity(
        n_events, rnd, cross_sections_model,
        nu_energies=data["energies"], flavors=data["flavors"],
        ncccs=data["interaction_type"])

    # first (hadronic) shower: E_nu * y  (generator.py:1255-1256)
    data["shower_energies"] = data["energies"] * data["inelasticity"]
    data["shower_type"] = np.full(n_events, "had", dtype="U3")

    # nu_e CC: insert a second (EM) shower with E (1 - y) at the same vertex
    # (generator.py:1258-1275)
    em_mask = (data["interaction_type"] == "cc") & (np.abs(data["flavors"]) == 12)
    idx_em = np.where(em_mask)[0]
    if len(idx_em):
        insert_rows = {}
        for key in list(data.keys()):
            arr = data[key]
            extra = arr[idx_em].copy()
            if key == "shower_energies":
                extra = (1 - data["inelasticity"][idx_em]) * data["energies"][idx_em]
            elif key == "shower_type":
                extra = np.full(len(idx_em), "em", dtype="U3")
            # n_interaction stays 1 on the inserted EM row: the reference
            # copies the hadronic row verbatim (generator.py:1268-1276) —
            # both showers belong to the SAME (first) interaction
            insert_rows[key] = extra
        # interleave so rows stay sorted by event_group_id
        order = np.argsort(np.concatenate(
            [data["event_group_ids"], insert_rows["event_group_ids"]]), kind="stable")
        for key in list(data.keys()):
            data[key] = np.concatenate([data[key], insert_rows[key]])[order]

    if secondaries == "stochastic":
        _insert_lepton_secondaries(data, attributes, rnd)

    data["shower_ids"] = np.arange(len(data["shower_energies"]), dtype=int) + start_shower_id

    attributes["total_number_of_events"] = n_events
    if filename is not None:
        write_events_to_hdf5(filename, data, attributes)
    return data, attributes


def _insert_lepton_secondaries(data, attributes, rnd):
    """Insert secondary showers from outgoing mu/tau of CC interactions.

    TPU-native equivalent of the reference's PROPOSAL branch
    (generator.py:1282-1380 + EvtGen/NuRadioProposal.py): the charged lepton
    of a nu_mu/nu_tau CC event carries E_nu(1-y) from the vertex along the
    neutrino direction; its catastrophic losses (and the tau decay products,
    including daughter muons) become additional showers of the same event
    group, time-offset by flight time. Mutates ``data`` in place.
    """
    from nuradiomc_tpu_torch.sim import muon_propagation
    from nuradiomc_tpu_torch.utils.constants import speed_of_light

    primary = data["n_interaction"] == 1
    lep_mask = primary & (data["interaction_type"] == "cc") & \
        np.isin(np.abs(data["flavors"]), (14, 16))
    idx = np.where(lep_mask)[0]
    if not len(idx):
        return

    e_lep = data["energies"][idx] * (1 - data["inelasticity"][idx])
    zen, azi = data["zeniths"][idx], data["azimuths"][idx]
    prop_dir = -np.stack([np.sin(zen) * np.cos(azi),
                          np.sin(zen) * np.sin(azi),
                          np.cos(zen)], axis=-1)
    vertex = np.stack([data["xx"][idx], data["yy"][idx], data["zz"][idx]], axis=-1)

    # generous track cap: volume diagonal (losses outside are filtered below)
    if "rmax" in attributes:
        diag = np.hypot(2 * attributes["rmax"],
                        attributes["zmax"] - attributes["zmin"])
    else:
        diag = np.sqrt((attributes["xmax"] - attributes["xmin"]) ** 2
                       + (attributes["ymax"] - attributes["ymin"]) ** 2
                       + (attributes["zmax"] - attributes["zmin"]) ** 2)

    rows = {k: [] for k in data.keys()}

    def _inside(pos):
        if "rmax" in attributes:
            r_h = np.hypot(pos[0] - attributes["x0"], pos[1] - attributes["y0"])
            if r_h > attributes["rmax"]:
                return False
        else:
            if not (attributes["xmin"] <= pos[0] <= attributes["xmax"]
                    and attributes["ymin"] <= pos[1] <= attributes["ymax"]):
                return False
        return attributes["zmin"] <= pos[2] <= attributes["zmax"]

    for j, i in enumerate(idx):
        is_tau = abs(data["flavors"][i]) == 16
        if is_tau:
            loss_lists, decay_info = muon_propagation.propagate_taus(
                [e_lep[j]], diag, rng=rnd)
            track_losses = list(loss_lists[0])
        else:
            loss_lists, _ = muon_propagation.propagate_muons(
                [e_lep[j]], diag, rng=rnd)
            track_losses = list(loss_lists[0])

        # expand tau daughter muons into their own loss chains
        expanded = []
        for dist, e_sh, kind in track_losses:
            if kind == "mu":
                mu_losses, _ = muon_propagation.propagate_muons(
                    [e_sh], diag - dist, rng=rnd)
                expanded.extend((dist + d2, e2, k2) for d2, e2, k2 in mu_losses[0])
            else:
                expanded.append((dist, e_sh, kind))

        n_int = 2
        for dist, e_sh, kind in sorted(expanded):
            pos = vertex[j] + prop_dir[j] * dist
            if not _inside(pos):
                continue
            for key in data.keys():
                if key == "xx":
                    rows[key].append(pos[0])
                elif key == "yy":
                    rows[key].append(pos[1])
                elif key == "zz":
                    rows[key].append(pos[2])
                elif key == "vertex_times":
                    rows[key].append(data["vertex_times"][i] + dist / speed_of_light)
                elif key == "shower_energies":
                    rows[key].append(e_sh)
                elif key == "shower_type":
                    rows[key].append(kind)
                elif key == "interaction_type":
                    rows[key].append(kind)
                elif key == "inelasticity":
                    rows[key].append(e_sh / data["energies"][i])
                elif key == "n_interaction":
                    rows[key].append(n_int)
                else:
                    rows[key].append(data[key][i])
            n_int += 1

    if not len(rows["xx"]):
        return
    order = np.argsort(np.concatenate(
        [data["event_group_ids"], np.asarray(rows["event_group_ids"])]),
        kind="stable")
    for key in list(data.keys()):
        extra = np.asarray(rows[key], dtype=data[key].dtype if
                           data[key].dtype.kind != "U" else None)
        if data[key].dtype.kind == "U":
            extra = extra.astype(data[key].dtype)
        data[key] = np.concatenate([data[key], extra])[order]


def generate_surface_muons(filename, n_events, Emin, Emax, volume,
                           thetamin=0.0, thetamax=np.pi / 2,
                           phimin=0.0, phimax=2 * np.pi,
                           start_event_id=1, plus_minus="mix",
                           spectrum="log_uniform", seed=None,
                           secondaries="proposal",
                           loss_fraction_range=(0.01, 0.5)):
    """Atmospheric-muon event generator for effective-area studies
    (generator.generate_surface_muons:739-1020).

    Muons are generated on the upper surface of the fiducial volume with
    downward-going directions. Their in-ice energy losses (the radio-emitting
    showers) come from the PROPOSAL lepton propagator when the external
    ``proposal`` package is installed (the reference's approach,
    EvtGen/NuRadioProposal.py). When unavailable,
    ``secondaries='parametrized'`` places a single stochastic energy loss at
    an exponentially-sampled depth with a log-uniform loss fraction — a
    documented approximation for machinery tests, NOT a physics-accurate
    replacement for PROPOSAL.
    """
    rnd = np.random.default_rng(np.random.Philox(seed))
    n_events = int(n_events)

    attributes = {
        "n_events": n_events, "start_event_id": start_event_id,
        "simulation_mode": "atmospheric_muon",
        "thetamin": thetamin, "thetamax": thetamax,
        "phimin": phimin, "phimax": phimax,
        "Emin": Emin, "Emax": Emax,
        "flavors": np.array([13, -13]), "deposited": False,
    }
    set_volume_attributes(volume, attributes)

    # entry points uniform on the top surface
    rr = rnd.uniform(attributes["rmin"] ** 2, attributes["rmax"] ** 2, n_events) ** 0.5
    phi = rnd.uniform(0, 2 * np.pi, n_events)
    xx = rr * np.cos(phi) + attributes["x0"]
    yy = rr * np.sin(phi) + attributes["y0"]
    z_top = attributes["zmax"]

    zeniths = np.arccos(rnd.uniform(np.cos(thetamax), np.cos(thetamin), n_events))
    azimuths = rnd.uniform(phimin, phimax, n_events)
    energies = get_energies(n_events, Emin, Emax, spectrum, rnd)
    if plus_minus == "plus":
        flavors = np.full(n_events, -13)
    elif plus_minus == "minus":
        flavors = np.full(n_events, 13)
    else:
        flavors = np.where(rnd.random(n_events) < 0.5, 13, -13)

    if secondaries == "proposal":
        try:
            import proposal  # noqa: F401
        except ImportError as exc:
            raise ImportError(
                "PROPOSAL is not installed; pass secondaries='stochastic' for "
                "the in-repo propagator or 'parametrized' for a single loss") from exc
        raise NotImplementedError(
            "PROPOSAL-driven secondaries: hook NuRadioProposal-equivalent here")

    if secondaries == "stochastic":
        # in-repo stochastic propagator (sim/muon_propagation.py): full
        # multi-loss treatment with the standard a + bE parameterization
        from nuradiomc_tpu_torch.sim import muon_propagation
        from nuradiomc_tpu_torch.utils.constants import speed_of_light

        prop_dir = -np.stack([np.sin(zeniths) * np.cos(azimuths),
                              np.sin(zeniths) * np.sin(azimuths),
                              np.cos(zeniths)], axis=-1)
        depth_cap = (z_top - attributes["zmin"]) / np.maximum(
            np.cos(zeniths), 0.05)
        all_losses, _ = muon_propagation.propagate_muons(
            energies, depth_cap, rng=rnd)

        rows = {k: [] for k in
                ("event_group_ids", "xx", "yy", "zz", "vertex_times",
                 "azimuths", "zeniths", "energies", "flavors",
                 "n_interaction", "interaction_type", "inelasticity",
                 "shower_energies", "shower_type")}
        for i, loss_list in enumerate(all_losses):
            entry = np.array([xx[i], yy[i], z_top])
            for k, (dist, e_sh, kind) in enumerate(loss_list):
                pos = entry + prop_dir[i] * dist
                r_h = np.hypot(pos[0] - attributes["x0"],
                               pos[1] - attributes["y0"])
                if r_h > attributes["rmax"] or pos[2] < attributes["zmin"]:
                    continue
                rows["event_group_ids"].append(i + start_event_id)
                rows["xx"].append(pos[0])
                rows["yy"].append(pos[1])
                rows["zz"].append(pos[2])
                rows["vertex_times"].append(dist / speed_of_light)
                rows["azimuths"].append(azimuths[i])
                rows["zeniths"].append(zeniths[i])
                rows["energies"].append(energies[i])
                rows["flavors"].append(flavors[i])
                rows["n_interaction"].append(k + 1)
                rows["interaction_type"].append(kind)
                rows["inelasticity"].append(e_sh / energies[i])
                rows["shower_energies"].append(e_sh)
                rows["shower_type"].append(kind)
        data = {k: np.asarray(v) for k, v in rows.items()}
        data["shower_type"] = data["shower_type"].astype("U3")
        data["interaction_type"] = data["interaction_type"].astype("U3")
        data["shower_ids"] = np.arange(len(data["xx"]), dtype=int)
        if filename is not None:
            write_events_to_hdf5(filename, data, attributes)
        return data, attributes

    # parametrized single stochastic loss along the track
    prop_dir = -np.stack([np.sin(zeniths) * np.cos(azimuths),
                          np.sin(zeniths) * np.sin(azimuths),
                          np.cos(zeniths)], axis=-1)
    # exponential path length with ~1 km scale, capped at the volume depth
    track = rnd.exponential(1000.0, n_events)
    depth_cap = (z_top - attributes["zmin"]) / np.maximum(np.cos(zeniths), 0.05)
    track = np.minimum(track, depth_cap * rnd.random(n_events))
    vert = np.stack([xx, yy, np.full(n_events, z_top)], axis=-1) +         prop_dir * track[:, None]
    loss = 10 ** rnd.uniform(np.log10(loss_fraction_range[0]),
                             np.log10(loss_fraction_range[1]), n_events)

    from nuradiomc_tpu_torch.utils.constants import speed_of_light
    data = {
        "event_group_ids": np.arange(n_events) + start_event_id,
        "xx": vert[:, 0], "yy": vert[:, 1], "zz": vert[:, 2],
        "vertex_times": track / speed_of_light,
        "azimuths": azimuths, "zeniths": zeniths,
        "energies": energies,
        "flavors": flavors,
        "n_interaction": np.ones(n_events, dtype=int),
        "interaction_type": np.full(n_events, "had", dtype="U3"),
        "inelasticity": loss,
        "shower_energies": energies * loss,
        "shower_type": np.full(n_events, "had", dtype="U3"),
        "shower_ids": np.arange(n_events, dtype=int),
    }
    if filename is not None:
        write_events_to_hdf5(filename, data, attributes)
    return data, attributes


def group_into_events(start_times, split_time_gap=1e6):
    """Split showers of one event group into separate events when their
    signal arrival times gap by more than ``split_time_gap``
    (simulation.group_into_events:906-1016).

    Returns an integer sub-event index per shower (sorted stably).
    """
    start_times = np.asarray(start_times)
    order = np.argsort(start_times, kind="stable")
    event_idx = np.zeros(len(start_times), dtype=int)
    current = 0
    for k in range(1, len(order)):
        if start_times[order[k]] - start_times[order[k - 1]] > split_time_gap:
            current += 1
        event_idx[order[k]] = current
    return event_idx


def generate_unforced(filename, n_events, Emin, Emax, volume,
                      thetamin=0.0, thetamax=np.pi,
                      phimin=0.0, phimax=2 * np.pi,
                      start_event_id=1,
                      flavor=(12, -12, 14, -14, 16, -16),
                      spectrum="log_uniform",
                      cross_sections_model="ctw",
                      seed=None, n_chord_samples=2048, chunk=4096):
    """Unforced event generation (EvtGen/generate_unforced.py:28-601).

    Instead of forcing every neutrino to interact inside the fiducial volume
    and carrying an Earth-absorption weight, neutrinos are thrown on planes
    transverse to their direction, their interaction grammage is drawn from
    an exponential with the energy-dependent interaction length, and the
    interaction point along the (PREM) Earth chord is computed; only events
    whose vertex lands in the cylinder are kept (with weight 1).

    The reference walks scipy.brentq/quad per event ("takes days"); here the
    chord grammage is one cumulative trapezoid per event, vectorized in
    chunks.

    Returns (data, attributes); writes ``filename`` if not None.
    """
    from nuradiomc_tpu_torch.sim import earth_attenuation

    rnd = np.random.default_rng(np.random.Philox(seed))
    n_events = int(n_events)
    earth = earth_attenuation.PREM
    R_e = earth.earth_radius

    attributes = {
        "n_events": n_events, "start_event_id": start_event_id,
        "simulation_mode": "neutrino",
        "thetamin": thetamin, "thetamax": thetamax,
        "phimin": phimin, "phimax": phimax,
        "Emin": Emin, "Emax": Emax,
        "flavors": np.asarray(flavor), "deposited": False,
        "unforced": True,
    }
    set_volume_attributes(volume, attributes)
    rmax, zmin = attributes["rmax"], attributes["zmin"]
    # transverse throwing plane must cover the cylinder from any direction
    d_plane = 2.0 * np.sqrt(rmax ** 2 + (0.5 * zmin) ** 2) * 1.05
    attributes["throwing_area"] = d_plane ** 2

    energies = get_energies(n_events, Emin, Emax, spectrum, rnd)
    flavors = np.asarray(flavor)[rnd.integers(0, len(flavor), n_events)]
    zeniths = np.arccos(rnd.uniform(np.cos(thetamax), np.cos(thetamin), n_events))
    azimuths = rnd.uniform(phimin, phimax, n_events)
    L_int = rnd.exponential(cross_sections.get_interaction_length(
        energies, density=1.0, flavor=flavors, inttype="total",
        cross_section_type=cross_sections_model))

    # propagation direction (zenith/azimuth point back to the source)
    v = -np.stack([np.sin(zeniths) * np.cos(azimuths),
                   np.sin(zeniths) * np.sin(azimuths),
                   np.cos(zeniths)], axis=-1)
    # transverse basis
    up = np.where(np.abs(v[:, 2:3]) < 0.9, [[0.0, 0.0, 1.0]], [[1.0, 0.0, 0.0]])
    e1 = np.cross(v, up)
    e1 /= np.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = np.cross(v, e1)
    ax = rnd.uniform(-0.5 * d_plane, 0.5 * d_plane, n_events)
    ay = rnd.uniform(-0.5 * d_plane, 0.5 * d_plane, n_events)
    center = np.array([attributes.get("x0", 0.0), attributes.get("y0", 0.0),
                       0.5 * zmin])
    P = center + ax[:, None] * e1 + ay[:, None] * e2   # surface coords

    keep = np.zeros(n_events, dtype=bool)
    vertices = np.zeros((n_events, 3))
    M_TO_CM = 100.0
    for i0 in range(0, n_events, chunk):
        sl = slice(i0, min(i0 + chunk, n_events))
        Pc = P[sl].copy()
        Pc[:, 2] += R_e                                # earth-centric
        vv = v[sl]
        # entry point: going backward along v until |Pc - t v| = R_e
        b = np.sum(Pc * vv, axis=-1)
        disc = b ** 2 - np.sum(Pc ** 2, axis=-1) + R_e ** 2
        ok = disc > 0
        t_back = b + np.sqrt(np.maximum(disc, 0.0))    # distance to entry
        t_fwd = -b + np.sqrt(np.maximum(disc, 0.0))    # distance to exit
        length = t_back + t_fwd
        ts = np.linspace(0.0, 1.0, n_chord_samples)[None, :] * length[:, None]
        entry = Pc - t_back[:, None] * vv
        pts = entry[:, None, :] + ts[..., None] * vv[:, None, :]
        rr = np.linalg.norm(pts, axis=-1)
        rho = earth.density(rr)
        X = np.concatenate([np.zeros((len(rho), 1)), np.cumsum(
            0.5 * (rho[:, 1:] + rho[:, :-1]) * np.diff(ts, axis=-1), axis=-1)],
            axis=-1) * M_TO_CM
        has_int = ok & (L_int[sl] < X[:, -1])
        # invert the cumulative grammage at the drawn interaction depth
        idx = np.clip(np.array([np.searchsorted(Xi, Li) for Xi, Li in
                                zip(X, L_int[sl])]), 1, n_chord_samples - 1)
        rows = np.arange(len(idx))
        X0, X1 = X[rows, idx - 1], X[rows, idx]
        frac = np.where(X1 > X0, (L_int[sl] - X0) / np.maximum(X1 - X0, 1e-30), 0.0)
        t_int = ts[rows, idx - 1] + frac * (ts[rows, idx] - ts[rows, idx - 1])
        vert = entry + t_int[:, None] * vv
        vert[:, 2] -= R_e                              # back to surface coords
        r_h = np.hypot(vert[:, 0] - center[0], vert[:, 1] - center[1])
        inside = (r_h <= rmax) & (vert[:, 2] >= zmin) & (vert[:, 2] <= attributes["zmax"])
        keep[sl] = has_int & inside
        vertices[sl] = vert

    sel = np.where(keep)[0]
    n_kept = len(sel)
    data = {
        "event_group_ids": np.arange(n_kept) + start_event_id,
        "xx": vertices[sel, 0], "yy": vertices[sel, 1], "zz": vertices[sel, 2],
        "vertex_times": np.zeros(n_kept),
        "azimuths": azimuths[sel], "zeniths": zeniths[sel],
        "energies": energies[sel], "flavors": flavors[sel],
        "n_interaction": np.ones(n_kept, dtype=int),
    }
    data["interaction_type"] = get_ccnc(n_kept, data["energies"],
                                        data["flavors"], rnd,
                                        cross_sections_model)
    data["inelasticity"] = get_neutrino_inelasticity(n_kept, rnd,
                                                     cross_sections_model)
    data["shower_energies"] = data["energies"] * data["inelasticity"]
    data["shower_type"] = np.full(n_kept, "had", dtype="U3")
    data["shower_ids"] = np.arange(n_kept, dtype=int)
    attributes["total_number_of_events"] = n_events
    attributes["n_events"] = n_events   # thrown, for rate normalization
    if filename is not None:
        write_events_to_hdf5(filename, data, attributes)
    return data, attributes


if __name__ == "__main__":
    # CLI mirroring the reference's EvtGen/generate_cylinder.py:8-94
    import argparse

    parser = argparse.ArgumentParser(
        description="Generate forced-interaction events in a cylinder volume")
    parser.add_argument("filename")
    parser.add_argument("n_events", type=int)
    parser.add_argument("Emin", type=float)
    parser.add_argument("Emax", type=float)
    parser.add_argument("fiducial_rmin", type=float)
    parser.add_argument("fiducial_rmax", type=float)
    parser.add_argument("fiducial_zmin", type=float)
    parser.add_argument("fiducial_zmax", type=float)
    parser.add_argument("--full_rmin", type=float, default=None)
    parser.add_argument("--full_rmax", type=float, default=None)
    parser.add_argument("--full_zmin", type=float, default=None)
    parser.add_argument("--full_zmax", type=float, default=None)
    parser.add_argument("--thetamin", type=float, default=0.0)
    parser.add_argument("--thetamax", type=float, default=np.pi)
    parser.add_argument("--phimin", type=float, default=0.0)
    parser.add_argument("--phimax", type=float, default=2 * np.pi)
    parser.add_argument("--start_event_id", type=int, default=1)
    parser.add_argument("--flavor", nargs="+", type=int,
                        default=[12, -12, 14, -14, 16, -16])
    parser.add_argument("--spectrum", type=str, default="log_uniform")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--secondaries", type=str, default=None,
                        help="'stochastic' inserts mu/tau secondary showers")
    args = parser.parse_args()

    volume = {"fiducial_rmin": args.fiducial_rmin,
              "fiducial_rmax": args.fiducial_rmax,
              "fiducial_zmin": args.fiducial_zmin,
              "fiducial_zmax": args.fiducial_zmax}
    for k in ("full_rmin", "full_rmax", "full_zmin", "full_zmax"):
        v = getattr(args, k)
        if v is not None:
            volume[k] = v

    generate_eventlist_cylinder(
        args.filename, args.n_events, args.Emin, args.Emax, volume,
        thetamin=args.thetamin, thetamax=args.thetamax,
        phimin=args.phimin, phimax=args.phimax,
        start_event_id=args.start_event_id, flavor=tuple(args.flavor),
        spectrum=args.spectrum, seed=args.seed, secondaries=args.secondaries)
