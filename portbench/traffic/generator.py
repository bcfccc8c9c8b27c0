# frozen copy of nuradiomc_tpu_torch/sim/evtgen.py:33-50 (get_energies, the
# log-uniform and power-law spectra), :73-94 (get_ccnc,
# get_neutrino_inelasticity, the CTW model), :97-145 (set_volume_attributes,
# generate_vertex_positions), :163-178 (list_digest) and :181-281
# (generate_eventlist_cylinder), commit 493e4d9; the lepton secondaries
# (evtgen.py:271-272, commit 9f76fe9) call the copy in secondaries.py.
"""The benchmark's one traffic generator: forced-interaction neutrino event
lists in a cylinder or box, as NuRadioMC's ``generate_eventlist_cylinder``
writes them, and the writer of the ``.npz`` lists that the port's
``Simulation`` reads. A traffic mix is a JSON file of this generator's
arguments beside this file (``<mix>.json``); ``"secondaries": "stochastic"``
among them adds the showers of the outgoing muon or tau
(``secondaries.py``)."""

from __future__ import annotations

import hashlib

import numpy as np

from portbench.reference import cross_sections, units
from portbench.traffic import secondaries as lepton_secondaries

# the columns of the port's event input (sim/io_hdf5.py EventInput)
LIST_COLUMNS = ("event_group_ids", "shower_ids", "xx", "yy", "zz", "zeniths", "azimuths",
                "energies", "shower_energies", "shower_type", "flavors",
                "interaction_type", "inelasticity", "vertex_times")


def get_energies(n_events, Emin, Emax, spectrum_type, rnd):
    if spectrum_type == "log_uniform":
        return 10 ** rnd.uniform(np.log10(Emin), np.log10(Emax), n_events)
    if spectrum_type.startswith("E-"):
        gamma = float(spectrum_type[1:]) + 1
        return np.exp(np.log(rnd.uniform(Emax ** gamma, Emin ** gamma, size=n_events)) / gamma)
    raise NotImplementedError(f"spectrum {spectrum_type} is not in the benchmark's generator")


def get_ccnc(n_events, energy, flavors, rnd, model="ctw"):
    cc = cross_sections.get_nu_cross_section(energy, flavors, "cc", model)
    nc = cross_sections.get_nu_cross_section(energy, flavors, "nc", model)
    return np.where(rnd.uniform(0, 1, n_events) <= cc / (cc + nc), "cc", "nc")


def get_neutrino_inelasticity(n_events, rnd):
    r1 = 0.36787944
    r2 = 0.63212056
    return (-np.log(r1 + rnd.uniform(0.0, 1.0, n_events) * r2)) ** 2.5


def set_volume_attributes(volume: dict, attributes: dict):
    attributes["x0"] = volume.get("x0", 0.0)
    attributes["y0"] = volume.get("y0", 0.0)
    if "fiducial_rmax" in volume:
        attributes["fiducial_rmin"] = volume.get("fiducial_rmin", 0.0)
        for key in ("fiducial_rmax", "fiducial_zmin", "fiducial_zmax"):
            attributes[key] = volume[key]
        rmin, rmax = attributes["fiducial_rmin"], attributes["fiducial_rmax"]
        zmin, zmax = attributes["fiducial_zmin"], attributes["fiducial_zmax"]
        attributes.update(rmin=rmin, rmax=rmax, zmin=zmin, zmax=zmax)
        attributes["volume"] = np.pi * (rmax ** 2 - rmin ** 2) * (zmax - zmin)
        attributes["area"] = np.pi * (rmax ** 2 - rmin ** 2)
    elif "fiducial_xmax" in volume:
        for key in ("fiducial_xmin", "fiducial_xmax", "fiducial_ymin",
                    "fiducial_ymax", "fiducial_zmin", "fiducial_zmax"):
            attributes[key] = volume[key]
        for short in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax"):
            attributes[short] = volume["fiducial_" + short]
        dx = attributes["xmax"] - attributes["xmin"]
        dy = attributes["ymax"] - attributes["ymin"]
        dz = attributes["zmax"] - attributes["zmin"]
        attributes["volume"] = dx * dy * dz
        attributes["area"] = dx * dy
    else:
        raise AttributeError("volume must specify fiducial_rmax or fiducial_xmax")


def generate_vertex_positions(attributes, n_events, rnd):
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


def list_digest(data_sets: dict) -> str:
    """SHA-1 of a list's columns: keys sorted, unicode as fixed-width bytes."""
    h = hashlib.sha1()
    for key in sorted(data_sets):
        arr = np.asarray(data_sets[key])
        if arr.dtype.kind in "OU":
            arr = arr.astype("S")
        h.update(key.encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def generate_eventlist_cylinder(n_events, Emin, Emax, volume,
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
    """``(data, attributes)`` of a forced-interaction list; energies in eV
    of the port's units (eV = 1), lengths in m. ``secondaries="stochastic"``
    inserts the charged lepton's showers of each nu_mu / nu_tau CC event."""
    if cross_sections_model != "ctw":
        raise NotImplementedError("the benchmark's generator draws CTW interactions")
    rnd = np.random.default_rng(np.random.Philox(seed))
    n_events = int(n_events)
    attributes = {
        "n_events": n_events, "start_event_id": start_event_id,
        "simulation_mode": "neutrino",
        "thetamin": thetamin, "thetamax": thetamax, "phimin": phimin, "phimax": phimax,
        "Emin": Emin, "Emax": Emax, "flavors": np.asarray(flavor), "deposited": False,
    }
    set_volume_attributes(volume, attributes)
    data = {}
    data["event_group_ids"] = np.arange(n_events) + start_event_id
    xx, yy, zz = generate_vertex_positions(attributes, n_events, rnd)
    data["xx"], data["yy"], data["zz"] = xx, yy, zz
    data["vertex_times"] = np.zeros(n_events)
    data["azimuths"] = rnd.uniform(phimin, phimax, n_events)
    data["zeniths"] = np.arccos(rnd.uniform(np.cos(thetamax), np.cos(thetamin), n_events))
    # the flavor draw comes before the energy draw (generator.py:1226-1229)
    data["flavors"] = np.asarray(flavor)[rnd.integers(0, len(flavor), n_events)]
    data["energies"] = get_energies(n_events, Emin, Emax, spectrum, rnd)
    data["n_interaction"] = np.ones(n_events, dtype=int)
    if interaction_type == "ccnc":
        data["interaction_type"] = get_ccnc(n_events, data["energies"], data["flavors"], rnd,
                                            cross_sections_model)
    elif interaction_type in ("cc", "nc"):
        data["interaction_type"] = np.full(n_events, interaction_type, dtype="U2")
    else:
        raise ValueError(f"illegal interaction type {interaction_type}")
    data["inelasticity"] = get_neutrino_inelasticity(n_events, rnd)
    data["shower_energies"] = data["energies"] * data["inelasticity"]
    data["shower_type"] = np.full(n_events, "had", dtype="U3")
    # nu_e CC: a second (EM) shower with E (1 - y) at the same vertex
    em_mask = (data["interaction_type"] == "cc") & (np.abs(data["flavors"]) == 12)
    idx_em = np.where(em_mask)[0]
    if len(idx_em):
        insert_rows = {}
        for key in list(data.keys()):
            extra = data[key][idx_em].copy()
            if key == "shower_energies":
                extra = (1 - data["inelasticity"][idx_em]) * data["energies"][idx_em]
            elif key == "shower_type":
                extra = np.full(len(idx_em), "em", dtype="U3")
            insert_rows[key] = extra
        order = np.argsort(np.concatenate(
            [data["event_group_ids"], insert_rows["event_group_ids"]]), kind="stable")
        for key in list(data.keys()):
            data[key] = np.concatenate([data[key], insert_rows[key]])[order]
    if secondaries == "stochastic":
        lepton_secondaries.insert_lepton_secondaries(data, attributes, rnd)
    elif secondaries is not None:
        raise ValueError(f"secondaries {secondaries!r} is not in the benchmark's generator")
    data["shower_ids"] = np.arange(len(data["shower_energies"]), dtype=int) + start_shower_id
    attributes["total_number_of_events"] = n_events
    return data, attributes


def job_seed(seed: int, job: int) -> int:
    """The generator's seed of list ``job`` of a run with ``--seed``: any
    whole number, as large as the run's seed, folded into 63 bits."""
    seq = np.random.SeedSequence([int(seed) % 2 ** 64, int(seed) // 2 ** 64, int(job)])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_list(mix: dict, seed: int, job: int) -> tuple:
    """``(data, attributes)`` of list ``job`` of a run: the mix's generator
    arguments, ``events_per_job`` events, seeded from ``(seed, job)``; a mix
    without ``secondaries`` draws no lepton secondaries."""
    args = mix["generator"]
    volume = {k: float(v) * units.m for k, v in args["volume_m"].items()}
    energy = float(args["energy_eV"]) * units.eV
    return generate_eventlist_cylinder(
        mix["events_per_job"], energy, energy, volume,
        flavor=tuple(args["flavors"]), interaction_type=args["interaction_type"],
        seed=job_seed(seed, job), secondaries=args.get("secondaries"))


def write_list(path, data: dict, attributes: dict) -> None:
    """The list as the ``.npz`` the port's ``Simulation`` reads: the input
    columns as ``col_<name>``, the attributes as ``attr_<name>``."""
    out = {f"col_{k}": np.asarray(data[k]) for k in LIST_COLUMNS}
    out.update({f"attr_{k}": np.asarray(v) for k, v in attributes.items()})
    np.savez(path, **out)
