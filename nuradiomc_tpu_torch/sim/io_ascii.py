# copied from nuradiomc_tpu/sim/io_ascii.py:1-183 (the port keeps its own copy; it imports
# nothing of the JAX package); h5py is imported inside the HDF5 functions, as the
# card's machine has none
"""ASCII event-list I/O (EvtGen/generator_ASCII.py:1-83, hdf5_to_ASCII.py,
readEventList_ASCII.py): the ARASim-adapted columnar neutrino list format."""

from __future__ import annotations

import numpy as np

ASCII_HEADER = """VERSION=0.2
# standard event list format of NuRadioMC (adapted from ARASim)
# columns: event id, flavor (PDG), energy [eV], cc/nc, x, y, z [m],
#          zenith, azimuth [rad], inelasticity
"""

_FMT = ("{:08d} {:>+5d}  {:.5e}  {:s}  {:>10.3f}  {:>10.3f}  {:>10.3f}"
        "  {:>10.3f}  {:>10.3f}  {:>10.3f}\n")


def write_ascii_eventlist(filename, events):
    """events: dict with event_ids/flavors/energies/interaction_type/xx/yy/
    zz/zeniths/azimuths/inelasticity arrays (hdf5_to_ASCII.py:16-34)."""
    n = len(events["event_ids"])
    with open(filename, "w") as f:
        f.write(ASCII_HEADER)
        for i in range(n):
            ct = events["interaction_type"][i]
            if isinstance(ct, bytes):
                ct = ct.decode()
            f.write(_FMT.format(
                int(events["event_ids"][i]), int(events["flavors"][i]),
                float(events["energies"][i]), ct,
                float(events["xx"][i]), float(events["yy"][i]),
                float(events["zz"][i]), float(events["zeniths"][i]),
                float(events["azimuths"][i]),
                float(events["inelasticity"][i])))


def hdf5_to_ascii(hdf5_in, ascii_out):
    import h5py

    with h5py.File(hdf5_in, "r") as fin:
        events = {k: np.asarray(fin[k]) for k in
                  ("flavors", "energies", "interaction_type",
                   "xx", "yy", "zz", "zeniths", "azimuths", "inelasticity")}
        key = "event_ids" if "event_ids" in fin else "event_group_ids"
        events["event_ids"] = np.asarray(fin[key])
    write_ascii_eventlist(ascii_out, events)


def read_ascii_eventlist(filename):
    """Parse the columnar list back into arrays (readEventList_ASCII.py)."""
    rows = []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("VERSION"):
                continue
            rows.append(line.split())
    rows = list(zip(*rows))
    return {
        "event_ids": np.array(rows[0], dtype=int),
        "flavors": np.array(rows[1], dtype=int),
        "energies": np.array(rows[2], dtype=float),
        "interaction_type": np.array(rows[3], dtype="S2"),
        "xx": np.array(rows[4], dtype=float),
        "yy": np.array(rows[5], dtype=float),
        "zz": np.array(rows[6], dtype=float),
        "zeniths": np.array(rows[7], dtype=float),
        "azimuths": np.array(rows[8], dtype=float),
        "inelasticity": np.array(rows[9], dtype=float),
    }


def ascii_to_hdf5(ascii_in, hdf5_out, volume_attrs=None):
    """Convert an ASCII list to the standard hdf5 input layout so it can be
    fed to Simulation (the reference's readEventList path)."""
    import h5py

    ev = read_ascii_eventlist(ascii_in)
    n = len(ev["event_ids"])
    with h5py.File(hdf5_out, "w") as f:
        f["event_group_ids"] = ev["event_ids"].astype(int)
        f["shower_ids"] = np.arange(n)
        f["vertex_times"] = np.zeros(n)
        f["shower_type"] = np.array(
            [b"em" if (abs(fl) == 12 and ct == b"cc") else b"had"
             for fl, ct in zip(ev["flavors"], ev["interaction_type"])])
        f["shower_energies"] = np.where(
            f["shower_type"][()] == b"had",
            ev["inelasticity"] * ev["energies"],
            (1 - ev["inelasticity"]) * ev["energies"])
        for k, v in ev.items():
            if k == "event_ids":
                continue
            f[k] = v
        f["event_ids"] = ev["event_ids"]
        f.attrs["n_events"] = n
        f.attrs["start_event_id"] = int(ev["event_ids"][0]) if n else 0
        for k, v in (volume_attrs or {}).items():
            f.attrs[k] = v


# -- ARA / AraSim interop (EvtGen/readARAEventList.py, NuRadioMCtoAraSim.py) --

ARA_VERSION = 0.1


def read_ARA_eventlist(filename):
    """Parse an AraSim event list into a structured array with energies in eV
    and theta angles converted to the NuRadioMC convention
    (readARAEventList.read_ARA_eventlist:13-44)."""
    from io import BytesIO

    ara_version = 0
    with open(filename) as fin:
        data = ""
        for line in fin:
            key = line.lstrip("/")  # headers appear both bare and //-prefixed
            if key.startswith("VERSION"):
                ara_version = float(key.split("=")[1])
            elif key.startswith("EVENT_NUM"):
                int(key.split("=")[1])
            else:
                data += line
    if ara_version != 0.1:
        raise ValueError(f"ARA event list version {ara_version} != 0.1 not supported")

    arr = np.genfromtxt(BytesIO(data.encode()), comments="//",
                        dtype=[("eventId", int), ("nuflavorint", int),
                               ("nu_nubar", int), ("pnu", float),
                               ("currentint", float), ("posnu_r", float),
                               ("posnu_theta", float), ("posnu_phi", float),
                               ("nnu_theta", float), ("nnu_phi", float),
                               ("elast_y", float)])
    arr = np.atleast_1d(arr)
    arr["pnu"] = 10 ** (arr["pnu"] + 18.0)           # log10(E/EeV) -> eV
    arr["posnu_theta"] = np.mod(0.5 * np.pi - arr["posnu_theta"], 2 * np.pi)
    arr["nnu_theta"] = np.mod(0.5 * np.pi - arr["nnu_theta"], 2 * np.pi)
    return arr


def ara_eventlist_to_hdf5(araeventlist_filename, hdf5_filename):
    """AraSim event list -> HDF5 'eventlist' dataset
    (readARAEventList.convert_to_hdf5:47-55)."""
    import h5py

    data = read_ARA_eventlist(araeventlist_filename)
    with h5py.File(hdf5_filename, "w") as fout:
        fout["eventlist"] = data
        fout.attrs["VERSION"] = ARA_VERSION


def hdf5_to_arasim(hdf5_input, arasim_output, avg_depth):
    """NuRadioMC HDF5 input event list -> AraSim text input, with vertex
    positions re-expressed in spherical coordinates around a station at
    avg_depth below the surface (EvtGen/NuRadioMCtoAraSim.py:17-62)."""
    import h5py

    with h5py.File(hdf5_input, "r") as fin:
        event_ids = np.asarray(fin["event_ids"])
        flavors = np.asarray(fin["flavors"])
        energies = np.asarray(fin["energies"])
        ccncs = np.asarray(fin["interaction_type"])
        xx, yy, zz = (np.asarray(fin[k]) for k in ("xx", "yy", "zz"))
        zeniths = np.asarray(fin["zeniths"])
        azimuths = np.asarray(fin["azimuths"])
        inelasticity = np.asarray(fin["inelasticity"])

    nuflavorint = (np.abs(flavors) - 10) // 2
    nu_nubar = (-np.sign(flavors) + 1) // 2
    pnu = np.log10(energies)
    currentint = np.array([1 if (c == b"cc" or c == "cc") else 0 for c in ccncs])
    rho = np.hypot(xx, yy)
    posnu_r = np.sqrt(rho ** 2 + (-zz - avg_depth) ** 2)
    posnu_phi = np.mod(np.arctan2(yy, xx), 2 * np.pi)
    # AraSim theta: measured from the station horizontal, negative below
    posnu_theta = np.where(-zz >= avg_depth, -1.0, 1.0) * np.arccos(
        np.clip(rho / posnu_r, -1.0, 1.0))

    with open(arasim_output, "w") as fout:
        fout.write(f"//VERSION=0.1\n//EVENT_NUM={len(event_ids)}\n"
                   "//evid nuflavorint nu_nubar pnu currentint posnu_r "
                   "posnu_theta posnu_phi nnu_theta nnu_phi elast_y\n")
        for i in range(len(event_ids)):
            fout.write("{:08d} {:01d} {:01d} {:.3f} {:01d} {:.4f} {:.4f} "
                       "{:.4f} {:.4f} {:.4f} {:.4f}\n".format(
                           int(event_ids[i]), int(nuflavorint[i]),
                           int(nu_nubar[i]), pnu[i], int(currentint[i]),
                           posnu_r[i], posnu_theta[i], posnu_phi[i],
                           np.pi - zeniths[i], np.pi + azimuths[i],
                           inelasticity[i]))
