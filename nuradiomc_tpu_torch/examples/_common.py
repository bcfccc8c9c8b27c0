"""What the example modules share: the device and dtype of a run, the
command line, and the event-list and output routes with and without h5py.

Where h5py imports, an example writes and reads HDF5 files as the JAX
example does. Where it does not (the card's machine), an event list is
written as the ``.npz`` export that ``sim/io_input.py`` reads, and an output
file as the ``.npz`` of the same top-level rows and attributes
(:func:`save_results`), whose Veff table ``sim.veff.veff_aeff_of_rows``
computes, as ``get_Veff_Aeff_single`` does from the output HDF5. Each
example prints the route it took.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np

from nuradiomc_tpu_torch.sim import evtgen, io_input
from nuradiomc_tpu_torch.sim import veff as veff_util
from nuradiomc_tpu_torch.utils import device as device_util


def hdf5() -> bool:
    """Whether h5py imports here (the HDF5 route)."""
    return importlib.util.find_spec("h5py") is not None


def parser(description: str) -> argparse.ArgumentParser:
    """The example's command line, with ``--device`` (the card by default)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    return p


def setup(args, device, dtype, default_dtype, outdir):
    """(device, dtype) of a run: the ``device`` argument, else ``--device``,
    else the card (which raises without one); ``dtype`` or the JAX example's
    ``default_dtype``. Makes ``outdir``."""
    if device is None:
        device = args.device if args.device is not None else device_util.DEFAULT
    os.makedirs(outdir, exist_ok=True)
    return device_util.resolve(device), default_dtype if dtype is None else dtype


def write_event_list(path, data, attrs):
    """``evtgen``'s ``(data, attrs)`` written to ``path`` (``.hdf5``) where
    h5py imports, else to its ``.npz`` export beside it; returns (path
    written, route)."""
    if hdf5():
        evtgen.write_events_to_hdf5(path, data, attrs)
        return path, "hdf5"
    npz = os.path.splitext(path)[0] + ".npz"
    io_input.write_input_npz(io_input.from_generated(data, attrs), npz)
    return npz, "npz (no h5py)"


def event_list(path):
    """The event list ``path`` names: the ``.hdf5`` file where h5py imports
    and it exists, else its ``.npz`` export."""
    npz = os.path.splitext(path)[0] + ".npz"
    if path.endswith(".npz") or (hdf5() and os.path.exists(path)) or not os.path.exists(npz):
        return path
    return npz


def output_paths(path):
    """(HDF5 output file for ``Simulation`` or None, the results ``.npz``
    written instead or None) of an output named ``path``."""
    if hdf5():
        return path, None
    return None, os.path.splitext(path)[0] + ".npz"


# the input's columns of a results file
INPUT_KEYS = ("event_group_ids", "shower_ids", "xx", "yy", "zz", "zeniths", "energies")


def save_results(path, results, sim) -> None:
    """The output file's top-level rows from the results dict of
    ``Simulation.run`` and its ``Simulation``, as ``.npz``: one row per
    shower (the input's columns, the group's decision, weight and
    per-trigger decisions), the attributes ``sim.veff`` reads (those the run
    has), and each station's decision per group (``station_triggered``
    [stations, groups])."""
    inp = sim.input
    gids = np.asarray(inp.event_group_ids)
    idx = np.searchsorted(results["group_ids"], gids)
    sids = sorted(results["triggered_per_station"])
    attrs = {**inp.attrs, "Vrms": sim.Vrms, "trigger_names": np.array(results["trigger_names"])}
    np.savez(path, **{k: np.asarray(getattr(inp, k)) for k in INPUT_KEYS},
             triggered=results["triggered"][idx], weights=results["weights"][idx],
             multiple_triggers=results["multiple_triggers"][idx],
             group_ids=results["group_ids"], station_ids=np.array(sids, dtype=np.int64),
             station_triggered=np.array([results["triggered_per_station"][s] for s in sids]),
             **{k: attrs[k] for k in veff_util.ATTR_KEYS if k in attrs})


def load_results(path) -> dict:
    """A results file of :func:`save_results`."""
    with np.load(path) as z:
        return {k: z[k][()] if z[k].ndim == 0 else z[k] for k in z.files}


def veff_tables(path_or_folder, **kwargs) -> tuple:
    """(tables, route): ``veff.get_Veff_Aeff`` of the output HDF5 file(s)
    where h5py imports, else ``veff.veff_aeff_of_rows`` of the results
    file(s) written in their place."""
    if hdf5():
        return veff_util.get_Veff_Aeff(path_or_folder, **kwargs), "hdf5"
    if os.path.isdir(path_or_folder):
        files = sorted(os.path.join(path_or_folder, f) for f in os.listdir(path_or_folder)
                       if f.endswith(".npz"))
    else:
        files = [os.path.splitext(path_or_folder)[0] + ".npz"]
    return ([veff_util.veff_aeff_of_rows(load_results(f), **kwargs) for f in files],
            "results dict (no h5py)")
