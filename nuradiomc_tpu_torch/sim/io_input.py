"""Event-list input without h5py: an ``.npz`` export of an input HDF5 file.

Where h5py is missing, the port's ``Simulation`` reads an ``.npz`` file that
holds exactly what ``io_hdf5.read_input_hdf5`` builds from the HDF5 file:
the per-shower columns as ``col_<name>``, the file attributes as
``attr_<name>`` and emitter columns as ``emitter_<name>``, read back into
``io_hdf5.EventInput`` (the port's copy, which imports h5py only inside its
HDF5 functions), so reading needs neither h5py nor jax.

Export an input file on a machine with h5py:

    python -m nuradiomc_tpu_torch.sim.io_input tests/data/1e18_n3000.hdf5 \\
        nuradiomc_tpu_torch/data/1e18_n3000.npz
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

from nuradiomc_tpu_torch.sim import io_hdf5
from nuradiomc_tpu_torch.sim.io_hdf5 import EventInput

DATA_DIR = Path(__file__).resolve().parents[1] / "data"
# the export of tests/data/1e18_n3000.hdf5 (3000 events, 3724 showers)
INPUT_1E18_N3000 = DATA_DIR / "1e18_n3000.npz"
# the export of .bench_cache/gen2_taus_2048_seed21.hdf5 (2048 tau-neutrino CC
# events at 1e19 eV with stochastic secondaries: 3866 showers, <= 10 per group)
INPUT_GEN2 = DATA_DIR / "gen2_taus_2048_seed21.npz"
# the export of tests/golden/pa_noiseless_input.hdf5 (the 1e18 eV input with
# its Alvarez2009 k_L realizations pinned: the multi-trigger golden's input)
INPUT_PA_NOISELESS = DATA_DIR / "pa_noiseless_input.npz"
# the exports of tests/golden/emitter_events.hdf5 (24 pulser positions,
# efield_delta_pulse) and emitter_voltage_events.hdf5 (the measured hvsp1
# waveform through an emitting antenna)
INPUT_EMITTER_EFIELD = DATA_DIR / "emitter_events.npz"
INPUT_EMITTER_VOLTAGE = DATA_DIR / "emitter_voltage_events.npz"
# the export of examples/06_rno_g_station/rnog_events.hdf5 as that example
# writes it by default (1000 events at 1e18 eV, seed 42, r < 2 km,
# -2.5 km < z < 0)
INPUT_RNOG = DATA_DIR / "rnog_events_1000.npz"

_ARRAYS = [f.name for f in dataclasses.fields(EventInput)
           if f.name not in ("attrs", "emitter")]


def write_input_npz(inp, path) -> None:
    """Write an ``EventInput`` (the port's or the JAX package's) to ``path``."""
    out = {f"col_{name}": np.asarray(getattr(inp, name)) for name in _ARRAYS
           if getattr(inp, name) is not None}
    out.update({f"attr_{k}": np.asarray(v) for k, v in inp.attrs.items()})
    out.update({f"emitter_{k}": np.asarray(v) for k, v in (inp.emitter or {}).items()})
    np.savez_compressed(path, **out)


def read_input_npz(path) -> EventInput:
    """The ``EventInput`` of an export written by :func:`write_input_npz`."""
    with np.load(path, allow_pickle=False) as z:
        cols = {k[4:]: z[k] for k in z.files if k.startswith("col_")}
        # a string attribute comes back as a Python str, as h5py gives it
        attrs = {k[5:]: (str(z[k][()]) if z[k].dtype.kind == "U" else z[k][()])
                 if z[k].ndim == 0 else z[k] for k in z.files if k.startswith("attr_")}
        emitter = {k[8:]: z[k] for k in z.files if k.startswith("emitter_")}
    return EventInput(**cols, attrs=attrs, emitter=emitter or None)


def select(inp: EventInput, group_ids) -> EventInput:
    """The showers of the event groups ``group_ids`` of ``inp``, with
    ``n_events`` scaled to the kept share of groups."""
    ids = np.unique(inp.event_group_ids)
    keep = np.isin(inp.event_group_ids, group_ids)
    n_kept = len(np.unique(np.asarray(inp.event_group_ids)[keep]))
    cut = {name: None if getattr(inp, name) is None else np.asarray(getattr(inp, name))[keep]
           for name in _ARRAYS}
    attrs = dict(inp.attrs)
    if "n_events" in attrs and n_kept < len(ids):
        attrs["n_events"] = int(round(int(attrs["n_events"]) * n_kept / len(ids)))
    emitter = (None if inp.emitter is None
               else {k: np.asarray(v)[keep] for k, v in inp.emitter.items()})
    return EventInput(**cut, attrs=attrs, emitter=emitter)


def head(inp: EventInput, n_groups: int) -> EventInput:
    """The first ``n_groups`` event groups of ``inp``, in the order of their ids."""
    return select(inp, np.unique(inp.event_group_ids)[:n_groups])


def from_generated(data_sets: dict, attributes: dict) -> EventInput:
    """The ``EventInput`` of a list generated in memory (``evtgen``'s
    ``(data, attributes)``), equal to the one that writing it with
    ``evtgen.write_events_to_hdf5`` and reading it back with
    ``io_hdf5.read_input_hdf5`` gives: strings as the decoded bytes of
    their fixed-width columns, scalar attributes as numpy scalars, so a
    campaign needs no file and no h5py."""
    def column(key):
        arr = np.asarray(data_sets[key])
        if arr.dtype.kind in "OU":
            return np.array([s.decode() for s in arr.astype("S")])
        return arr.copy()

    def attribute(value):
        if isinstance(value, str):
            return value
        arr = np.asarray(value)
        return arr[()] if arr.ndim == 0 else arr

    fields = [f.name for f in dataclasses.fields(EventInput)
              if f.name in data_sets and f.name != "attrs"]
    # the columns the HDF5 reader fills in where a list lacks them
    defaults = io_hdf5.input_defaults(len(data_sets["shower_ids"]), data_sets)
    return EventInput(**{**{k: v for k, v in defaults.items() if k not in data_sets},
                         **{name: column(name) for name in fields}},
                      attrs={k: attribute(v) for k, v in attributes.items()})


def read_input(path) -> EventInput:
    """An ``.npz`` export without h5py; any other file through the HDF5
    reader (needs h5py). An ``EventInput`` made in memory passes through."""
    if isinstance(path, EventInput):
        return path
    if str(path).endswith(".npz"):
        return read_input_npz(path)
    return io_hdf5.read_input_hdf5(path)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m nuradiomc_tpu_torch.sim.io_input IN.hdf5 OUT.npz",
              file=sys.stderr)
        return 2
    write_input_npz(io_hdf5.read_input_hdf5(argv[0]), argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
