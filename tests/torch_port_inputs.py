"""Helper of the port's tests: an event list cut in memory, written as an
input HDF5 file for the JAX package's ``Simulation`` to read."""

import dataclasses

import h5py
import numpy as np

from nuradiomc_tpu_torch.sim.io_hdf5 import EventInput

_ARRAYS = [f.name for f in dataclasses.fields(EventInput)
           if f.name not in ("attrs", "emitter")]


def write_input_hdf5(inp, path) -> None:
    """Write an ``EventInput`` as an input HDF5 file that
    ``io_hdf5.read_input_hdf5`` reads back: the inverse of the port's
    ``.npz`` export."""
    with h5py.File(path, "w") as f:
        for name in _ARRAYS:
            a = getattr(inp, name)
            if a is not None:
                a = np.asarray(a)
                f[name] = a.astype("S") if a.dtype.kind == "U" else a
        for k, v in (inp.emitter or {}).items():
            if k not in f:
                f[k] = np.asarray(v)
        for k, v in inp.attrs.items():
            v = np.asarray(v)
            f.attrs[k] = str(v) if v.dtype.kind == "U" and v.ndim == 0 else (
                v.astype("S") if v.dtype.kind == "U" else v)
