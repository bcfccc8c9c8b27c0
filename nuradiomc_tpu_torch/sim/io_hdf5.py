# copied from nuradiomc_tpu/sim/io_hdf5.py:1-209 (the port keeps its own copy; it imports nothing of the JAX package)
"""HDF5 event-list input reading and output writing.

Input format: the reference generator's per-shower tables
(NuRadioMC/EvtGen/generator.py:88-199 write_events_to_hdf5) with columns
xx/yy/zz/zeniths/azimuths/energies/shower_energies/shower_type/flavors/
interaction_type/inelasticity/event_group_ids/shower_ids/vertex_times and
file-level attrs (n_events, volume, thetamin/max, ...).

Output: the documented HDF5 schema subset
(documentation/source/NuRadioMC/pages/HDF5_structure.rst:100-182, written by
simulation/output_writer_hdf5.py): per-shower top-level arrays, OR-aggregated
trigger flags, per-station groups, and Veff bookkeeping attrs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EventInput:
    """Per-shower flat arrays as read from the input file."""

    event_group_ids: np.ndarray
    shower_ids: np.ndarray
    xx: np.ndarray
    yy: np.ndarray
    zz: np.ndarray
    zeniths: np.ndarray
    azimuths: np.ndarray
    energies: np.ndarray          # neutrino energy
    shower_energies: np.ndarray
    shower_type: np.ndarray       # 'had' / 'em'
    flavors: np.ndarray
    interaction_type: np.ndarray  # 'cc' / 'nc'
    inelasticity: np.ndarray
    vertex_times: np.ndarray
    attrs: dict
    # persisted per-shower signal-model realizations of a previous run
    # (simulation.py:737-740); None when absent from the input file
    shower_realization_Alvarez2009: np.ndarray = None
    shower_realization_ARZ: np.ndarray = None
    # emitter-mode per-row columns (attrs simulation_mode == 'emitter',
    # generator write side: examples/05_pulser_calibration A01; read side:
    # simulation.py:750-758 reads every 'emitter_<param>' dataset)
    emitter: dict = None

    @property
    def n_showers(self) -> int:
        return len(self.shower_ids)


def read_input_hdf5(path: str) -> EventInput:
    """Load the full input file into memory (simulation.py:1019-1057)."""
    import h5py      # imported here: only HDF5 input and output need h5py
    with h5py.File(path, "r") as f:
        def get(key, default=None):
            if key in f:
                return np.asarray(f[key])
            return default

        n = len(f["shower_ids"])
        mode = f.attrs.get("simulation_mode", "neutrino")
        mode = mode.decode() if isinstance(mode, bytes) else str(mode)
        emitter = None
        if mode == "emitter":
            # emitter event lists carry emitter_* columns and usually no
            # shower kinematics — synthesize neutral defaults for those
            emitter = {k: np.asarray(f[k]) for k in f.keys()
                       if k.startswith("emitter_")}
        amps = get("emitter_amplitudes", np.zeros(n))

        def strings(key, default):
            raw = get(key)
            if raw is None:
                return np.full(n, default, dtype="U8")
            return np.array([s.decode() if isinstance(s, bytes) else s
                             for s in raw])

        return EventInput(
            event_group_ids=get("event_group_ids"),
            shower_ids=get("shower_ids"),
            xx=get("xx"), yy=get("yy"), zz=get("zz"),
            zeniths=get("zeniths", np.zeros(n)),
            azimuths=get("azimuths", np.zeros(n)),
            energies=get("energies", amps),
            shower_energies=get("shower_energies",
                                get("energies", amps)),
            shower_type=strings("shower_type", "had"),
            flavors=get("flavors", np.zeros(n, dtype=int)),
            interaction_type=strings("interaction_type", "nc"),
            inelasticity=get("inelasticity", np.ones(n)),
            vertex_times=get("vertex_times", np.zeros(n)),
            attrs=dict(f.attrs),
            shower_realization_Alvarez2009=get("shower_realization_Alvarez2009"),
            shower_realization_ARZ=get("shower_realization_ARZ"),
            emitter=emitter,
        )


def group_showers(inp: EventInput):
    """Group per-shower rows by event_group_id.

    Returns (group_ids [G], group_start [G], group_count [G], order) where
    ``order`` sorts rows by group (stable).
    """
    order = np.argsort(inp.event_group_ids, kind="stable")
    sorted_ids = inp.event_group_ids[order]
    group_ids, start, count = np.unique(sorted_ids, return_index=True,
                                        return_counts=True)
    return group_ids, start, count, order


def write_output_hdf5(path: str, inp: EventInput, results: dict, attrs: dict):
    """Write the output file (subset of output_writer_hdf5.py:448-553).

    ``results`` holds per-shower and per-group arrays produced by the
    simulation: at minimum 'triggered' [n_showers], 'weights' [n_showers],
    plus optional per-station datasets under results['station_<id>'].
    """
    import h5py
    with h5py.File(path, "w") as f:
        for key in ("event_group_ids", "shower_ids", "xx", "yy", "zz",
                    "zeniths", "azimuths", "energies", "shower_energies",
                    "flavors", "inelasticity", "vertex_times"):
            f[key] = getattr(inp, key)
        f["shower_type"] = np.array(inp.shower_type, dtype="S")
        f["interaction_type"] = np.array(inp.interaction_type, dtype="S")
        for key, val in results.items():
            if key.startswith("station_"):
                grp = f.create_group(key)
                for k2, v2 in val.items():
                    grp[k2] = v2
            else:
                f[key] = val
        for k, v in inp.attrs.items():
            f.attrs[k] = v
        for k, v in attrs.items():
            f.attrs[k] = v


def dump_hdf5(filename, max_events=None, out=None):
    """Human-readable dump of a simulation output HDF5 file
    (NuRadioMC/utilities/dump_hdf5.py:45-87): per event-group the event-level
    columns, then for every station/channel/ray the ray-tracing observables
    and the receive direction in degrees."""
    import sys

    import h5py

    from nuradiomc_tpu_torch.utils import units as _units

    out = out or sys.stdout
    keys_event = ["event_group_ids", "azimuths", "energies", "flavors",
                  "inelasticity", "interaction_type", "multiple_triggers",
                  "n_interaction", "triggered", "xx", "yy", "zeniths", "zz",
                  "weights"]
    station_keys = ["max_amp_shower_and_ray", "ray_tracing_C0",
                    "ray_tracing_C1", "ray_tracing_solution_type",
                    "travel_times", "travel_distances"]
    station_keys_3dim = ["launch_vectors", "polarization", "receive_vectors"]

    with h5py.File(filename, "r") as fin:
        stations = [k for k in fin if k.startswith("station_")]
        event_group_ids = np.asarray(fin["event_group_ids"])
        n = len(event_group_ids) if max_events is None else \
            min(max_events, len(event_group_ids))
        for iE in range(n):
            print("index, " + ", ".join(k for k in keys_event if k in fin),
                  file=out)
            print(f"{iE} " + " ".join(str(np.asarray(fin[k][iE]))
                                      for k in keys_event if k in fin),
                  file=out)
            for station in stations:
                grp = fin[station]
                if "ray_tracing_C0" not in grp:
                    print(f"{station} has no entries", file=out)
                    continue
                nCh, nR = np.asarray(grp["ray_tracing_C0"][iE]).shape
                for iCh in range(nCh):
                    for iR in range(nR):
                        t = f"\t{station} {iCh} {iR}: "
                        for key in station_keys:
                            if key in grp:
                                t += f"{grp[key][iE][iCh][iR]:.9g} "
                        for key in station_keys_3dim:
                            if key in grp:
                                t += "(" + ",".join(
                                    f"{grp[key][iE][iCh][iR][iD]:.5g}"
                                    for iD in range(3)) + ") "
                        if "receive_vectors" in grp:
                            rv = np.asarray(grp["receive_vectors"][iE][iCh][iR])
                            zen = np.arccos(np.clip(
                                rv[2] / max(np.linalg.norm(rv), 1e-300), -1, 1))
                            az = np.mod(np.arctan2(rv[1], rv[0]), 2 * np.pi)
                            t += (f" {zen / _units.deg:.2f}"
                                  f" {az / _units.deg:.2f}")
                        print(t, file=out)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="Dump a NuRadioMC HDF5 file")
    parser.add_argument("file")
    parser.add_argument("--max-events", type=int, default=None)
    args = parser.parse_args()
    dump_hdf5(args.file, max_events=args.max_events)
