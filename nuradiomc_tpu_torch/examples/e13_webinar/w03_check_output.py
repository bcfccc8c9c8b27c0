"""Webinar part 3: the simulation's output.

Counterpart of ``examples/13_webinar/W03_check_output.py``: the rows that
fired the first named trigger, their weighted count and vertex ranges, from
the output HDF5 where h5py imports, else from its ``.npz`` (the results
dict); the vertex histograms are drawn where matplotlib imports::

    python -m nuradiomc_tpu_torch.examples.e13_webinar.w03_check_output [output]
"""

from __future__ import annotations

import os

import numpy as np

from nuradiomc_tpu_torch.examples import _common

KEYS = ("xx", "yy", "zz", "weights", "multiple_triggers")


def _read(path):
    """(rows, trigger names, route) of an output file."""
    if _common.hdf5():
        import h5py

        with h5py.File(path, "r") as fin:
            names = [t.decode() if isinstance(t, bytes) else str(t)
                     for t in fin.attrs["trigger_names"]]
            return {k: np.array(fin[k]) for k in KEYS}, names, "hdf5"
    res = _common.load_results(os.path.splitext(path)[0] + ".npz")
    return ({k: res[k] for k in KEYS}, [str(t) for t in res["trigger_names"]],
            "results dict (no h5py)")


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("fname", nargs="?", default="results/NuMC_output.hdf5")
    args = p.parse_args(argv)
    _common.setup(args, device, dtype, None, outdir)
    rows, names, route = _read(os.path.join(outdir, args.fname))
    trigger_names = np.array(names)
    print(f"triggers in file ({route}):", names)
    chosen_trigger = trigger_names[0]
    trigger_index = int(np.squeeze(np.argwhere(trigger_names == chosen_trigger)))
    mask = rows["multiple_triggers"][:, trigger_index].astype(bool)
    xx, yy, zz = rows["xx"][mask], rows["yy"][mask], rows["zz"][mask]
    weights = rows["weights"][mask]
    print(f"{mask.sum()} of {len(mask)} events fired '{chosen_trigger}'")
    print(f"weighted count: {weights.sum():.4g}")
    out = {"n_fired": int(mask.sum()), "n_rows": len(mask), "weighted": float(weights.sum()),
           "route": route}
    if mask.any():
        rr = np.sqrt(xx ** 2 + yy ** 2)
        print(f"triggered vertices: r in [{rr.min():.0f}, {rr.max():.0f}] m,"
              f" z in [{zz.min():.0f}, {zz.max():.0f}] m")
        out.update(r=(float(rr.min()), float(rr.max())), z=(float(zz.min()), float(zz.max())))
    try:
        import matplotlib
    except ImportError:
        print("plotting skipped: matplotlib is not installed")
        return out
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    ax1.hist2d(xx, yy, bins=25, weights=weights)
    ax1.set_xlabel("x [m]"), ax1.set_ylabel("y [m]")
    ax2.hist2d(np.sqrt(xx ** 2 + yy ** 2), zz, bins=25, weights=weights)
    ax2.set_xlabel("r [m]"), ax2.set_ylabel("z [m]")
    fig.suptitle(f"triggered vertices ({chosen_trigger})")
    fig.savefig(os.path.join(outdir, "vertex_distributions.png"), dpi=100)
    plt.close(fig)
    print("wrote vertex_distributions.png")
    return out


if __name__ == "__main__":
    main()
