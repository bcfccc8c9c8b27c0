# copied from nuradiomc_tpu/utils/plotting.py:1-45 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""Plotting helpers (NuRadioMC/utilities/plotting.py:6-51)."""

from __future__ import annotations

import numpy as np

from nuradiomc_tpu_torch.utils import units


def plot_vertex_distribution(xx, yy, zz, weights=None, rmax=None, zmin=None,
                             trigger_name=""):
    """Weighted 2D histogram of triggered vertex positions in (r, z)
    (plotting.plot_vertex_distribution:6-51). Returns (fig, ax)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    xx, yy, zz = (np.asarray(a, dtype=float) for a in (xx, yy, zz))
    if weights is None:
        weights = np.ones_like(xx)
    weights = np.asarray(weights, dtype=float)

    fig, ax = plt.subplots(1, 1)
    rr = np.hypot(xx, yy)
    mask_weight = weights > 1e-2
    max_r = rr[mask_weight].max() if mask_weight.any() else rr.max()
    max_z = np.abs(zz[mask_weight]).max() if mask_weight.any() else np.abs(zz).max()
    if rmax is None:
        rmax = max_r
    if zmin is None:
        zmin = zz.min()
    h = ax.hist2d(rr / units.m, zz / units.m,
                  bins=[np.linspace(0, max(max_r, 1e-9), 50),
                        np.linspace(-max(max_z, 1e-9), 0, 50)],
                  cmap=plt.get_cmap("Blues"), weights=weights)
    fig.colorbar(h[3], ax=ax).set_label("# (weighted)")
    ax.set_aspect("equal")
    ax.set_xlabel("r [m]")
    ax.set_ylabel("z [m]")
    ax.set_xlim(0, rmax)
    ax.set_ylim(zmin, 0)
    if trigger_name:
        ax.set_title(f"trigger: {trigger_name}")
    fig.tight_layout()
    return fig, ax
