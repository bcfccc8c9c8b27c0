# copied from nuradiomc_tpu/detector/browser.py:1-63 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""Detector layout browser (CLI replacement for the reference's Dash app,
NuRadioReco/detector/detector_browser): renders per-station channel maps.

Usage:  python -m nuradiomc_tpu_torch.detector.browser detector.json --out plots/
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nuradiomc_tpu_torch.detector.detector import Detector


def plot_station(det, station_id, out_dir):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cids = det.get_channel_ids(station_id)
    pos = np.array([det.get_relative_position(station_id, c) for c in cids])
    fig = plt.figure(figsize=(11, 5))
    ax1 = fig.add_subplot(121)
    ax2 = fig.add_subplot(122)
    ax1.scatter(pos[:, 0], pos[:, 1], c=pos[:, 2], cmap="viridis")
    for c, p in zip(cids, pos):
        ax1.annotate(str(c), (p[0], p[1]), fontsize=8)
        ax2.annotate(str(c), (np.hypot(p[0], p[1]), p[2]), fontsize=8)
    ax1.set_xlabel("x [m]")
    ax1.set_ylabel("y [m]")
    ax1.set_title(f"station {station_id} — top view")
    ax1.set_aspect("equal")
    ax2.scatter(np.hypot(pos[:, 0], pos[:, 1]), pos[:, 2])
    ax2.set_xlabel("r [m]")
    ax2.set_ylabel("z [m]")
    ax2.set_title("side view")
    models = sorted({det.get_antenna_model(station_id, c) for c in cids})
    fig.suptitle(", ".join(models), fontsize=9)
    fig.tight_layout()
    out = os.path.join(out_dir, f"station_{station_id}.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Plot detector station layouts")
    p.add_argument("detector", help="detector JSON file")
    p.add_argument("--out", default=".", help="output directory")
    p.add_argument("--station", type=int, default=None,
                   help="only this station id")
    args = p.parse_args(argv)
    det = Detector(args.detector)
    os.makedirs(args.out, exist_ok=True)
    sids = [args.station] if args.station is not None else det.get_station_ids()
    for sid in sids:
        print("wrote", plot_station(det, sid, args.out))


if __name__ == "__main__":
    main()
