"""Step 1: a multi-station grid detector as JSON.

Counterpart of ``examples/11_station_coincidences/A01_create_detector.py``:
a 4-channel dipole station at the origin and two more per ring distance
(+x and +y; default rings 750 and 1500 m), written to
``coincidence_detector.json``::

    python -m nuradiomc_tpu_torch.examples.e11_station_coincidences.a01_create_detector [d1,d2,...]
"""

from __future__ import annotations

import json
import os

from nuradiomc_tpu_torch.examples import _common


def _channel(cid, sid, x, y, z):
    return {"adc_n_samples": 256, "adc_sampling_frequency": 1.0,
            "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
            "ant_position_x": x, "ant_position_y": y, "ant_position_z": z,
            "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
            "ant_type": "analytic_VPol", "amp_type": "",
            "cab_time_delay": 0.0, "adc_nbits": None,
            "channel_id": cid, "station_id": sid}


def grid_detector(distances) -> tuple:
    """(detector dict, [(station id, x, y)]) of the grid."""
    det = {"channels": {}, "stations": {}}
    positions = [(101, 0.0, 0.0)]
    sid = 102
    for d in distances:
        positions.append((sid, d, 0.0))
        positions.append((sid + 1, 0.0, d))
        sid += 2
    k = 1
    for sid, x, y in positions:
        det["stations"][str(sid)] = {"station_id": sid, "pos_easting": x,
                                     "pos_northing": y, "pos_altitude": 0}
        for c in range(4):
            # channel positions are relative to the station; the station's
            # offset is its pos_easting / pos_northing
            det["channels"][str(k)] = _channel(c, sid, 0.0, 0.0, -100.0 - 2.0 * c)
            k += 1
    return det, positions


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("distances", nargs="?", default="750,1500")
    args = p.parse_args(argv)
    _common.setup(args, device, dtype, None, outdir)
    det, positions = grid_detector([float(d) for d in args.distances.split(",")])
    with open(os.path.join(outdir, "coincidence_detector.json"), "w") as f:
        json.dump(det, f, indent=2)
    print(f"wrote coincidence_detector.json "
          f"({len(positions)} stations: {[q[0] for q in positions]})")
    return {"detector": det, "stations": [q[0] for q in positions]}


if __name__ == "__main__":
    main()
