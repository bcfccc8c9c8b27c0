"""The in-ice reconstruction chain on a synthetic event.

Counterpart of ``examples/04_vertex_direction_reco/run_reco_chain.py``:
eight channels on three strings (``reco.examples.RECO_CHAIN_DETECTOR``),
Greenland ice with GL1, an event made with the direction reconstructor's own
forward model at the truth (vertex (380, 240, -600) m, zenith 120 deg,
azimuth 35 deg, log10 E 17.5) plus 3% white noise (numpy seed 0,
``reco.examples.reco_chain_event``); then

1. the vertex from channel-pair timing (travel-time tables at 5 m steps,
   a correlation stack of 18 steps a side with three zooms);
2. the direction and shower energy by forward folding at the reconstructed
   vertex (+-10 deg, +-1 dex, 9 steps a side, two zooms).

Tables, stacks and the chi2 grid run on the device, float64. ``--grid``
(m), ``--vertex-steps`` and ``--direction-steps`` coarsen the search for a
quick run::

    python -m nuradiomc_tpu_torch.examples.e04_vertex_direction_reco.run_reco_chain
"""

from __future__ import annotations

import numpy as np

from nuradiomc_tpu_torch.detector.detector import Detector
from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.framework import event as fev
from nuradiomc_tpu_torch.models import ice as ice_models
from nuradiomc_tpu_torch.reco import examples
from nuradiomc_tpu_torch.reco.nu_direction import neutrinoDirectionReconstructor
from nuradiomc_tpu_torch.reco.vertex import neutrino3DVertexReconstructor

TRUTH = examples.RECO_CHAIN_TRUTH


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("--grid", type=float, default=5.0)
    p.add_argument("--vertex-steps", type=int, default=18)
    p.add_argument("--direction-steps", type=int, default=9)
    p.add_argument("--direction-zooms", type=int, default=2)
    args = p.parse_args(argv)
    device, _ = _common.setup(args, device, dtype, None, outdir)
    ice = ice_models.get_ice_model(examples.GREENLAND)
    det = Detector(examples.RECO_CHAIN_DETECTOR)
    n_ch = len(examples.RECO_CHAIN_POSITIONS)
    channels = list(range(n_ch))
    dir_reco = neutrinoDirectionReconstructor(device=device)
    dir_reco.begin(ice, attenuation_model="GL1")
    evt, st, noise = examples.reco_chain_event(fev, dir_reco, det)

    tab_kw = dict(x_min=20.0, x_max=1200.0, d_x=args.grid,
                  z_min=-1100.0, z_max=-30.0, d_z=args.grid)
    v_reco = neutrino3DVertexReconstructor(ice, table_kwargs=tab_kw, device=device)
    v_reco.begin(1, channels, det)
    vertex = np.asarray(v_reco.run(evt, st, max_distance=1000.0, z_range=(-1000.0, -50.0),
                                   coarse_steps=args.vertex_steps, n_zoom=3))
    print(f"vertex: true {TRUTH['vertex']}, reco {np.round(vertex, 1)}")

    zen_true, az_true, logE_true = TRUTH["zenith"], TRUTH["azimuth"], TRUTH["log10_energy"]
    steps = args.direction_steps
    zen, az, logE = dir_reco.run(
        evt, st, det, vertex=vertex, noise_RMS=noise, use_channels=channels,
        zenith_range=(zen_true - np.deg2rad(10), zen_true + np.deg2rad(10)),
        azimuth_range=(az_true - np.deg2rad(10), az_true + np.deg2rad(10)),
        energy_range=(logE_true - 1, logE_true + 1),
        coarse_steps=(steps, steps, steps), n_zoom=args.direction_zooms)
    print(f"direction: true ({np.rad2deg(zen_true):.1f}, {np.rad2deg(az_true):.1f}) deg, "
          f"reco ({np.rad2deg(zen):.1f}, {np.rad2deg(az):.1f}) deg")
    print(f"log10 shower energy: true {logE_true:.2f}, reco {logE:.2f}")
    return {"vertex": vertex, "direction": (float(zen), float(az)), "log10_energy": float(logE),
            "traces": np.array([np.asarray(st.get_channel(c).get_trace()) for c in channels]),
            "noise": noise}


if __name__ == "__main__":
    main()
