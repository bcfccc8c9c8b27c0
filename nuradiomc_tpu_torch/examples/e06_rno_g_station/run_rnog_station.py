"""An RNO-G station: deep phased-array Veff, FLOWER trigger board, surface
trigger and the data-cleaning chain.

Counterpart of ``examples/06_rno_g_station/run_rnog_station.py`` (NuRadioMC's
examples 07_RNO_G_simulation and RNO_G_trigger_simulation/simulate.py):

1. the deep 4-channel VPol phased array at ~100 m with noise, the trigger
   ADC (8 bits, 2 noise counts) and upsampling, the power trigger at the
   ~100 Hz working point, Greenland ice with GL1 and focusing, Alvarez2009,
   float32, chunks of 256, on the card (kernels 1 and 3), for 1000 events at
   1e18 eV, seed 42 (or the argument's count);
2. the FLOWER board's noise-bit gain equalization and 8-bit ADC on four
   trigger channels of one readout event (numpy seed 7: an impulsive
   signal on thermal noise with 128-sample block pedestals);
3. the RNO-G surface trigger (Schottky-diode envelope) on upward LPDAs;
4. block-offset removal, the glitch scan and the hit filter on the same
   event. Steps 2-4 run their array work on the same device.

The default list is read from ``io_input.INPUT_RNOG``, the ``.npz`` export
of the list the JAX example writes into its own directory (it needs no
h5py); another count is generated in memory with the same seed, which the
port's generator draws exactly as the JAX package's does. Noise comes from
the port's generators, so the triggered count is held to the JAX example's
statistically::

    python -m nuradiomc_tpu_torch.examples.e06_rno_g_station.run_rnog_station [n_events]
"""

from __future__ import annotations

import numpy as np
import torch

from nuradiomc_tpu_torch.detector.detector import Detector
from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.framework import event as fev
from nuradiomc_tpu_torch.reco.rnog import rnogSurfaceTrigger, triggerBoardResponse
from nuradiomc_tpu_torch.reco.rnog_data import (channelBlockOffsets, channelGlitchDetector,
                                                stationHitFilter)
from nuradiomc_tpu_torch.sim import evtgen, io_input
from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
from nuradiomc_tpu_torch.utils import units

DETECTOR = {
    "channels": {str(i + 1): {
        "adc_n_samples": 256, "adc_sampling_frequency": 0.472, "adc_nbits": 8,
        "ant_orientation_phi": 0.0, "ant_orientation_theta": 0.0,
        "ant_position_x": 0.0, "ant_position_y": 0.0,
        "ant_position_z": -97.0 - i,
        "ant_rotation_phi": 90.0, "ant_rotation_theta": 90.0,
        "ant_type": "analytic_VPol", "amp_type": "", "cab_time_delay": 45.0,
        "channel_id": i, "station_id": 11,
        "trigger_adc_noise_count": 2, "trigger_adc_nbits": 8,
        "trigger_adc_max_voltage": 1.0 * units.volt,
        "trigger_adc_min_voltage": -1.0 * units.volt,
    } for i in range(4)},
    "stations": {"1": {"station_id": 11, "pos_altitude": 0, "pos_easting": 0,
                       "pos_northing": 0, "pos_site": "summit"}},
}
VOLUME = {"fiducial_rmin": 0, "fiducial_rmax": 2 * units.km,
          "fiducial_zmin": -2.5 * units.km, "fiducial_zmax": 0}
N_DEFAULT = 1000          # the count of io_input.INPUT_RNOG
CONFIG = {"sampling_rate": 2.0, "noise": True,
          "propagation": {"ice_model": "greenland_simple", "attenuation_model": "GL1",
                          "focusing": True},
          "signal": {"model": "Alvarez2009"},
          "weights": {"weight_mode": "core_mantle_crust_simple"}}
FILTERS = [FilterStage((96 * units.MHz, 100 * units.GHz), "cheby1", {"order": 4, "rp": 0.1}),
           FilterStage((0, 220 * units.MHz), "cheby1", {"order": 7, "rp": 0.1})]
TRIGGER = TriggerSpec(trigger_type="phased_array", pa_threshold_factor=30.85)


def readout_event(ev=fev):
    """The example's readout event: four channels of 2048 samples at 0.472
    GHz from numpy's default_rng(7), built from the event data model ``ev``
    (``framework.event`` of either package)."""
    rng = np.random.default_rng(7)
    fs, n = 0.472, 2048
    evt = ev.Event(0, 1)
    st = ev.Station(11)
    for cid in range(4):
        tr = rng.normal(0.0, 1.0e-3, n)
        t0 = 900 + 40 * cid
        tt = np.arange(n) / fs
        tr += 12e-3 * np.exp(-0.5 * ((tt - tt[t0]) / 8.0) ** 2) \
            * np.cos(2 * np.pi * 0.15 * (tt - tt[t0]))
        tr += np.repeat(rng.normal(0, 0.5e-3, n // 128), 128)  # block pedestals
        ch = ev.Channel(cid)
        ch.set_trace(tr, fs)
        st.add_channel(ch)
    evt.set_station(st)
    return evt, st


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("n_events", nargs="?", type=int, default=N_DEFAULT)
    args = p.parse_args(argv)
    device, dtype = _common.setup(args, device, dtype, torch.float32, outdir)
    n_events = args.n_events
    if n_events == N_DEFAULT:
        inp, route = io_input.read_input(io_input.INPUT_RNOG), "data/rnog_events_1000.npz"
    else:
        inp = io_input.from_generated(*evtgen.generate_eventlist_cylinder(
            None, n_events, 1e18, 1e18, VOLUME, seed=42))
        route = "generated in memory"
    sim = Simulation(inp, DETECTOR, config=CONFIG, filter_chain=FILTERS,
                     trigger=TRIGGER, chunk_size=256, device=device, dtype=dtype)
    results = sim.run()
    print(f"event list: {route}")
    print(f"deep PA: {results['n_triggered']}/{n_events} triggered, "
          f"Veff = {results['veff'] / units.km ** 3:.4f} km^3")

    evt, st = readout_event()
    board = triggerBoardResponse(device=device)
    board.begin(adc_output="voltage")
    surf_det = Detector({
        "channels": {str(c + 1): {**DETECTOR["channels"]["1"], "channel_id": c,
                                  "ant_position_z": -2.0, "ant_orientation_theta": 180.0,
                                  "ant_type": "analytic_LPDA"}
                     for c in range(4)},
        "stations": DETECTOR["stations"]})
    eq_vrms = board.run(evt, st, surf_det, trigger_channels=[0, 1, 2, 3])
    print(f"FLOWER board: equalized Vrms = {np.round(eq_vrms * 1e3, 3)} mV "
          f"(8-bit ADC applied)")

    surface = rnogSurfaceTrigger(device=device)
    surface.begin()
    surface.run(evt, st, surf_det, threshold=5 * units.mV,
                triggered_channels=[0, 1, 2, 3], number_coincidences=2)
    fired = st.get_trigger("rnog_surface_trigger").has_triggered()
    print(f"surface trigger fired: {fired}")

    offsets = channelBlockOffsets(device=device)
    offsets.begin()
    offsets.run(evt, st)
    glitch = channelGlitchDetector(device=device)
    glitch.begin()
    glitch.run(evt, st)
    hits = stationHitFilter(device=device)
    hits.begin()
    passed = hits.run(evt, st)
    print(f"cleaning chain: block offsets removed, glitch scan done, "
          f"hit filter -> {bool(passed)}")
    traces = np.array([np.asarray(st.get_channel(c).get_trace()) for c in range(4)])
    return {"n_triggered": results["n_triggered"], "veff": results["veff"],
            "results": results, "eq_vrms": np.asarray(eq_vrms), "surface_fired": bool(fired),
            "hit_filter": bool(passed), "traces": traces}


if __name__ == "__main__":
    main()
