"""Interoperability: event files and trigger modules.

Counterpart of ``examples/08_interop/run_interop.py``:

1. 120 events (or the argument's count) at 1e18 eV, seed 7, through four
   VPols in float64 on the card (kernels 1 and 2) with the triggered events
   written to ``events.nur`` (the port's format);
2. the events re-exported in NuRadioReco's own ``.nur`` format
   (``sim/io_nur_reference.py``) to ``events_reference_format.nur``, read
   back through the reader that detects the format, and every event
   re-triggered by the module-level high/low trigger at the run's 2 sigma,
   whose array work runs on the same device. Every exported event must fire.

The list is made in memory (the JAX example writes it to HDF5 first)::

    python -m nuradiomc_tpu_torch.examples.e08_interop.run_interop [n_events]
"""

from __future__ import annotations

import os

import torch

from nuradiomc_tpu_torch.detector.detector import Detector
from nuradiomc_tpu_torch.examples import _common
from nuradiomc_tpu_torch.examples.e05_multichip.run_sharded_veff import (
    CONFIG, DETECTOR, FILTERS, VOLUME)
from nuradiomc_tpu_torch.reco import trigger_modules as tm
from nuradiomc_tpu_torch.sim import evtgen, io_input, io_nur, io_nur_reference
from nuradiomc_tpu_torch.sim.simulation import Simulation, TriggerSpec


def main(argv=None, *, device=None, dtype=None, outdir="."):
    p = _common.parser(__doc__.splitlines()[0])
    p.add_argument("n_events", nargs="?", type=int, default=120)
    args = p.parse_args(argv)
    device, dtype = _common.setup(args, device, dtype, torch.float64, outdir)
    n_events = args.n_events
    data, attrs = evtgen.generate_eventlist_cylinder(None, n_events, 1e18, 1e18, VOLUME,
                                                     seed=7)
    own_nur = os.path.join(outdir, "events.nur")
    sim = Simulation(io_input.from_generated(data, attrs), DETECTOR, config=CONFIG,
                     filter_chain=FILTERS,
                     trigger=TriggerSpec(threshold_high_sigma=2.0, threshold_low_sigma=-2.0),
                     chunk_size=128, device=device, dtype=dtype, nur_outputfilename=own_nur)
    res = sim.run()
    print(f"simulated {n_events} events, {res['n_triggered']} triggered")

    ref_nur = os.path.join(outdir, "events_reference_format.nur")
    writer = io_nur_reference.eventWriter()
    writer.begin(ref_nur)
    events = list(io_nur.EventReader(own_nur).run())
    for evt in events:
        writer.run(evt)
    writer.end()
    print(f"wrote {len(events)} events in reference .nur format -> "
          f"{os.path.basename(ref_nur)}")

    det = Detector(DETECTOR)
    reader = io_nur.EventReader(ref_nur)
    high_low = tm.triggerSimulatorHighLow(device=device)
    n_trig = 0
    read_back = []
    for evt in reader.run():
        station = evt.get_station(101)
        fired = high_low.run(evt, station, det, threshold_high=2 * sim.Vrms,
                             threshold_low=-2 * sim.Vrms, number_concidences=1)
        n_trig += bool(fired)
        read_back.append(evt.get_id())
    reader.end()
    print(f"module-level high/low re-trigger on re-imported events: "
          f"{n_trig}/{len(events)} fired")
    if n_trig != len(events):
        raise RuntimeError("an exported (triggered) event did not fire on re-import")
    print("interop roundtrip OK")
    return {"n_triggered": res["n_triggered"], "n_exported": len(events),
            "n_refired": n_trig, "event_ids": read_back, "results": res,
            "events": events}


if __name__ == "__main__":
    main()
