"""The control of the benchmark's comparison: the configuration's reference
computed in float32 (chain and weights), put in the program's place, against the
reference in float64 on the same lists; beside it the port's own float32
path (``Simulation(dtype=torch.float32)``), which keeps its weights in
float64. Each must fail at least one of the configuration's limits.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--events N]

prints one JSON line per seed with both readings. The lists are those of a
benchmark run with that ``--seed`` (list 0 of its pool), at the cell's own
size unless ``--events`` is given. Run on the card; ``--device cpu`` for a
rehearsal."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings_of(workload, seed, device, events=None, with_program=True):
    """{"control": readings, "program_f32": readings or None, "limits": ...}
    for list 0 of a run of ``workload`` with ``--seed seed``."""
    import numpy as np
    import torch

    from portbench import compare, harness
    from portbench.traffic import generator

    torch.backends.cuda.matmul.allow_tf32 = False
    bench = harness.benchmark()
    cell, entry = harness.cell_of(bench, workload)
    cfg = harness.load_config(entry)
    Job = harness.reference_module(cfg).Job
    mix = harness.load_mix(cell["traffic"])
    if events is not None:
        mix = {**mix, "events_per_job": int(events)}
    out = {"seed": seed, "limits": cfg["limits"]}
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
        data, attrs = generator.make_list(mix, seed, 0)
        path = Path(tmp) / "list_0.npz"
        generator.write_list(path, data, attrs)
        cseed = harness.config_seed(seed, 0)
        ref64 = Job(cfg, device, torch.float64)
        ref = ref64.run(path, cseed)
        low = Job(cfg, device, torch.float32).run(path, cseed, weight_dtype=np.float32)
        out["control"] = compare.readings(low, ref, ref64.Vrms)
        out["program_f32"] = None
        if with_program:
            make = harness.simulation_factory(cfg, device, torch.float32)
            out["program_f32"] = compare.readings(make(path, cseed).run(), ref, ref64.Vrms)
    out["n_triggered"] = int(ref["triggered"].sum())
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--events", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings_of(args.workload, seed, args.device, args.events)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
