"""One run of one cell of the port's benchmark (see ``run.py``).

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``:
``portbench/configs/<config>.json`` (the configuration as it is run, its
comparison limits and the kernels it uses), ``portbench/traffic/<mix>.json``
(the generator's arguments, ``events_per_job`` and the pool of lists) and
``portbench/metrics/<metric>.py`` (a reader from the run's record to one
number, which may declare the span or op it needs wrapped).

A configuration file may name its plain reference under ``"reference"``: a
dotted module name under ``portbench.reference.`` (default
``portbench.reference.job``) that defines ``Job(cfg, device, dtype)``, whose
``Vrms`` is the noise RMS the amplitudes are judged against and whose
``run(list_path, seed)`` returns the dict of the keys ``compare.readings``
reads (``triggered_per_station`` optional). A name outside that package, or
one that does not import, fails the run before the window. A new
configuration brings its reference as new files beside the others."""

from __future__ import annotations

import importlib.util
import json
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from portbench import compare, tracing
from portbench.traffic import generator

ROOT = Path(__file__).resolve().parents[1]
# whole top-level module names that must not be loaded in the process that
# prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "nuradiomc_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell_of(bench: dict, workload: str):
    """(the cell's entry of ``workloads``, its configuration's entry)."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def load_config(entry: dict, root=ROOT) -> dict:
    return load_json(Path(root) / entry["file"])


DEFAULT_REFERENCE = "portbench.reference.job"
REFERENCE_PACKAGE = "portbench.reference."


def reference_module(cfg: dict):
    """The reference module that the configuration's ``reference`` key
    names; ValueError, naming the key, where it is outside
    ``portbench.reference.``, does not import or defines no ``Job``."""
    name = cfg.get("reference", DEFAULT_REFERENCE)
    if not isinstance(name, str) or not name.startswith(REFERENCE_PACKAGE):
        raise ValueError(f"configuration key 'reference': {name!r} is not a module under "
                         f"{REFERENCE_PACKAGE}")
    try:
        module = importlib.import_module(name)
    except Exception as e:              # a missing or broken module alike
        raise ValueError(f"configuration key 'reference': {name!r} does not import: {e!r}") from e
    if not callable(getattr(module, "Job", None)):
        raise ValueError(f"configuration key 'reference': {name!r} defines no Job")
    return module


def load_mix(name: str, root=ROOT) -> dict:
    return load_json(Path(root) / "portbench" / "traffic" / f"{name}.json")


def load_reader(name: str, root=ROOT):
    """The reader module ``portbench/metrics/<name>.py``."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries that a run of ``workload`` reports: the end-to-end
    ones untraced, the per-layer ones traced."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or workload in m["workloads"]]


def config_seed(seed: int, job: int) -> int:
    """The configuration's ``seed`` (k_L draws, noise) of list ``job``."""
    seq = np.random.SeedSequence([int(seed) % 2 ** 64, int(seed) // 2 ** 64, int(job), 1])
    return int(seq.generate_state(1, np.uint32)[0])


def warmup_events(events_per_job: int, chunk_size: int) -> int:
    """Events of the warm-up list: one full chunk and the last chunk's
    remainder, which are the chunk sizes that a job of the mix runs."""
    if events_per_job <= chunk_size:
        return events_per_job
    return chunk_size + events_per_job % chunk_size


def simulation_factory(cfg: dict, device, dtype):
    """``make(list_path, seed)``: the port's ``Simulation`` of one job, built
    from the configuration file's data as a user builds it."""
    from nuradiomc_tpu_torch.sim.simulation import FilterStage, Simulation, TriggerSpec
    stages = [FilterStage(tuple(f["passband"]), f["filter_type"], dict(f.get("kwargs", {})))
              for f in cfg["filter_chain"]]
    trig = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["trigger"].items()}
    trigger = TriggerSpec(**trig)

    def make(list_path, seed):
        return Simulation(str(list_path), cfg["detector"], config={**cfg["config"], "seed": seed},
                          filter_chain=stages, trigger=trigger,
                          antenna_replacements=dict(cfg["antenna_replacements"]),
                          chunk_size=int(cfg["chunk_size"]), device=device, dtype=dtype)
    return make


def _dtype(name):
    import torch
    return {"float64": torch.float64, "float32": torch.float32}[name]


def _say(err, *lines):
    for line in lines:
        print(line, file=err, flush=True)


def run(args, *, t_start, device=None, events_per_job=None, root=ROOT, out=None,
        err=None) -> int:
    """One run; returns the exit code. ``device`` None is the card (the run
    fails without one); tests pass ``"cpu"``, a smaller ``events_per_job``
    and another ``root`` (a tree of BENCHMARK.json and portbench/'s data
    files) to drive the rest of a run."""
    import torch

    out = out or sys.stdout
    err = err or sys.stderr
    bench = benchmark(root)
    cell, cfg_entry = cell_of(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            _say(err, f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
                      f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = "cuda"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    # the matrix products run in the precision the configuration states
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(cfg_entry, root)
    mix = load_mix(cell["traffic"], root)
    if events_per_job is not None:
        mix = {**mix, "events_per_job": int(events_per_job)}
    dtype = _dtype(cfg["dtype"])
    trace = bool(args.trace)
    entries = cell_metrics(bench, args.workload, trace)
    # the end-to-end metrics are the harness's own host clocks; each
    # per-layer metric has its reader
    readers = {m["name"]: load_reader(m["name"], root) for m in entries} if trace else {}

    marks = [("import", time.perf_counter() - t_start)]
    if on_card:
        torch.cuda.init()
        from nuradiomc_tpu_torch.ops import _build
        _build.build(cfg["kernels"])
        for name in cfg["kernels"]:
            _build.load(name)
    marks.append(("kernels", time.perf_counter() - t_start))
    make = simulation_factory(cfg, device, dtype)
    # after the program's import, which loads what the reference imports
    try:
        reference = reference_module(cfg)
    except ValueError as e:
        _say(err, f"portbench: {cfg_entry['file']}: {e}")
        return 2
    recorder = None
    if trace:
        recorder = tracing.Recorder(dev if on_card else None)
        recorder.install(readers.values())

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    n_pool = int(mix["pool"])
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        # the pool of lists and one warm-up list, from (--seed, list index)
        lists, seeds, events = [], [], []
        warm = {**mix, "events_per_job": warmup_events(int(mix["events_per_job"]),
                                                       int(cfg["chunk_size"]))}
        for k in range(n_pool + 1):
            data, attrs = generator.make_list(mix if k < n_pool else warm, args.seed, k)
            path = Path(tmp) / f"list_{k}.npz"
            generator.write_list(path, data, attrs)
            lists.append(path)
            seeds.append(config_seed(args.seed, k))
            events.append(int(attrs["n_events"]))
        marks.append(("pool", time.perf_counter() - t_start))
        make(lists[n_pool], seeds[n_pool]).run()
        sync()
        setup_s = time.perf_counter() - t_start
        marks.append(("warm-up", setup_s))
        _say(err, "portbench: set-up at " + ", ".join(f"{k} {v:.3f} s" for k, v in marks))

        # the window: jobs back to back while fewer than --seconds have passed
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        jobs = []
        failed = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            k = len(jobs) % n_pool
            if recorder is not None:
                recorder.start_job()
            ts = time.perf_counter()
            try:
                res = make(lists[k], seeds[k]).run()
                sync()
            except Exception:               # a job that fails is counted and shown
                traceback.print_exc(file=err)
                failed += 1
                res = None
            job = {"k": k, "wall_s": time.perf_counter() - ts, "events": events[k], "res": res}
            if recorder is not None:
                job["spans"] = dict(recorder.spans)
            jobs.append(job)
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

        record = {"jobs": jobs, "window_s": window_s, "peak_mem_bytes": peak,
                  "events": sum(j["events"] for j in jobs), "profile": None}
        device_info = {"platform": "gpu" if on_card else dev.type,
                       "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                       "count": int(cell["chips"]) if on_card else 1,
                       "memory_peak_bytes": int(peak)}
        breakdown = None
        if trace and on_card:
            # one whole job of the window under the profiler: the first
            # list again, whose unprofiled wall the window measured
            first = jobs[0]
            prof_wall, events_tr = tracing.profile_job(
                lambda: make(lists[first["k"]], seeds[first["k"]]).run(), recorder)
            t_red = time.perf_counter()
            reduced = tracing.reduce_trace(events_tr)
            del events_tr
            record["profile"] = {**reduced, "wall_s": first["wall_s"],
                                 "profiled_wall_s": prof_wall, "events": first["events"],
                                 "ops": recorder.resolved_ops()}
            device_info.update(busy_s=reduced["busy_s"], window_s=prof_wall)
            breakdown = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
            _say(err, f"portbench: profiled job {prof_wall:.3f} s (unprofiled "
                      f"{first['wall_s']:.3f} s), {reduced['launches']} kernels, trace "
                      f"reduced in {time.perf_counter() - t_red:.1f} s")
        if recorder is not None:
            recorder.uninstall()

        metrics = {}
        if trace:
            for m in entries:
                value = readers[m["name"]].read(record)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            for m in entries:
                if m["name"] == "setup_s":
                    metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
                elif m["name"] == "events_per_s":
                    metrics["events_per_s"] = {"value": record["events"] / window_s,
                                               "unit": m["unit"]}
        _say(err, f"portbench: {len(jobs)} jobs, {record['events']} events in "
                  f"{window_s:.3f} s; setup {setup_s:.3f} s; job walls "
                  + " ".join(f"{j['wall_s']:.3f}" for j in jobs))

        # the comparison: one job of the window drawn from the seed, against
        # the reference's run of its list, once the program's state is freed
        pick = int(np.random.default_rng(np.random.SeedSequence(
            [int(args.seed) % 2 ** 64, int(args.seed) // 2 ** 64, 7])).integers(len(jobs)))
        chosen = jobs[pick]
        for j in jobs:
            if j is not chosen:
                j["res"] = None
        if on_card:
            torch.cuda.empty_cache()
        rows = [[name, None, cfg["limits"][name]] for name in compare.NAMES]
        ok = False
        if chosen["res"] is not None:
            t_ref = time.perf_counter()
            ref_job = reference.Job(cfg, device, dtype)
            ref = ref_job.run(lists[chosen["k"]], seeds[chosen["k"]])
            values = compare.readings(chosen["res"], ref, ref_job.Vrms)
            ok, rows = compare.judge(values, cfg["limits"])
            _say(err, f"portbench: reference of job {pick} (list {chosen['k']}) in "
                      f"{time.perf_counter() - t_ref:.3f} s")

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        _say(err, f"portbench: the process loaded {', '.join(loaded)}; no result")
        return 3
    correct = bool(ok and failed == 0)
    checks = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    _say(err, *(f"check {name}: {value!r} (limit {limit!r})" for name, value, limit in rows))
    result = {"correct": correct, "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(json.dumps(result), file=out, flush=True)
    return 0
