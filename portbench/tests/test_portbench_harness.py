"""The harness on the CPU: discovery of configurations, mixes and metric
readers by name, a dummy mix added with new files and entries only, the
frozen generator against the port's, the readers on synthetic records, the
trace reduction, and a run's refusal without a card."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness, metrics_common, roofline, tracing
from portbench.run import parse
from portbench.traffic import generator

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent


def bench():
    return harness.benchmark()


def test_every_cell_finds_its_files():
    b = bench()
    for cell in b["workloads"]:
        c, entry = harness.cell_of(b, cell["name"])
        cfg = harness.load_config(entry)
        mix = harness.load_mix(c["traffic"])
        assert {"detector", "config", "filter_chain", "trigger", "chunk_size", "dtype",
                "kernels", "limits"} <= set(cfg)
        assert mix["events_per_job"] > 0 and mix["pool"] > 0
    for m in b["per_layer"]:
        reader = harness.load_reader(m["name"])
        assert callable(reader.read)


def test_cell_metrics_follow_their_workloads():
    b = bench()
    names = {m["name"] for m in harness.cell_metrics(b, "deep_pa.nu_1e18_noise", True)}
    assert "pa_trigger_roofline" in names and "irfft_trigger_roofline" not in names
    assert {m["name"] for m in harness.cell_metrics(b, "dipole_veff.nu_1e18", False)} == {
        "events_per_s", "setup_s"}


def dummy_tree(tmp_path):
    """A copy of BENCHMARK.json and portbench/'s data files with one more mix
    (a new file) and one more cell (a new entry); nothing else edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    mix = harness.load_mix("nu_1e18")
    mix.update(about="a dummy mix: nu_mu CC only, in a 1 km box", events_per_job=60, pool=2,
               generator={**mix["generator"], "flavors": [14, -14], "interaction_type": "cc",
                          "volume_m": {"fiducial_xmin": -500, "fiducial_xmax": 500,
                                       "fiducial_ymin": -500, "fiducial_ymax": 500,
                                       "fiducial_zmin": -1000, "fiducial_zmax": 0}})
    (tmp_path / "portbench" / "traffic" / "dummy.json").write_text(json.dumps(mix))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "dipole_veff.dummy", "config": "dipole_veff",
                           "traffic": "dummy", "chips": 1, "why": "a test's cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp_path


@pytest.mark.parametrize("trace", [0, 1])
def test_dummy_mix_runs_from_new_files_only(tmp_path, capsys, trace):
    root = dummy_tree(tmp_path)
    args = parse(["--workload", "dipole_veff.dummy", "--seed", "3000000000", "--seconds", "0.1",
                  "--trace", str(trace)])
    rc = harness.run(args, t_start=time.perf_counter(), device="cpu", root=root)
    assert rc == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["correct"] and last["attempted"] >= 1 and last["failed"] == 0
    assert list(last)[-1] == "checks"
    want = ({"orchestrator_ms_per_kevent", "weights_ms_per_kevent", "step_ms_per_kevent"}
            if trace else {"events_per_s", "setup_s"})
    assert want <= set(last["metrics"])


@pytest.mark.parametrize("mix", ["nu_1e18", "nu_1e18_noise"])
def test_generator_matches_the_port(mix):
    """The frozen generator draws the port's list: the same digest at a small
    size and a fixed seed."""
    from nuradiomc_tpu_torch.sim import evtgen
    from nuradiomc_tpu_torch.utils import units
    m = harness.load_mix(mix)
    g = m["generator"]
    volume = {k: float(v) * units.m for k, v in g["volume_m"].items()}
    port, port_attrs = evtgen.generate_eventlist_cylinder(
        None, 700, g["energy_eV"], g["energy_eV"], volume, flavor=tuple(g["flavors"]),
        seed=11, cross_sections_model="ctw")
    ours, attrs = generator.generate_eventlist_cylinder(
        700, g["energy_eV"], g["energy_eV"], volume, flavor=tuple(g["flavors"]), seed=11)
    assert generator.list_digest(ours) == evtgen.list_digest(port)
    assert attrs["volume"] == port_attrs["volume"]


def test_job_seeds_take_large_seeds():
    seeds = {generator.job_seed(s, k) for s in (0, 2 ** 31 + 5, 2 ** 40 + 5) for k in range(3)}
    assert len(seeds) == 9 and all(0 <= s < 2 ** 63 for s in seeds)
    assert generator.job_seed(2 ** 40 + 5, 1) == generator.job_seed(2 ** 40 + 5, 1)


def record():
    jobs = [{"wall_s": 2.0, "events": 1000, "spans": {"step": 1.0, "weights": 0.5}},
            {"wall_s": 3.0, "events": 1000, "spans": {"step": 1.5, "weights": 0.5}}]
    problem = {"e": 8, "R": 4096, "K_int": 129, "n_sparse": 37, "K_place": 1025,
               "live": 1000, "s2": 4, "n_int": 256, "n_base": 2048, "W_numel": 37 * 129,
               "tpl_numel": 3 * 129}
    prof = {"launches": 12000, "events": 1000, "busy_s": 0.5, "wall_s": 2.0,
            "kernels": {"void placement_chain_kernel<double>(double const*)": (5, 0.004),
                        "Memcpy HtoD (Pageable -> Device)": (3, 0.001)},
            "ops": {"placement_chain": [problem, problem]}}
    return {"jobs": jobs, "peak_mem_bytes": 3 * 2 ** 30, "profile": prof}, problem


@pytest.mark.parametrize("name, want", [
    ("orchestrator_ms_per_kevent", 1000.0 * 1.5 / 2.0),
    ("weights_ms_per_kevent", 1000.0 * 1.0 / 2.0),
    ("step_ms_per_kevent", 1000.0 * 2.5 / 2.0),
    ("launches_per_kevent", 12000.0),
    ("device_idle_share", 75.0),
    ("peak_mem_gib", 3.0),
])
def test_reader_numbers(name, want):
    rec, _ = record()
    assert harness.load_reader(name).read(rec) == pytest.approx(want)


def test_roofline_reader_counts_the_op_problem():
    rec, problem = record()
    got = harness.load_reader("placement_chain_roofline").read(rec)
    assert got == pytest.approx(100.0 * 2 * roofline.placement_chain_bound(problem)[0] / 0.004)
    # a kernel that did not run reads nothing, never 0
    assert harness.load_reader("pa_trigger_roofline").read(rec) is None
    assert metrics_common.roofline_share({"profile": None}, {"name": "x", "kernel": "y"},
                                         roofline.pa_bound) is None


def test_readers_read_nothing_without_a_trace():
    rec = {"jobs": [{"wall_s": 1.0, "events": 10}], "peak_mem_bytes": 0, "profile": None}
    for name in ("step_ms_per_kevent", "launches_per_kevent", "device_idle_share",
                 "peak_mem_gib", "placement_chain_roofline"):
        assert harness.load_reader(name).read(rec) is None


def test_reduce_trace_unions_and_labels():
    L = tracing.LABEL
    events = [(L + "job", False, 0.0, 100.0), (L + "step", False, 10.0, 60.0),
              (L + "step", True, 10.0, 60.0),               # a range mirrored on the device
              ("k1", True, 12.0, 10.0), ("k2", True, 15.0, 10.0),   # overlap: 12-25
              ("k1", True, 40.0, 5.0), ("Memcpy DtoH", True, 80.0, 5.0)]
    red = tracing.reduce_trace(events)
    assert red["busy_s"] == pytest.approx((13 + 5 + 5) / 1e6)
    assert red["launches"] == 3
    assert red["kernels"]["k1"] == (2, pytest.approx(15 / 1e6))
    gaps = sorted((round(t * 1e6), n) for n, t in red["idle_gaps"])
    # before the first op, inside the step twice, after the last op
    assert gaps == [(12, "orchestrator"), (15, "orchestrator"), (15, "step"), (35, "step")]
    assert red["idle_gaps"][0] == ["step", pytest.approx(35 / 1e6)]


def test_run_without_a_card_prints_no_result(tmp_path):
    """On a machine without a card, and in a directory that holds only
    BENCHMARK.json and portbench/, the run fails and prints no result."""
    for cwd in (ROOT, dummy_tree(tmp_path)):
        proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                               "dipole_veff.nu_1e18", "--seed", "1", "--seconds", "1",
                               "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                              env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""


@pytest.mark.parametrize("per_job, chunk, want", [
    (10000, 2048, 2048 + 1808), (2048, 1024, 1024), (500, 1024, 500), (4096, 2048, 2048)])
def test_warmup_list_holds_a_jobs_chunk_sizes(per_job, chunk, want):
    assert harness.warmup_events(per_job, chunk) == want


def test_run_gives_each_library_pool_one_thread():
    """``run.py`` sets the thread counts before numpy and torch are imported,
    so torch's intra-op pool has one thread."""
    code = ("import sys; sys.path.insert(0, 'portbench'); import run; run.steady_host(); "
            "import torch; print(torch.get_num_threads())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "4"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1"]


@pytest.mark.parametrize("call", ["cross_section", "attenuation"])
def test_reference_refuses_models_it_does_not_hold(call):
    """The frozen reference holds CTW and SP1 only, the models that the
    configurations use; another model raises rather than reading wrong."""
    import torch

    from portbench.reference import attenuation, cross_sections
    with pytest.raises(NotImplementedError):
        if call == "cross_section":
            cross_sections.get_nu_cross_section(1e18, 14, "cc", "hedis_bgr18")
        else:
            attenuation.inv_length_factored(torch.tensor([-100.0]), torch.tensor([0.1]), "GL1")
