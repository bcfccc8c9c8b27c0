"""The port's job runner and time logger (``sim/runner.py``,
``utils/timing.py``), mirroring tests/test_runner_timing.py, held to the JAX
package's copies, and a two-rank ``Runner`` over the port's mesh
``Simulation`` on the CPU (gloo, ``parallel.dryrun.runner_worker``):

* trigger budget, resume from the checkpoint, crash tolerance, TimeLogger;
* the port's ``Runner`` and ``RunnerState`` give the JAX package's states on
  the same batches;
* on a (2, 1) mesh with noise: both ranks stop at the same batch with equal
  states, the budget met; a run stopped after two batches and resumed from
  its checkpoint ends in the uninterrupted run's state; a rank whose wall
  clock has run out goes on with rank 0's decision; a rank whose batches
  fail makes the caller raise.
"""

import datetime
import os
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from nuradiomc_tpu.sim import runner as jrunner  # noqa: E402
from nuradiomc_tpu.utils import timing as jtiming  # noqa: E402
from nuradiomc_tpu_torch.parallel import dryrun  # noqa: E402
from nuradiomc_tpu_torch.sim.runner import Runner, RunnerState  # noqa: E402
from nuradiomc_tpu_torch.utils.timing import TimeLogger, pretty_time_delta  # noqa: E402

BUDGET = 25


def test_runner_stops_at_trigger_budget(tmp_path):
    ckpt = str(tmp_path / "state.json")

    def make_batch(i, rng):
        return np.arange(100), np.ones(100)

    def run_batch(batch):
        trig = np.zeros(100, dtype=bool)
        trig[:7] = True
        return trig, {}

    r = Runner(make_batch, run_batch, n_triggers_max=20, max_runtime=60,
               checkpoint_path=ckpt)
    state = r.run()
    assert state.n_triggered >= 20
    assert state.n_batches == 3  # 7 per batch -> 21 at batch 3

    # resumability: a new runner picks up the persisted state
    r2 = Runner(make_batch, run_batch, n_triggers_max=20, max_runtime=60,
                checkpoint_path=ckpt)
    assert r2.state.n_triggered == state.n_triggered
    s2 = r2.run()
    assert s2.n_batches == state.n_batches  # budget already met -> no new work


def test_runner_crash_tolerance():
    calls = {"n": 0}

    def make_batch(i, rng):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("flaky")
        if calls["n"] > 4:
            return None, None
        return np.arange(10), np.ones(10)

    def run_batch(batch):
        return np.ones(10, dtype=bool), {}

    r = Runner(make_batch, run_batch, max_crashes=5, max_runtime=60)
    state = r.run()
    assert state.n_batches == 2  # two good batches after two crashes
    calls["n"] = 0
    with pytest.raises(RuntimeError, match="flaky"):
        Runner(make_batch, run_batch, max_crashes=1, max_runtime=60).run()


def test_time_logger():
    tl = TimeLogger(update_interval=0.0)
    with tl.timed("ray tracing"):
        time.sleep(0.01)
    tl.start_time("trigger")
    tl.stop_time("trigger")
    times = tl.get_times()
    assert times["ray tracing"] >= 0.01
    assert "trigger" in times
    assert pretty_time_delta(3725) == "1h2m5s"
    tl.show_time(10, 3)


def test_copies_equal_the_originals(tmp_path):
    for s in (0, 59, 61, 3725, 200000):
        assert pretty_time_delta(s) == jtiming.pretty_time_delta(s)

    def make_batch(i, rng):
        n = int(rng.integers(5, 50))
        if i >= 6:
            return None, None
        return np.arange(n), rng.random(n)

    def run_batch(batch):
        return batch % 3 == 0, {}

    states = []
    for mod in (jrunner, sys.modules[Runner.__module__]):
        ckpt = str(tmp_path / f"{mod.__name__}.json")
        states.append(mod.Runner(make_batch, run_batch, n_triggers_max=40, seed=5,
                                 checkpoint_path=ckpt).run())
        assert mod.RunnerState.load(ckpt) == states[-1]
    assert vars(states[0]) == vars(states[1])
    assert isinstance(states[1], RunnerState)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("runner"))
    return dryrun.spawn(dryrun.runner_worker, 2,
                        (1, "cpu", ckpt, 100, BUDGET, 2), backend="gloo")


def test_two_ranks_stop_on_one_decision(two_ranks):
    for run in ("whole", "clock"):
        a, b = (r[run][0] for r in two_ranks)
        assert a == b, run
        assert a.n_triggered >= BUDGET and a.n_batches >= 3, run
    assert two_ranks[0]["clock"][0] == two_ranks[0]["whole"][0]


def test_two_ranks_resume_to_the_uninterrupted_state(two_ranks):
    for r in two_ranks:
        assert r["first"][0].n_batches == 2
        assert r["first"][0].n_triggered < BUDGET
        assert r["resumed"][0] == r["whole"][0]


def test_a_failing_rank_raises(tmp_path):
    """Rank 1's batch raises before its collectives, so rank 0 waits in the
    batch's gather and rank 1 in the runner's: each raises at the process
    group's timeout instead of hanging, and so does the caller."""
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        dryrun.spawn(dryrun.runner_worker, 2, (1, "cpu", str(tmp_path), 20, BUDGET, 1,
                                                True, 1), backend="gloo",
                     timeout=datetime.timedelta(seconds=10))
    assert time.perf_counter() - t0 < 60


def test_two_ranks_equal_one_process(two_ranks, tmp_path):
    one = dryrun.dryrun_runner(None, "cpu", str(tmp_path), 100, BUDGET, 2)
    for run in ("whole", "first", "resumed", "clock"):
        assert two_ranks[0][run][0] == one[run][0], run
