# copied from nuradiomc_tpu/sim/runner.py:1-105 (RunnerState, Runner), with
# the mesh added: the stop decision on rank 0, a failed batch counted on every
# rank, the checkpoint read and written by rank 0; the port keeps its own copy
# and imports nothing of the JAX package
"""Production job runner.

Replaces the reference batch model (utilities/runner.py:9-99
NuRadioMCRunner — N worker processes each running a full simulation until a
trigger-count/time budget is reached; cluster scaling via file splitting,
documentation running_on_a_cluster.rst:8). In the port:

* one process per rank, the ranks on an ``(event, channel)`` mesh
  (``parallel.mesh``), whose ``Simulation(mesh=)`` gathers each batch's
  results to every rank;
* the runner streams input batches through the pipeline until a
  trigger-count or wall-time budget is exhausted, checkpointing the
  accumulated Veff sums so a preempted job resumes where it left off.

On a mesh every rank runs the same loop: rank 0 takes the stop decision
(trigger budget and its own wall clock) and broadcasts it every iteration,
since ranks reading their own clocks could stop at different batches and
leave the others waiting in a collective; a batch that fails on any rank
counts as a crash on every rank; rank 0 alone reads the checkpoint (and
broadcasts it) and writes it. A rank that fails while the others wait in
one of the batch's collectives leaves them there until the process group's
timeout (``parallel.mesh.init_distributed``), when they raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np

from nuradiomc_tpu_torch.parallel import mesh as mesh_util


@dataclasses.dataclass
class RunnerState:
    """Resumable accumulator (the checkpoint payload)."""

    n_events_processed: int = 0
    n_triggered: int = 0
    weight_sum_triggered: float = 0.0
    n_batches: int = 0

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f)

    @classmethod
    def load(cls, path: str):
        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            return cls(**json.load(f))


class Runner:
    """Run simulation batches until a trigger-count or time budget is hit.

    Parameters
    ----------
    make_batch : callable(i_batch, rng) -> (batch_inputs, weights)
        Produces the next event batch (e.g. from evtgen or an input file).
    run_batch : callable(batch_inputs) -> (triggered bool array, aux dict)
        Typically a ``Simulation`` run of the batch.
    n_triggers_max : int
        Stop after this many triggered events (runner.py:17 semantics).
    max_runtime : float
        Wall-time budget in seconds.
    checkpoint_path : str, optional
        Where to persist the resumable state after every batch.
    max_crashes : int
        Tolerated consecutive batch failures (runner.py:17 `max_crashes`).
    mesh : parallel.mesh.Mesh, optional
        Run as one rank of a mesh (see the module docstring); every rank
        makes the same batches from the same seed.
    """

    def __init__(self, make_batch: Callable, run_batch: Callable,
                 n_triggers_max: int = int(1e9),
                 max_runtime: float = 3600.0,
                 checkpoint_path: Optional[str] = None,
                 max_crashes: int = 10,
                 seed: int = 0, mesh=None):
        self.make_batch = make_batch
        self.run_batch = run_batch
        self.n_triggers_max = n_triggers_max
        self.max_runtime = max_runtime
        self.checkpoint_path = checkpoint_path
        self.max_crashes = max_crashes
        self._world = None if mesh is None else mesh.world
        self._rank0 = mesh is None or mesh.rank == 0
        state = (RunnerState.load(checkpoint_path)
                 if checkpoint_path and self._rank0 else RunnerState())
        self.state = mesh_util.broadcast_object(state, self._world)
        self._rng = np.random.default_rng(np.random.Philox(seed))

    def _stop(self, t0) -> bool:
        """Rank 0's decision, on every rank."""
        stop = (self.state.n_triggered >= self.n_triggers_max
                or time.time() - t0 >= self.max_runtime)
        return mesh_util.broadcast_object(stop, self._world)

    def run(self):
        t0 = time.time()
        crashes = 0
        while not self._stop(t0):
            error = None
            try:
                batch, weights = self.make_batch(self.state.n_batches, self._rng)
                if batch is None:
                    break
                triggered, aux = self.run_batch(batch)
                triggered = np.asarray(triggered)
                weights = np.asarray(weights)
            except Exception as e:
                error = e
            failed = error is not None
            if self._world is not None:
                failed = any(mesh_util.gather_objects(failed, self._world))
            if failed:
                crashes += 1
                if crashes > self.max_crashes:
                    raise error or RuntimeError("a batch failed on another rank")
                continue
            self.state.n_events_processed += len(triggered)
            self.state.n_triggered += int(triggered.sum())
            self.state.weight_sum_triggered += float(weights[triggered].sum())
            self.state.n_batches += 1
            crashes = 0
            if self.checkpoint_path and self._rank0:
                self.state.save(self.checkpoint_path)
        return self.state
