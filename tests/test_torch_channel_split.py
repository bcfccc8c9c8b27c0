"""``simulate_batch(channel_axis=)`` on the branches of the chain the mesh
tests' runs do not take, on the CPU: two gloo processes split the channels
(``parallel.dryrun.spawn``), and every field of each rank's output equals the
unsharded call's bit for bit (NaN where NaN), float64:

* the reflective-bottom (Moore's Bay) station: 6 ray slots, 3 readout
  windows, MB1 attenuation;
* a Gen2 station with birefringence and ``keep_efields`` (the non-factored
  chain, kernel 4's plain version);
* the multi-trigger station with noise, focusing, ten triggers and the
  phased array, with ``keep_traces``;
* the 8-channel emitter (pulser) station.

(The factored dipole chain with two triggers, with and without noise, and
the phased-array campaign go through ``Simulation(mesh=)`` in
tests/test_torch_mesh.py and ``chip_smoke.py`` phase 11.)

One tolerance, with its reason: on the CPU, ATen's vectorized loops run the
last elements of a tensor through scalar code, whose complex products can
round differently from the vector code that the same element meets inside
the unsharded tensor. In the birefringence branch the 255-segment loop of
complex products turns that into last-bit differences of the kept efields
at a rank's last path (measured 4.7e-73 against a peak of 9.5e-3, in the
band's top bins); ``efields`` is held within 1e-13 of its peak there, every
other field bit for bit. The card has no such tail: there the sharded runs
equal the unsharded ones bit for bit (``chip_smoke.py`` phase 11).
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mesh_workers as workers  # noqa: E402
from nuradiomc_tpu_torch.parallel import dryrun  # noqa: E402

torch.set_num_threads(1)
CASES = ("mooresbay", "gen2", "multitrigger", "emitter")


@pytest.fixture(scope="module")
def split():
    return dryrun.spawn(workers.pipeline_split, 2, (CASES,), backend="gloo")


@pytest.mark.parametrize("case", CASES)
def test_channel_split_equals_unsharded(split, case):
    for rank, res in enumerate(split):
        differ, fired, C = res[case]
        exact = {k: v for k, v in differ.items() if k != "efields"}
        assert exact == {}, f"rank {rank}: {exact}"
        assert differ.get("efields", 0.0) <= 1e-13, f"rank {rank}: {differ}"
        assert C % 2 == 0 and fired > 0
