"""A run driven without a card, with the timed path broken underneath:
``correct`` comes out false for each fault the cells can have. (They keep no
state across steps and exchange nothing between chips, so those two faults
do not apply.)"""

import json
import time

import pytest
import torch

from portbench import harness
from portbench.run import parse

CELLS = {"dipole_veff.nu_1e18": 300, "deep_pa.nu_1e18_noise": 200,
         "dipole_veff.nutau_1e19_secondaries": 150}


def half_batch(orig):
    """Half of each chunk's groups left out: the step runs on the first
    half; the rest read as never simulated."""
    def step(batch, *args, **kwargs):
        G = batch.energies.shape[0]
        h = G // 2
        out = orig(type(batch)(*[None if a is None else a[:h] for a in batch]), *args, **kwargs)

        def pad(x):
            if not torch.is_tensor(x) or x.dim() == 0 or x.shape[0] != h:
                return x
            return torch.cat([x, torch.zeros((G - h, *x.shape[1:]), dtype=x.dtype,
                                             device=x.device)])
        return type(out)(*[pad(x) for x in out])
    return step


def altered_answer(orig):
    """One answer altered where it is produced: the decision of each chunk's
    loudest group flipped."""
    def step(*args, **kwargs):
        out = orig(*args, **kwargs)
        g = int(torch.argmax(out.max_amplitude.amax(dim=1)))
        trig = out.triggered.clone()
        trig[g] = ~trig[g]
        per = out.triggered_per.clone()
        per[g] = ~per[g]
        return out._replace(triggered=trig, triggered_per=per)
    return step


@pytest.mark.parametrize("fault", [half_batch, altered_answer])
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_fault_is_not_correct(monkeypatch, capsys, workload, fault):
    from nuradiomc_tpu_torch.sim import simulation
    monkeypatch.setattr(simulation, "simulate_batch", fault(simulation.simulate_batch))
    args = parse(["--workload", workload, "--seed", "77", "--seconds", "0.1", "--trace", "0"])
    assert harness.run(args, t_start=time.perf_counter(), device="cpu",
                       events_per_job=CELLS[workload]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["correct"] is False


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(capsys, workload):
    args = parse(["--workload", workload, "--seed", "77", "--seconds", "0.1", "--trace", "0"])
    assert harness.run(args, t_start=time.perf_counter(), device="cpu",
                       events_per_job=CELLS[workload]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["correct"] is True
