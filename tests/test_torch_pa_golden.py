"""The noiseless phased-array golden through the port's ``Simulation`` on
the CPU, float64, with the rules of tests/test_e2e_phased_array.py: the
input (tests/golden/pa_noiseless_input.hdf5) carries the Alvarez2009 k_L
realizations that both frameworks reuse, so the chain is deterministic and
the triggered set is held to NuRadioMC's (e2e_pa_noiseless_reference.npz):
no group beyond it, at most the documented borderline group 1628 missing
(its best beam power lies 1.9% below the threshold), and the same set with
``perf.band_limit_eps = 1e-3``.
"""

import os

import numpy as np
import pytest
import torch

from nuradiomc_tpu.sim import io_hdf5
from nuradiomc_tpu_torch import convert

torch.set_num_threads(1)
HERE = os.path.dirname(__file__)
NOISELESS_INPUT = os.path.join(HERE, "golden", "pa_noiseless_input.hdf5")


@pytest.mark.parametrize("perf", [{}, {"band_limit_eps": 1e-3}], ids=["exact", "band_limited"])
def test_noiseless_pa_golden(perf):
    sim = convert.pa_simulation(NOISELESS_INPUT, {"noise": False, "perf": perf},
                                chunk_size=1024, device="cpu", dtype=torch.float64)
    res = sim.run()
    golden = np.load(os.path.join(HERE, "golden", "e2e_pa_noiseless_reference.npz"))
    ref = set(int(x) for x in np.unique(golden["group_ids"][golden["triggered"]]))
    mine = set(int(g) for g in res["group_ids"][res["triggered"] & (res["weights"] >= 1e-5)])
    assert mine - ref <= set(), sorted(mine - ref)
    assert ref - mine <= {1628}, sorted(ref - mine)
    # the input's k_L realizations are reused and carried to the results
    k_L = io_hdf5.read_input_hdf5(NOISELESS_INPUT).shower_realization_Alvarez2009
    np.testing.assert_array_equal(res["shower_realization_Alvarez2009"], k_L)
