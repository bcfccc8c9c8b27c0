"""The port's HCRB2017 model held to the JAX package and to the reference
golden (``tests/golden/hcrb2017.npz``): traces within 1e-12 of the peak of
the JAX package's in float64, and within the 1e-6 of ``tests/test_hcrb2017.py``
of the reference's; the host-side (Nmax, a) are the same numbers."""

import os

import numpy as np
import pytest
import torch

from nuradiomc_tpu.ops import hcrb2017 as jh
from nuradiomc_tpu_torch.ops import hcrb2017 as th

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "hcrb2017.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("em", [False, True])
@pytest.mark.parametrize("lpm", [False, True])
def test_traces(golden, em, lpm):
    N, dt = int(golden["N"]), float(golden["dt"])
    R, n_index, E = float(golden["R"]), float(golden["n_index"]), float(golden["energy"])
    ref = golden["traces"]
    scale = np.max(np.abs(ref))
    thetas = torch.as_tensor(golden["thetas"])
    got = th.get_time_trace(E, thetas, N, dt, em, n_index, torch.full_like(thetas, R),
                            LPM=lpm).numpy()
    assert got.shape == (len(thetas), 3, N)
    for it, theta in enumerate(golden["thetas"]):
        ref_j = np.asarray(jh.get_time_trace(E, theta, N, dt, em, n_index, R, LPM=lpm))
        np.testing.assert_allclose(got[it] / scale, ref_j / scale, atol=1e-12)
        np.testing.assert_allclose(got[it] / scale, ref[int(em), int(lpm), it] / scale,
                                   atol=1e-6)


@pytest.mark.parametrize("E", [1e16, 1e18, 1e19])
@pytest.mark.parametrize("em", [False, True])
def test_shower_width(E, em):
    for lpm in (False, True):
        assert th.get_N_AskDepthA(E, em, lpm) == jh.get_N_AskDepthA(E, em, lpm)


def test_E_omega_with_a_given_width(golden):
    N, dt = int(golden["N"]), float(golden["dt"])
    theta = torch.as_tensor(golden["thetas"][:1])
    got = th.get_time_trace(1e18, theta, N, dt, True, 1.78, torch.tensor([1000.0],
                            dtype=torch.float64), a=1.5).numpy()[0]
    ref = np.asarray(jh.get_time_trace(1e18, float(theta[0]), N, dt, True, 1.78, 1000.0, a=1.5))
    np.testing.assert_allclose(got, ref, atol=1e-12 * np.abs(ref).max())
