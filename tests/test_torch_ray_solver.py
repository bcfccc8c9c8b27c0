"""The ray solver's wrapper on the CPU. Its kernel (``csrc/ray_solver.cu``)
runs only on a card, where ``tests/test_torch_gpu.py`` holds it to the plain
version; here:

* on CPU tensors ``find_solutions`` is ``find_solutions_plain``, bit for bit;
* without a card nothing is launched and nothing counted as kernel pairs;
* the kernel gets as many scalars as its enum names, each rounded to the
  dtype as the plain version's ops round it;
* the bracketed solve evaluates f ``n_bisect`` times, whatever its split;
* tensors on a device that is neither the CPU nor CUDA are refused.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nuradiomc_tpu_torch.models import ice as ice_models
from nuradiomc_tpu_torch.ops import raytrace
from nuradiomc_tpu_torch.utils import timing

ICE = ice_models.southpole_2015
SOURCE = Path(raytrace.__file__).resolve().parents[1] / "csrc" / "ray_solver.cu"


def _pairs(dtype, n=256, seed=3):
    rng = np.random.default_rng(seed)
    r, phi = 4000.0 * np.sqrt(rng.uniform(0, 1, n)), rng.uniform(0, 2 * np.pi, n)
    x1 = np.stack([r * np.cos(phi), r * np.sin(phi), rng.uniform(-2700.0, 0.0, n)], -1)
    x2 = np.stack([np.zeros(n), np.zeros(n), np.full(n, -100.0)], -1)
    g = raytrace.to_2d(torch.as_tensor(x1, dtype=dtype), torch.as_tensor(x2, dtype=dtype))
    return g.x1y, g.x1z, g.x2y, g.x2z


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_bisect", [28, 96])
def test_cpu_tensors_take_the_plain_version(dtype, n_bisect):
    xs = _pairs(dtype)
    got = raytrace.find_solutions(*xs, ICE, n_bisect)
    want = raytrace.find_solutions_plain(*xs, ICE, n_bisect)
    assert bool(want.mask.any())
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a.nan_to_num(), b.nan_to_num()), name


def test_no_launch_and_no_kernel_pairs_on_the_cpu():
    before = raytrace.launches
    timing.enable()
    timing.take()
    timing.new_job()
    try:
        sols = raytrace.find_solutions(*_pairs(torch.float64, 16), ICE)
        sols_all = raytrace.find_solutions_all(*_pairs(torch.float64, 16), ICE)
        timing.count("marker")
        rec = timing.take()
    finally:
        timing.enable(False)
        timing.take()
    assert sols.c0.shape == sols_all.c0.shape == (16, 2)
    assert raytrace.launches == before
    assert [set(c) for c in rec["counters"].values()] == [{"marker"}]


def test_kernel_scalars():
    enum = re.search(r"enum \{([^}]*)\}", SOURCE.read_text()).group(1)
    names = [w.strip() for w in enum.split(",")]
    assert names[-1] == "RS_NSCALARS"
    for f64, dt in ((False, np.float32), (True, np.float64)):
        s = list(raytrace._solver_scalars(ICE, f64))
        assert len(s) == len(names) - 1
        assert all(float(dt(v)) == v for v in s)
        at = dict(zip(names, s))
        assert at["S_N"] == float(dt(ICE.n_ice)) and at["S_NN"] == float(dt(ICE.n_ice ** 2))
        # x / z_0 is x * (1 / z_0), the reciprocal rounded in the dtype
        assert at["S_INV_Z0"] == float(dt(1) / dt(ICE.z_0))
        assert at["S_EPS"] == float(dt(1e-12 if f64 else 1e-5))
    # gamma at the surface: the turning point of a ray that turns above it
    gamma, z = raytrace._turning_point(torch.tensor([2.0], dtype=torch.float64), ICE)
    assert float(z) == 0.0 and float(gamma) == list(raytrace._solver_scalars(ICE, True))[
        names.index("S_G_SURF")]


@pytest.mark.parametrize("n_bisect", [0, 1, 3, 4, 7, 16, 28, 96])
def test_bisect_split_is_the_plain_solvers(n_bisect):
    """``_bisect_split``, which the kernel takes, spends ``n_bisect``
    evaluations of f in ``_bracketed_solve``."""
    calls = []

    def f(x):
        calls.append(x)
        return x - 0.3

    lo, hi = torch.zeros(1, dtype=torch.float64), torch.ones(1, dtype=torch.float64)
    raytrace._bracketed_solve(f, lo, hi, f(lo), n_bisect)
    assert len(calls) - 1 == n_bisect


def test_other_devices_are_refused():
    xs = [x.to("meta") for x in _pairs(torch.float64, 4)]
    with pytest.raises(ValueError, match="unsupported device"):
        raytrace.find_solutions(*xs, ICE)
    with pytest.raises(ValueError, match="several devices"):
        raytrace.find_solutions(*_pairs(torch.float64, 4)[:3], xs[3], ICE)
