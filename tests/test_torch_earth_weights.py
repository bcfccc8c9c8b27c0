"""The Earth-absorption weights' routing by the run's device, on the CPU.

* ``get_weight(..., device="cpu")`` is the default call bit for bit in every
  mode, launches nothing and counts no ``weights.kernel_chords``;
* ``Simulation._weights`` passes the run's device to ``get_weight``;
* the chord kernel's arithmetic (``csrc/earth_slant.cu``), written out in
  numpy on the inputs ``ops.earth_slant.chords`` hands it, gives
  ``EarthModel.slant_depth``'s bits: the same points, radii, shells,
  densities and trapezoid terms;
* ``ops.earth_slant.slant_depth`` refuses a device off the card;
* both Earth models fit the kernel's shell table.

The kernel itself runs only on the card: ``tests/test_torch_gpu.py`` holds it
to the numpy copy there.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.ops import earth_slant
from nuradiomc_tpu_torch.sim import earth_attenuation, io_input
from nuradiomc_tpu_torch.utils import timing, units

MODES = ["simple", "core_mantle_crust_simple", "core_mantle_crust", "PREM", "None"]


def _events(n=48, seed=26):
    """(theta, energy, flavor, vertex, phi) drawn like the deep phased-array
    list: vertices at r < 3 km and -2 km < z < 0, isotropic directions."""
    rng = np.random.default_rng(seed)
    r = 3e3 * np.sqrt(rng.uniform(0, 1, n))
    az = rng.uniform(0, 2 * np.pi, n)
    vertex = np.c_[r * np.cos(az), r * np.sin(az), rng.uniform(-2e3, 0, n)]
    theta = np.arccos(rng.uniform(-1, 1, n))
    energy = 10 ** rng.uniform(16, 20, n) * units.eV
    flavors = rng.choice([12, -12, 14, -14, 16, -16], n)
    return theta, energy, flavors, vertex, rng.uniform(0, 2 * np.pi, n)


@pytest.mark.parametrize("mode", MODES)
def test_get_weight_on_the_cpu_is_the_default_call(mode):
    theta, energy, flavors, vertex, phi = _events()
    kw = dict(mode=mode, cross_section_type="ctw", vertex_position=vertex, phi_nu=phi)
    want = earth_attenuation.get_weight(theta, energy, flavors, **kw)
    before = earth_slant.launches
    timing.enable(False)
    timing.take()
    timing.enable()
    try:
        got = earth_attenuation.get_weight(theta, energy, flavors, device="cpu", **kw)
        counters = timing.take()["counters"]
    finally:
        timing.enable(False)
        timing.take()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert earth_slant.launches == before
    assert not any(name == "weights.kernel_chords" or name.startswith("host_syncs.")
                   for c in counters.values() for name in c)


def test_simulation_passes_its_device_to_get_weight(monkeypatch):
    seen = []
    real = earth_attenuation.get_weight

    def spy(*args, **kwargs):
        seen.append(kwargs.get("device"))
        return real(*args, **kwargs)

    full = io_input.read_input(str(io_input.INPUT_1E18_N3000))
    sim = convert.pa_simulation(io_input.select(full, np.unique(full.event_group_ids)[:8]),
                                {"weights": {"weight_mode": "core_mantle_crust"}},
                                chunk_size=8, device="cpu", dtype=torch.float64)
    monkeypatch.setattr(earth_attenuation, "get_weight", spy)
    group_ids, start, count, order, _ = sim._build_batches()
    weights = sim._weights(group_ids, start, count, order)
    assert seen == [sim.device] and sim.device == torch.device("cpu")
    assert weights.shape == (len(group_ids),) and np.all((weights > 0) & (weights <= 1))


def _kernel_arithmetic(earth, ends, d, dist, n_samples):
    """``csrc/earth_slant.cu``'s arithmetic in numpy: each sample's point
    endpoint + ((t dist) d), radius sqrt((x x + y y) + z z), shell as the
    count of radii <= r, Horner density in r / earth_radius (0 outside), the
    trapezoid terms ((t1 - t0) (rho1 + rho0)) / 2; summed as np.trapz sums
    them, times dist."""
    ts = np.linspace(0.0, 1.0, n_samples)
    tl = ts[None, :] * dist[:, None]
    p = [ends[:, None, k] + tl * d[:, None, k] for k in range(3)]
    r = np.sqrt((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2])
    shell = (earth.radii[None, None, :] <= r[..., None]).sum(-1)
    c = earth.coeffs[np.minimum(shell, len(earth.radii) - 1)]
    x = r / earth.earth_radius
    rho = np.where(shell < len(earth.radii),
                   c[..., 0] + x * (c[..., 1] + x * (c[..., 2] + x * c[..., 3])), 0.0)
    terms = ((ts[1:] - ts[:-1]) * (rho[:, 1:] + rho[:, :-1])) / 2.0
    return np.add.reduce(terms, axis=-1) * dist


@pytest.mark.parametrize("model", ["CORE_MANTLE_CRUST", "PREM"])
def test_kernel_arithmetic_on_its_inputs_gives_the_numpy_integral(model):
    earth = getattr(earth_attenuation, model)
    theta, _, _, vertex, phi = _events(32)
    # and a vertex on the surface whose chord has length 0
    vertex = np.r_[vertex, [[0.0, 0.0, 0.0]]]
    theta, phi = np.r_[theta, 0.2], np.r_[phi, 1.0]
    d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1)
    want = earth.slant_depth(vertex, d, n_samples=16384)
    ends, unit, dist = earth_slant.chords(earth, vertex, d)
    assert dist[-1] == 0.0 and want[-1] == 0.0 and np.all(want[:-1] > 0)
    got = _kernel_arithmetic(earth, ends, unit, dist, 16384)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("device", [None, "cpu"])
def test_earth_slant_refuses_a_device_off_the_card(device):
    with pytest.raises(ValueError, match="not a CUDA device"):
        earth_slant.slant_depth(earth_attenuation.PREM, [[0.0, 0.0, -1.0]], [[0.0, 0.0, 1.0]],
                                device=device)


@pytest.mark.parametrize("model", ["CORE_MANTLE_CRUST", "PREM"])
def test_earth_models_fit_the_kernels_shell_table(model):
    source = Path(earth_slant.__file__).resolve().parents[1] / "csrc" / "earth_slant.cu"
    max_shells = int(re.search(r"#define ES_MAX_SHELLS (\d+)", source.read_text()).group(1))
    earth = getattr(earth_attenuation, model)
    assert 1 <= len(earth.radii) <= max_shells and earth.coeffs.shape == (len(earth.radii), 4)
    assert np.all(np.diff(earth.radii) > 0) and earth.radii[-1] == earth.earth_radius
