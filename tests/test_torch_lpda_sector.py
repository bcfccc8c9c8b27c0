"""The analytic LPDA's phase sector on the edges, port against the JAX
package, on the CPU in float64 (ROADMAP fault F7).

An arrival 45 deg off a downward LPDA's axis (135 deg zenith) sits on the
edge of two phase sectors: which side it takes is decided by the last bit of
the antenna-frame zenith. The port decides it on the device without arccos
(``antenna.lpda_sector``: the rotation and the norm rounded as the JAX
package's CPU products round them, the cosine against the edges' cosines):

* the edges' cosines reproduce the JAX package's ``arccos(c) <= 45 (90) deg``
  on the 400 numbers of each dtype around each edge, exactly;
* the rotation and the norm equal the JAX package's bit for bit on 4096
  random directions and rotations;
* ``simulate_batch`` on ``convert.make_lpda_edge_inputs`` (24 arrivals at
  135 deg zenith on ``reco.examples.MIXED_DETECTOR``'s four LPDAs) decides
  the sector from the receive vector itself and takes the JAX package's
  sector of that direction at every (group, shower, channel, slot); the
  JAX pipeline first takes the vector through angles and back, which moves
  2 of the 96 arrivals across the edge (its sines, cosines and arccos; the
  card's differ from the CPU's in those last bits, ``chip_smoke.py`` phase
  13 (e)). The IFT geometry (``examples.IFT_TRUTH``, angles) takes the JAX
  package's sectors. All against ``lpda_sector_jax_sets.npz``, which the
  card's test and phase 13 (e) read (the card has no jax).

Run as a script (``PYTHONPATH=. python tests/test_torch_lpda_sector.py``),
the file rewrites that npz from the JAX package.
"""

import os
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.ops import antenna as jantenna
from nuradiomc_tpu.utils import geometry as jgeometry
from nuradiomc_tpu.utils import units as junits
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.detector.detector import Detector
from nuradiomc_tpu_torch.ops import antenna
from nuradiomc_tpu_torch.reco import examples
from nuradiomc_tpu_torch.sim import pipeline

JAX_SETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "nuradiomc_tpu_torch", "data", "lpda_sector_jax_sets.npz")


def _rotations():
    det = Detector(examples.MIXED_DETECTOR)
    return np.stack([antenna.antenna_rotation_matrix(*det.get_antenna_orientation(7, c))
                     for c in range(4)])


def jax_sets():
    """The JAX package's sectors: ``ift`` [4] at examples.IFT_TRUTH's angles
    (the reco path's VELs); at the edge arrivals [A, 4] ``edge_direct``,
    its rotation, norm, arccos and sector of the arrival direction itself,
    and ``edge``, those of the direction after its pipeline's round trip
    through angles (cartesian_to_spherical of the receive vectors, then
    spherical_to_cartesian in the vmapped analytic_vel_mix), whose sines,
    cosines and arccos move the last bits."""
    rots = jnp.asarray(_rotations())
    zen, az = examples.IFT_TRUTH["zenith"], examples.IFT_TRUTH["azimuth"]
    ift = np.array([int(jantenna.analytic_vel_mix(zen, az, rots[c], jantenna.KIND_LPDA)[2])
                    for c in range(4)])
    receive = jnp.asarray(convert.lpda_edge_receive_vectors())
    A = receive.shape[0]
    rec = jnp.broadcast_to(receive[:, None, :], (A, 4, 3))
    zen_r, az_r = jgeometry.cartesian_to_spherical(rec)
    rot_b = jnp.broadcast_to(rots[None], (A, 4, 3, 3)).reshape(-1, 3, 3)
    kind = jnp.full((A * 4,), jantenna.KIND_LPDA)
    _, _, edge = jax.vmap(jantenna.analytic_vel_mix)(
        zen_r.reshape(-1), az_r.reshape(-1), rot_b, kind)
    v_ant = jax.vmap(lambda r, x: r @ x)(rot_b, rec.reshape(-1, 3))
    direct = jantenna._lpda_sector(kind, jgeometry.cartesian_to_spherical(v_ant)[0])
    return {"ift": ift, "edge": np.asarray(edge).reshape(A, 4),
            "edge_direct": np.asarray(direct).reshape(A, 4),
            "receive": np.asarray(receive), "rotations": _rotations()}


@pytest.fixture(scope="module")
def sets():
    return jax_sets()


def test_committed_jax_sets_are_current(sets):
    with np.load(JAX_SETS) as z:
        for k, v in sets.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    # the edges are real: both sectors are taken
    assert set(np.unique(sets["edge_direct"])) == {0, 1} and set(sets["ift"]) == {0, 1}
    # the JAX pipeline's round trip through angles moves 2 of the 96 across
    assert int((sets["edge"] != sets["edge_direct"]).sum()) == 2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("edge", [0, 1])
def test_edge_cosines_reproduce_the_jax_arccos(dtype, edge):
    npd = np.float64 if dtype == torch.float64 else np.float32
    c = npd(antenna._SECTOR_COS[dtype][edge])
    angle = (45, 90)[edge] * junits.deg
    steps = np.arange(-200, 200)
    # the 400 numbers of the dtype around the edge (nextafter steps)
    vals = np.array([c] * len(steps), dtype=npd)
    for i, k in enumerate(steps):
        x = c
        for _ in range(abs(int(k))):
            x = np.nextafter(x, npd(np.inf) if k > 0 else npd(-np.inf))
        vals[i] = x
    jax_in = np.asarray(jnp.arccos(jnp.asarray(vals)) <= angle)
    port_in = (torch.as_tensor(vals) >= antenna._SECTOR_COS[dtype][edge]).numpy()
    np.testing.assert_array_equal(port_in, jax_in)
    np.testing.assert_array_equal(port_in, steps >= 0)


def test_rotation_and_norm_round_as_the_jax_package():
    rng = np.random.default_rng(3)
    n = 4096
    rot = rng.normal(size=(n, 3, 3))
    v = rng.normal(size=(n, 3))
    ref = np.asarray(jax.vmap(lambda r, x: r @ x)(jnp.asarray(rot), jnp.asarray(v)))
    ref_norm = np.asarray(jnp.linalg.norm(jnp.asarray(ref), axis=-1))
    got = antenna._rotate(torch.as_tensor(rot), torch.as_tensor(v))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(antenna._norm(got).numpy(), ref_norm)


def _round_exact(x, npd):
    """The number of dtype ``npd`` nearest the rational ``x`` (ties to even)."""
    guess = npd(float(x))
    cands = [np.nextafter(guess, npd(-np.inf)), guess, np.nextafter(guess, npd(np.inf))]
    dist = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(dist)
    ties = [c for c, d in zip(cands, dist) if d == best]
    if len(ties) == 1:
        return ties[0]
    bits = np.uint64 if npd == np.float64 else np.uint32
    return [c for c in ties if int(np.array([c]).view(bits)[0]) % 2 == 0][0]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fma_emulation_rounds_once(dtype):
    """a b + c with one rounding on 3000 random triples, a third of them
    built so that a b + c nearly cancels or lands near a tie."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    rng = np.random.default_rng(11)
    n = 3000
    a = rng.normal(size=n).astype(npd) * npd(2.0) ** rng.integers(-20, 20, n).astype(npd)
    b = rng.normal(size=n).astype(npd)
    c = rng.normal(size=n).astype(npd) * npd(2.0) ** rng.integers(-20, 20, n).astype(npd)
    k = n // 3
    c[:k] = -(a[:k] * b[:k])                       # cancellation: the low part alone
    c[k:2 * k] = (a[k:2 * k] * b[k:2 * k]) * npd(1 + 2.0 ** -12)
    got = antenna._fma(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    want = np.array([_round_exact(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)),
                                  npd) for x, y, z in zip(a, b, c)], dtype=npd)
    np.testing.assert_array_equal(got, want)


def _recorded_sectors(where, monkeypatch):
    s, ch, b, vectors = convert.make_lpda_edge_inputs(device=where)
    from nuradiomc_tpu_torch.ops import raytrace
    mix = antenna.analytic_vel_mix
    seen = []

    def recording(*args, **kw):
        out = mix(*args, **kw)
        seen.append(out[2])
        return out

    monkeypatch.setattr(raytrace, "launch_receive_vectors", vectors)
    monkeypatch.setattr(antenna, "analytic_vel_mix", recording)
    pipeline.simulate_batch(b, ch, s)
    assert len(seen) == 1
    return seen[0].cpu()


def test_simulate_batch_takes_the_jax_sectors_on_the_edges(sets, monkeypatch):
    """The sector of each arrival direction, as the JAX package's functions
    decide it for that direction (``edge_direct``)."""
    got = _recorded_sectors("cpu", monkeypatch)                     # [G, S, C, 2]
    want = torch.as_tensor(sets["edge_direct"])[:, None, :, None].expand(got.shape)
    assert torch.equal(got, want)


def test_ift_geometry_takes_the_jax_sectors(sets):
    """Given as angles (the reconstruction modules' VELs), on the device and
    through ``lpda_sector_host``."""
    zen = torch.tensor(examples.IFT_TRUTH["zenith"], dtype=torch.float64)
    az = torch.tensor(examples.IFT_TRUTH["azimuth"], dtype=torch.float64)
    got = [int(antenna.analytic_vel_mix(zen, az, torch.as_tensor(r),
                                        torch.tensor(antenna.KIND_LPDA))[2])
           for r in sets["rotations"]]
    host = [int(antenna.lpda_sector_host(zen, az, r, antenna.KIND_LPDA))
            for r in sets["rotations"]]
    assert got == host == list(sets["ift"])


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (the JAX package on the CPU)
    np.savez(JAX_SETS, **jax_sets())
    print("wrote", JAX_SETS)
