"""The port's birefringence ops and placement plain versions held to the
JAX package on the CPU (Pallas in interpret mode, as
tests/test_placement_pallas.py runs it).

* birefringence, float64: ``_eigensystem_2x2``, ``effective_indices``,
  ``polarization_onsky``, ``path_points_3d`` and ``propagate_pulse`` against
  the JAX functions at rtol 1e-9 (they agree to ~1e-15 here; the path points
  to ~1e-13 m absolute, from the closed-form y(z)); the NuRadioMC anchor of
  tests/test_birefringence.py through the port (atol 2e-2 of the peak, as
  there); float32 propagation never amplifies (power ratio <= 1 + 1e-4,
  >= 1 - 5e-3, as there).
* ``placement_reduce_plain`` (kernel 4's plain version) against
  ``placement_pallas.placement_reduce``, float32, s2 4 and 20: within 5e-4
  of each output row's peak (the port's phase ramp factorizes k = 32a + b,
  the Pallas kernel's k = 128a + b; test_placement_pallas.py:51).
* ``chain_placement_reduce_plain`` against the v2 ``chain_placement_reduce``
  (the function kernel 1 also stands for), float32: within 2e-4 of the
  largest output, the tolerance test_placement_pallas.py gives a different
  phase-table construction.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.models import ice as jice
from nuradiomc_tpu.ops import birefringence as jbire
from nuradiomc_tpu.ops import placement_pallas
from nuradiomc_tpu.ops import raytrace as jrt
from nuradiomc_tpu.sim import pipeline as jpipe
from nuradiomc_tpu_torch.models import ice as tice
from nuradiomc_tpu_torch.ops import birefringence as tbire
from nuradiomc_tpu_torch.ops import placement
from nuradiomc_tpu_torch.ops import raytrace as trt

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "birefringence.npz")

# (source, receiver) pairs: deep long-horizontal paths of the gen2 layout and
# a near-vertical one beside the principal-axis degeneracy
PAIRS = [((2648.7, -409.2, -2583.8), (850.0, 1470.0, -100.0)),
         ((-883.8, 2781.6, -2285.9), (0.0, 0.0, -150.0)),
         ((5.0, 0.0, -2600.0), (0.0, 0.0, -100.0)),
         ((400.0, 300.0, -800.0), (0.0, 0.0, -100.0))]


def _t(x):
    return torch.as_tensor(np.array(x))


def test_eigensystem_and_indices_match_jax():
    rng = np.random.default_rng(11)
    d = rng.normal(size=(200, 3))
    d[:5] = [[0, 0, 1], [0, 0, -1], [1e-14, 0, 1], [1, 0, 0], [0, 1, 0]]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = 1.78 + rng.normal(size=(3, 200)) * 2e-3
    ref = jbire._eigensystem_2x2(jnp.asarray(d), *map(jnp.asarray, n))
    got = tbire._eigensystem_2x2(_t(d), *map(_t, n))
    for name, r, g in zip(("n1", "n2", "cos", "sin", "dn", "k1sq", "k2sq"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-15,
                                   err_msg=name)
    n1, n2 = tbire.effective_indices(_t(d), *map(_t, n))
    assert bool((n1 <= n2).all())
    ref_t, ref_p = jbire.polarization_onsky(jnp.asarray(np.asarray(ref[0])) + 1e-4,
                                            jnp.asarray(d), *map(jnp.asarray, n))
    got_t, got_p = tbire.polarization_onsky(n1 + 1e-4, _t(d), *map(_t, n))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=1e-9, atol=1e-12)


def _paths(n_points, iceflow):
    """All valid ray solutions of PAIRS: the JAX paths one by one, the port's
    batched, and the C0 and geometry they come from."""
    ice = jice.southpole_2015
    ref, c0s, geoms = [], [], []
    for x1, x2 in PAIRS:
        geom = jrt.to_2d(jnp.asarray(x1), jnp.asarray(x2))
        sols = jrt.find_solutions(geom.x1y, geom.x1z, geom.x2y, geom.x2z, ice)
        for slot in np.flatnonzero(np.asarray(sols.mask)):
            ref.append(np.asarray(jbire.path_points_3d(sols.c0[slot], geom, ice, n_points,
                                                       iceflow_angle=iceflow)))
            c0s.append(float(sols.c0[slot]))
            geoms.append([np.asarray(f) for f in geom])
    tgeom = trt.Geometry2D(*[_t([g[i] for g in geoms]) for i in range(8)])
    got = tbire.path_points_3d(_t(c0s), tgeom, tice.southpole_2015, n_points, iceflow)
    return np.stack(ref), got


def test_path_points_and_propagation_match_jax():
    ref_paths, paths = _paths(96, np.deg2rad(-131.0))
    assert len(ref_paths) >= 6
    np.testing.assert_allclose(paths.numpy(), ref_paths, rtol=1e-9, atol=1e-9)
    rng = np.random.default_rng(5)
    ff = np.fft.rfftfreq(512, 0.5)
    P = len(ref_paths)
    st = rng.normal(size=(P, len(ff))) + 1j * rng.normal(size=(P, len(ff)))
    sp = rng.normal(size=(P, len(ff))) + 1j * rng.normal(size=(P, len(ff)))
    ref = jax.vmap(lambda a, b, p: jbire.propagate_pulse(a, b, p, jnp.asarray(ff),
                                                         jice.southpole_2015))(
        jnp.asarray(st), jnp.asarray(sp), jnp.asarray(ref_paths))
    got = tbire.propagate_pulse(_t(st), _t(sp), torch.as_tensor(ref_paths), _t(ff),
                                tice.southpole_2015)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-9, atol=1e-12 * np.abs(r).max())
    # the effect is not trivial: power moved between the polarizations
    assert not np.allclose(got[1].numpy(), sp, atol=1e-3)


def test_pulse_propagation_matches_nuradiomc_anchor():
    golden = np.load(GOLDEN)
    ice = jice.southpole_2015
    ff = _t(np.fft.rfftfreq(int(golden["N"]), 1 / float(golden["fs"])))
    spec_in = golden["input_spec"]
    iceflow = float(golden["angle_to_iceflow"]) * np.pi / 180.0
    for k, (x1x, x1y, x1z, c0_ref, _) in enumerate(golden["info"]):
        x1, x2 = np.array([x1x, x1y, x1z]), np.asarray(golden["receiver"])
        geom = trt.to_2d(_t(x1), _t(x2))
        jgeom = jrt.to_2d(jnp.asarray(x1), jnp.asarray(x2))
        sols = jrt.find_solutions(jgeom.x1y, jgeom.x1z, jgeom.x2y, jgeom.x2z, ice)
        rel = np.abs(np.asarray(sols.c0) / c0_ref - 1)
        slot = int(np.argmin(rel))
        assert rel[slot] < 1e-6
        n_pts = int(np.asarray(sols.path_length)[slot])     # ~1 m steps, as NuRadioMC
        path = tbire.path_points_3d(_t([float(sols.c0[slot])]),
                                    trt.Geometry2D(*[f[None] for f in geom]),
                                    tice.southpole_2015, n_pts, iceflow)
        out_t, out_p = tbire.propagate_pulse(_t(spec_in[1])[None], _t(spec_in[2])[None],
                                             path, ff, tice.southpole_2015)
        ref = golden["specs"][k]
        scale = np.max(np.abs(ref[1:]))
        np.testing.assert_allclose(out_t[0].numpy() / scale, ref[1] / scale, atol=2e-2,
                                   err_msg=f"sol {k} theta")
        np.testing.assert_allclose(out_p[0].numpy() / scale, ref[2] / scale, atol=2e-2,
                                   err_msg=f"sol {k} phi")


def test_propagation_is_unitary_at_float32():
    """The float32 scan never amplifies: per-frequency |eTheta|^2 + |ePhi|^2
    only decreases, by the small physical walk-off damping."""
    rng = np.random.default_rng(7)
    ff = torch.as_tensor(np.fft.rfftfreq(256, 0.5), dtype=torch.float32)
    _, paths = _paths(256, 0.0)
    P = paths.shape[0]
    spec_t = torch.complex(*torch.as_tensor(rng.normal(size=(2, P, len(ff))),
                                            dtype=torch.float32))
    spec_p = torch.complex(*torch.as_tensor(rng.normal(size=(2, P, len(ff))),
                                            dtype=torch.float32))
    out_t, out_p = tbire.propagate_pulse(spec_t, spec_p, paths.float(), ff,
                                         tice.southpole_2015)
    assert out_t.dtype == torch.complex64
    p_in = spec_t.abs() ** 2 + spec_p.abs() ** 2
    p_out = out_t.abs() ** 2 + out_p.abs() ** 2
    assert bool((p_out <= p_in * (1 + 1e-4)).all()), "scan amplified power"
    assert bool((p_out >= p_in * (1 - 5e-3)).all()), "over-damped"


@pytest.mark.parametrize("s2", [4, 20])
def test_placement_reduce_plain_matches_pallas(s2):
    rng = np.random.default_rng(s2)
    G_out, n_int, n_base = 12, 128, 512
    R = G_out * s2
    F_int = n_int // 2 + 1
    D_r, D_i = jpipe._placement_matrices(n_int, n_base)
    v_re = rng.normal(size=(R, F_int)).astype(np.float32)
    v_im = rng.normal(size=(R, F_int)).astype(np.float32)
    v_re[:s2] = v_im[:s2] = 0.0                 # one output row without pulses
    offs = rng.uniform(0, (n_base - n_int) * 0.5, R).astype(np.float32)
    ref_re, ref_im = placement_pallas.placement_reduce(
        jnp.asarray(v_re), jnp.asarray(v_im), jnp.asarray(offs), D_r, D_i, s2=s2,
        df=2.0 / n_base, row_tile=4 * s2)
    F_base = D_r.shape[1]
    ref = np.asarray(ref_re)[:, :F_base] + 1j * np.asarray(ref_im)[:, :F_base]
    out_re, out_im = placement.placement_reduce(
        torch.as_tensor(v_re), torch.as_tensor(v_im), torch.as_tensor(offs),
        s2=s2, df=2.0 / n_base, n_int=n_int, n_base=n_base, K_place=F_base)
    port = out_re.numpy() + 1j * out_im.numpy()
    assert port.shape == (G_out, F_base)
    assert np.all(port[0] == 0)
    peak = np.abs(ref).max(axis=1)
    err = np.abs(port - ref).max(axis=1)
    assert np.all(err[1:] <= 5e-4 * peak[1:]), (err[1:] / peak[1:]).max()


def test_chain_plain_matches_pallas_v2():
    """Kernel 5 (the v2 chain) has kernel 1's contract and is ported onto it."""
    G, C, S = 16, 2, 2
    s2 = S * 2
    R = G * C * s2
    N_INT, N_BASE = 64, 256
    F_INT, F_BASE, N_SPARSE, N_TPL = N_INT // 2 + 1, N_BASE // 2 + 1, 8, C * 3
    rng = np.random.default_rng(7)

    def f32(*sh):
        return rng.standard_normal(sh).astype(np.float32)

    args = dict(
        spec_re=f32(R, F_INT), spec_im=f32(R, F_INT), att_sparse=f32(R, N_SPARSE),
        comb_re=f32(R), comb_im=f32(R), mask=rng.uniform(size=R) > 0.2,
        tpl_idx=rng.integers(0, N_TPL, R).astype(np.int32),
        offsets=rng.uniform(0, 300, R).astype(np.float32), W=f32(N_SPARSE, F_INT),
        templates=(f32(N_TPL, F_INT) + 1j * f32(N_TPL, F_INT)).astype(np.complex64))
    D_r, D_i = (m.astype(np.complex64) for m in jpipe._placement_matrices(N_INT, N_BASE))
    df = 2.0 / N_BASE
    jargs = {k: jnp.asarray(v.astype(np.float32) if k == "mask" else v)
             for k, v in args.items()}
    ref = placement_pallas.chain_placement_reduce(*jargs.values(), jnp.asarray(D_r),
                                                  jnp.asarray(D_i), s2=s2, df=df,
                                                  n_templates=N_TPL, row_tile=4 * s2)
    got = placement.chain_placement_reduce_plain(
        *[torch.as_tensor(v) for v in args.values()], s2=s2, df=df, n_int=N_INT,
        n_base=N_BASE, K_place=F_BASE)
    scale = float(np.abs(np.asarray(ref[0])).max())
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r)[:, :F_BASE], atol=2e-4 * scale,
                                   rtol=0)


def test_placement_reduce_refuses_devices_without_a_kernel():
    meta = torch.zeros((8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        placement.placement_reduce(meta, meta, meta[:, 0], s2=4, df=1e-3, n_int=32,
                                   n_base=128, K_place=65)
