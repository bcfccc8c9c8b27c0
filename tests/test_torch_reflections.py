"""The port's reflective-bottom (Moore's Bay) path held to the JAX package.

Ray tracer: 256 random (source, receiver) pairs in ``mooresbay_simple`` from
a numpy seed go through the JAX ``find_solutions_all`` (vmapped, one jitted
function per reflection count) and the port's batched one, in float64 with
96 solver steps. The slot fields (mask, sol_type, reflection, refl_case) must
be equal. Observables: slots whose final leg is direct agree to rtol 1e-9
with the exceptions below; slots that turn get the turning-point tolerances
of ``tests/test_torch_raytrace.py`` (measured here: C0 3e-9, travel time and
path length 3e-7 relative), because the closed forms take a square root of a
quantity that vanishes at the turning point. Bounce slots sum
antiderivatives with integer weights up to 2r + 2, each with its own
turning-point term, so they all take the turning tolerances. The port must
also find every solution of NuRadioMC's own Moore's Bay anchors
(``reference_C0_MooresBay.pkl`` at rtol 1e-6, ``raytrace_mb.npz``).

Pipeline: ``simulate_batch`` with ``n_reflections`` 1 and 2, with and without
focusing, on 24 groups of a 4-channel shallow station; decisions and
trigger times equal to the JAX package's in float64, and the kernel-1 and
kernel-2 operands of the ``"plain"`` route equal to what the kernel wrappers
receive.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_reflections.py``
writes ``nuradiomc_tpu_torch/data/mooresbay_jax_sets.npz``: the JAX
package's float64 triggered set on the first 2048 groups of
``convert.make_mooresbay_inputs`` (the pin of ``chip_smoke.py`` phase 8).
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuradiomc_tpu.models import ice as jice
from nuradiomc_tpu.ops import raytrace as jrt
from nuradiomc_tpu_torch.models import ice as tice
from nuradiomc_tpu_torch.ops import raytrace as trt

torch.set_num_threads(1)
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
N = 256
_SLOT_FIELDS = ("mask", "sol_type", "reflection", "refl_case")


def _pairs():
    rng = np.random.default_rng(23)
    r = rng.uniform(20.0, 1500.0, N)
    phi = rng.uniform(0, 2 * np.pi, N)
    x1 = np.stack([r * np.cos(phi), r * np.sin(phi), rng.uniform(-570.0, -2.0, N)], -1)
    x2 = np.stack([np.zeros(N), np.zeros(N), rng.uniform(-100.0, -1.0, N)], -1)
    return x1, x2


@pytest.fixture(scope="module", params=[1, 2])
def solved(request):
    n_refl = request.param
    x1, x2 = _pairs()
    geom_j = jrt.to_2d(jnp.asarray(x1), jnp.asarray(x2))
    geom_t = trt.to_2d(torch.as_tensor(x1), torch.as_tensor(x2))
    sols_j = jax.jit(jax.vmap(lambda a, b, c, d: jrt.find_solutions_all(
        a, b, c, d, jice.mooresbay_simple, n_reflections=n_refl)))(
        geom_j.x1y, geom_j.x1z, geom_j.x2y, geom_j.x2z)
    sols_t = trt.find_solutions_all(geom_t.x1y, geom_t.x1z, geom_t.x2y, geom_t.x2z,
                                    tice.mooresbay_simple, n_reflections=n_refl)
    return n_refl, geom_j, geom_t, sols_j, sols_t


def test_slot_fields_equal(solved):
    n_refl, _, _, sols_j, sols_t = solved
    assert sols_t.c0.shape == (N, 2 + 4 * n_refl)
    for name in _SLOT_FIELDS:
        np.testing.assert_array_equal(getattr(sols_t, name).numpy(),
                                      np.asarray(getattr(sols_j, name)), err_msg=name)
    mask = np.asarray(sols_j.mask)
    # every family of slots holds real solutions in this sample
    for k in range(0, mask.shape[1], 2):
        assert mask[:, k:k + 2].sum() > N // 4, k


def test_observables(solved):
    _, geom_j, geom_t, sols_j, sols_t = solved
    mask = np.asarray(sols_j.mask)
    base_direct = mask & (np.asarray(sols_j.sol_type) == jrt.SOL_DIRECT) \
        & (np.asarray(sols_j.reflection) == 0)
    rest = mask & ~base_direct
    assert base_direct.sum() > 50 and rest.sum() > 500
    for name, rtol in (("c0", 1e-8), ("c1", 1e-6), ("launch_angle", 1e-8),
                       ("receive_angle", 1e-6), ("path_length", 1e-6),
                       ("travel_time", 1e-6)):
        port = getattr(sols_t, name).numpy()
        ref = np.asarray(getattr(sols_j, name))
        np.testing.assert_allclose(port[base_direct], ref[base_direct], rtol=1e-9,
                                   err_msg=name)
        np.testing.assert_allclose(port[rest], ref[rest], rtol=rtol, err_msg=name)
    lt, rt = trt.launch_receive_vectors(geom_t, sols_t)
    lj, rj = jrt.launch_receive_vectors(geom_j, sols_j)
    np.testing.assert_allclose(lt.numpy()[mask], np.asarray(lj)[mask], atol=1e-7)
    np.testing.assert_allclose(rt.numpy()[mask], np.asarray(rj)[mask], atol=1e-7)


def test_surface_touches_and_general_functions(solved):
    """The per-(r, case, mirror) functions on the JAX roots, as functions."""
    n_refl, geom_j, geom_t, sols_j, _ = solved
    c0 = np.asarray(sols_j.c0)[:, 0]
    ok = np.asarray(sols_j.mask)[:, 0]
    ice_j, ice_t = jice.mooresbay_simple, tice.mooresbay_simple
    c0_t = torch.as_tensor(c0)
    for r in range(n_refl + 1):
        for case in (1, 2):
            for mirror in (False, True):
                assert trt._path_coeffs(r, case, mirror) == jrt._path_coeffs(r, case, mirror)
                for fn in ("path_length_general", "travel_time_general"):
                    ref = np.asarray(getattr(jrt, fn)(jnp.asarray(c0), geom_j.x1z, geom_j.x2z,
                                                      ice_j, r, case, mirror))
                    port = getattr(trt, fn)(c0_t, geom_t.x1z, geom_t.x2z, ice_t, r, case,
                                            mirror).numpy()
                    np.testing.assert_allclose(port[ok], ref[ok], rtol=1e-9, atol=1e-9)
                zt = np.asarray(jrt.turning_depth(jnp.asarray(c0), ice_j))
                np.testing.assert_array_equal(
                    trt.surface_touches(r, case, mirror, torch.as_tensor(zt)).numpy(),
                    np.asarray(jrt.surface_touches(r, case, mirror, jnp.asarray(zt))))
            np.testing.assert_allclose(
                trt.launch_angle_general(c0_t, geom_t.x1z, ice_t, case).numpy()[ok],
                np.asarray(jrt.launch_angle_general(jnp.asarray(c0), geom_j.x1z, ice_j,
                                                    case))[ok], rtol=1e-12)
    for mirror in (False, True):
        np.testing.assert_allclose(
            trt.receive_angle_general(c0_t, geom_t.x2z, ice_t, mirror).numpy()[ok],
            np.asarray(jrt.receive_angle_general(jnp.asarray(c0), geom_j.x2z, ice_j,
                                                 mirror))[ok], rtol=1e-12)


@pytest.mark.parametrize("model", ["SP1", "MB1"])
def test_attenuation_factor_slots(solved, model):
    """Per-slot attenuation on the JAX roots and slot fields, rtol 1e-9."""
    _, geom_j, geom_t, sols_j, _ = solved
    freqs = np.append(np.linspace(0.0039, 0.5, 16), np.linspace(0.504, 1.0, 8))
    R = sols_j.c0.shape[1]
    ref = jax.jit(jax.vmap(lambda c, st, rr, cc, a, b: jrt.attenuation_factor_slots(
        c, st, rr, cc, a, b, jice.mooresbay_simple, jnp.asarray(freqs), model,
        n_steps=8, quadrature="gauss")))(
        sols_j.c0.reshape(-1), sols_j.sol_type.reshape(-1), sols_j.reflection.reshape(-1),
        sols_j.refl_case.reshape(-1), jnp.repeat(geom_j.x1z, R), jnp.repeat(geom_j.x2z, R))
    port = trt.attenuation_factor_slots(
        torch.as_tensor(np.asarray(sols_j.c0)), torch.as_tensor(np.asarray(sols_j.sol_type)),
        torch.as_tensor(np.asarray(sols_j.reflection)),
        torch.as_tensor(np.asarray(sols_j.refl_case)),
        geom_t.x1z[:, None], geom_t.x2z[:, None], tice.mooresbay_simple,
        torch.as_tensor(freqs), model, n_steps=8, quadrature="gauss")
    mask = np.asarray(sols_j.mask)
    ref = np.asarray(ref).reshape(N, R, -1)
    assert np.all(np.isfinite(port.numpy()[mask]))
    np.testing.assert_allclose(port.numpy()[mask], ref[mask], rtol=1e-9)


def test_attenuation_factor_general():
    """The static-coefficient form on one bounce family (r 1, case 2, mirror)."""
    x1, x2 = _pairs()
    geom_j = jrt.to_2d(jnp.asarray(x1), jnp.asarray(x2))
    geom_t = trt.to_2d(torch.as_tensor(x1), torch.as_tensor(x2))
    freqs = np.linspace(0.05, 0.8, 6)
    c0 = np.full(N, 0.9)
    ref = jax.vmap(lambda c, a, b: jrt.attenuation_factor_general(
        c, a, b, jice.mooresbay_simple, jnp.asarray(freqs), "MB1", 1, 2, True, n_steps=8,
        quadrature="gauss"))(jnp.asarray(c0), geom_j.x1z, geom_j.x2z)
    port = trt.attenuation_factor_general(
        torch.as_tensor(c0), geom_t.x1z, geom_t.x2z, tice.mooresbay_simple,
        torch.as_tensor(freqs), "MB1", 1, 2, True, n_steps=8, quadrature="gauss")
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-9)


def test_requires_reflective_bottom():
    z = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="reflective bottom"):
        trt.find_solutions_all(z, z - 100.0, z + 50.0, z - 5.0, tice.southpole_2015,
                               n_reflections=1)
    # without reflections it is find_solutions
    a = trt.find_solutions_all(z, z - 100.0, z + 50.0, z - 5.0, tice.southpole_2015)
    b = trt.find_solutions(z, z - 100.0, z + 50.0, z - 5.0, tice.southpole_2015)
    np.testing.assert_array_equal(a.c0.numpy(), b.c0.numpy())


def _seeded_geometry(n_events, zmin, zmax):
    """The seeded geometry of NuRadioMC's T05/T06 unit tests (np.random.seed(10))."""
    np.random.seed(10)
    rr = np.random.triangular(50.0, 3000.0, 3000.0, n_events)
    phiphi = np.random.uniform(0, 2 * np.pi, n_events)
    zz = np.random.uniform(zmin, zmax, n_events)
    return np.array([rr * np.cos(phiphi), rr * np.sin(phiphi), zz]).T


def test_c0_mooresbay_anchor():
    """Every solution of NuRadioMC's Moore's Bay regression set (2 reflections,
    10 slots) is found at a matching C0, rtol 1e-6, matched by value as
    ``tests/test_reference_anchors.py`` does."""
    with open(os.path.join(GOLDEN_DIR, "reference_C0_MooresBay.pkl"), "rb") as f:
        ref = pickle.load(f, encoding="latin1")           # (1000, 10), 0 = none
    points = _seeded_geometry(1000, 0.0, -500.0)
    x1 = torch.as_tensor(points)
    x2 = torch.as_tensor(np.array([0.0, 0.0, -5.0])).expand(x1.shape)
    geom = trt.to_2d(x1, x2)
    sols = trt.find_solutions_all(geom.x1y, geom.x1z, geom.x2y, geom.x2z,
                                  tice.mooresbay_simple, n_reflections=2)
    c0, mask = sols.c0.numpy(), sols.mask.numpy()
    missed = n_ref = 0
    for i in range(len(points)):
        mine = c0[i][mask[i]]
        for rv in ref[i][ref[i] > 0]:
            n_ref += 1
            if not (len(mine) and np.min(np.abs(mine / rv - 1)) < 1e-6):
                missed += 1
    assert n_ref > 2000
    assert missed == 0, f"missed {missed} of {n_ref} reference solutions"


def test_raytrace_mb_golden():
    """NuRadioMC's own tracer on 200 Moore's Bay points, one reflection
    (``tests/golden/raytrace_mb.npz``): every reference solution is found in
    its (reflection, case) family at rtol 1e-6 in C0, with travel time and
    path length at 1e-6 and the launch vector at 1e-6 absolute."""
    g = np.load(os.path.join(GOLDEN_DIR, "raytrace_mb.npz"))
    x1 = torch.as_tensor(g["points"])
    x2 = torch.as_tensor(g["receiver"]).expand(x1.shape)
    geom = trt.to_2d(x1, x2)
    sols = trt.find_solutions_all(geom.x1y, geom.x1z, geom.x2y, geom.x2z,
                                  tice.mooresbay_simple, n_reflections=1)
    launch, _ = trt.launch_receive_vectors(geom, sols)
    c0, mask = sols.c0.numpy(), sols.mask.numpy()
    refl, case = sols.reflection.numpy(), sols.refl_case.numpy()
    n_ref = 0
    for i in range(len(g["points"])):
        for j in np.where(~np.isnan(g["C0"][i]))[0]:
            r = g["reflection"][i, j]
            sel = mask[i] & (refl[i] == r)
            if r > 0:
                sel &= case[i] == g["refl_case"][i, j]
            cands = np.where(sel)[0]
            rel = np.abs(c0[i][cands] / g["C0"][i, j] - 1)
            assert len(rel) and rel.min() < 1e-6, (i, j)
            k = cands[np.argmin(rel)]
            n_ref += 1
            if r > 0:
                np.testing.assert_allclose(sols.travel_time.numpy()[i, k],
                                           g["travel_time"][i, j], rtol=1e-6)
                np.testing.assert_allclose(sols.path_length.numpy()[i, k],
                                           g["path_length"][i, j], rtol=1e-6)
                np.testing.assert_allclose(launch.numpy()[i, k], g["launch"][i, j], atol=1e-6)
    assert n_ref > 300


# ---- simulate_batch with bottom reflections ---------------------------------

import dataclasses

from nuradiomc_tpu.sim import pipeline as jpipe
from nuradiomc_tpu.sim.simulation import (FilterStage as JFilterStage,
                                          Simulation as JSimulation,
                                          TriggerSpec as JTriggerSpec)
from nuradiomc_tpu_torch import convert
from nuradiomc_tpu_torch.ops import placement, trigger_fused
from nuradiomc_tpu_torch.sim import io_input
from nuradiomc_tpu_torch.sim import pipeline as tpipe

ANY_INPUT = os.path.join(os.path.dirname(GOLDEN_DIR), "data", "1e18_n3000.hdf5")
PIN = io_input.DATA_DIR / "mooresbay_jax_sets.npz"
PIN_GROUPS = 2048


def _jax_twin(port_sim):
    """The JAX package's ``Simulation`` with the port's detector, config,
    filters and trigger: its settings and channel parameters do not depend
    on the input file, so any event list serves the constructor."""
    return JSimulation(
        ANY_INPUT, convert.MOORESBAY_DETECTOR, config=port_sim.config,
        filter_chain=[JFilterStage(f.passband, f.filter_type, f.kwargs)
                      for f in port_sim.filter_chain],
        trigger=JTriggerSpec(**dataclasses.asdict(port_sim.trigger)))


def _jax_batch(batch_np, sel=slice(None)):
    return jpipe.ShowerBatch(**{k: None if v is None else np.asarray(v)[sel]
                                for k, v in batch_np._asdict().items()})


@pytest.fixture(scope="module")
def mb_inputs():
    """24 groups of the Moore's Bay workload: those of the first 256 that the
    port triggers (with one reflection) and the first others."""
    port = convert.mooresbay_simulation(convert.mooresbay_event_input(256, 0),
                                        {"propagation": {"n_bisect": 96}},
                                        device="cpu", dtype=torch.float64)
    batch_np = port._build_batches()[-1]
    out = tpipe.simulate_batch(
        tpipe.ShowerBatch(*[None if a is None else torch.as_tensor(a) for a in batch_np]),
        port.channel_params, port.settings)
    trig = np.flatnonzero(out.triggered.numpy())
    others = np.setdiff1d(np.arange(256), trig)[:24 - len(trig)]
    sel = np.sort(np.concatenate([trig, others]))
    jsim = _jax_twin(port)
    return jsim.settings, jsim.channel_params, _jax_batch(batch_np, sel)


def _assert_outputs_equal(ref, port):
    for name in ("sol_type", "reflection", "refl_case", "sol_mask"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(port.triggered.numpy(), np.asarray(ref.triggered))
    np.testing.assert_array_equal(port.triggered_per.numpy(), np.asarray(ref.triggered_per))
    trig = np.asarray(ref.triggered)
    assert 0 < trig.sum() < len(trig)
    np.testing.assert_allclose(port.trigger_time.numpy()[trig],
                               np.asarray(ref.trigger_time)[trig], rtol=1e-8)
    np.testing.assert_allclose(port.base_t0.numpy(), np.asarray(ref.base_t0), rtol=1e-8)
    # every bounce path turns, so every group takes the turning-point
    # tolerance of tests/test_torch_multitrigger.py on its amplitudes
    np.testing.assert_allclose(port.max_amplitude.numpy(), np.asarray(ref.max_amplitude),
                               rtol=2e-4, atol=1e-12)
    valid = np.asarray(ref.sol_mask)
    np.testing.assert_allclose(port.max_amp_per_solution.numpy()[valid],
                               np.asarray(ref.max_amp_per_solution)[valid], rtol=2e-4)


@pytest.mark.parametrize("n_refl,focusing", [(1, False), (1, True), (2, False), (2, True)])
def test_simulate_batch_reflections_match_jax(mb_inputs, n_refl, focusing):
    settings, ch, batch = mb_inputs
    settings = dataclasses.replace(settings, n_reflections=n_refl,
                                   n_windows=1 + 2 * n_refl, apply_focusing=focusing)
    ref = jax.jit(lambda b: jpipe.simulate_batch(b, ch, settings))(batch)
    ps, pc, pb = convert.from_jax(settings, ch, batch, device="cpu", dtype=torch.float64)
    assert ps.n_reflections == n_refl and ps.ice.refl_z == -576.0
    assert ps.attenuation_model == "MB1"
    port = tpipe.simulate_batch(pb, pc, ps)
    assert port.c0.shape[-1] == 2 + 4 * n_refl
    _assert_outputs_equal(ref, port)
    if focusing:
        # always the displaced-receiver re-solve, whatever focusing_mode says
        assert ps.focusing_mode == "implicit"
        valid = np.asarray(ref.sol_mask)
        np.testing.assert_allclose(port.focusing.numpy()[valid],
                                   np.asarray(ref.focusing)[valid], rtol=5e-3)
    # some group fires only through a bounce slot
    base = tpipe.simulate_batch(pb, pc, dataclasses.replace(ps, n_reflections=0, n_windows=1))
    assert np.any(port.triggered.numpy() & ~base.triggered.numpy())


def test_sp1_takes_the_slot_path_with_reflections(mb_inputs):
    """With reflections the sparse attenuation goes through
    ``attenuation_factor_slots`` for every slot, SP1 included."""
    settings, ch, batch = mb_inputs
    settings = dataclasses.replace(settings, attenuation_model="SP1")
    ref = jax.jit(lambda b: jpipe.simulate_batch(b, ch, settings))(batch)
    ps, pc, pb = convert.from_jax(settings, ch, batch, device="cpu", dtype=torch.float64)
    port = tpipe.simulate_batch(pb, pc, ps)
    np.testing.assert_array_equal(port.triggered.numpy(), np.asarray(ref.triggered))
    np.testing.assert_allclose(port.max_amplitude.numpy(), np.asarray(ref.max_amplitude),
                               rtol=2e-4, atol=1e-12)


def test_kernel_operands_equal_between_routes(mb_inputs, monkeypatch):
    """What the kernel-1 and kernel-2 wrappers receive at s2 = 12 equals, to
    the bit, what the plain route hands the plain versions, in every one of
    the three windows."""
    settings, ch, batch = mb_inputs
    ps, pc, pb = convert.from_jax(settings, ch, batch, device="cpu", dtype=torch.float32)
    ps = dataclasses.replace(ps, band_limit_eps=1e-2)
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*args, **kw):
            calls.setdefault(name, []).append((args, kw))
            return fn(*args, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    for mod, name in ((placement, "chain_placement_reduce"),
                      (placement, "chain_placement_reduce_plain"),
                      (trigger_fused, "fused_irfft_trigger"),
                      (trigger_fused, "fused_irfft_trigger_plain")):
        spy(mod, name)
    out_k = tpipe.simulate_batch(pb, pc, ps)
    n_k1 = len(calls["chain_placement_reduce"])
    # on CPU tensors the wrappers call their plain versions themselves
    calls["chain_placement_reduce_plain"].clear()
    calls["fused_irfft_trigger_plain"].clear()
    out_p = tpipe.simulate_batch(pb, pc, dataclasses.replace(
        ps, placement_impl="plain", trigger_impl="plain"))
    assert n_k1 == len(calls["fused_irfft_trigger"]) == ps.n_windows == 3
    for kernel, plain in (("chain_placement_reduce", "chain_placement_reduce_plain"),
                          ("fused_irfft_trigger", "fused_irfft_trigger_plain")):
        assert len(calls[plain]) == 3
        for (a_k, kw_k), (a_p, kw_p) in zip(calls[kernel], calls[plain]):
            assert kw_k == kw_p
            for x, y in zip(a_k, a_p):
                assert x.dtype == y.dtype and x.shape == y.shape
                # a masked row may carry NaN (an invalid slot's garbage root)
                assert torch.equal(torch.nan_to_num(x, nan=-7.0), torch.nan_to_num(y, nan=-7.0))
    for args, _ in calls["chain_placement_reduce"]:
        # ... and only a masked row: the mask is a select, so none leaks
        nan_row = torch.isnan(args[2]).any(dim=-1) | torch.isnan(args[0]).any(dim=-1)
        assert not torch.any(nan_row & args[5])
    assert torch.isfinite(out_k.max_amplitude).all()
    assert calls["chain_placement_reduce"][0][1]["s2"] == 12
    np.testing.assert_array_equal(out_k.triggered.numpy(), out_p.triggered.numpy())


def test_mooresbay_inputs_from_numpy_alone():
    s, ch, b = convert.make_mooresbay_inputs(16, 5, device="cpu", dtype=torch.float32)
    assert (s.n_reflections, s.n_windows, s.attenuation_model) == (1, 3, "MB1")
    assert (s.n_internal, s.n_base, s.n_bisect, s.attenuation_steps) == (512, 2048, 28, 8)
    assert s.band_limit_eps == 1e-2 and s.ice.refl_coef == 0.82
    assert b.vertices.shape == (16, 2, 3) and ch.positions.shape == (4, 3)
    assert b.vertices.dtype == torch.float32
    assert torch.all(b.vertices[..., 2] >= -576.0) and torch.all(b.vertices[..., 2] <= 0)
    assert torch.all(torch.linalg.vector_norm(b.vertices[..., :2], dim=-1) <= 1500.0)
    s2, _, b2 = convert.make_mooresbay_inputs(16, 5, device="cpu", dtype=torch.float32)
    assert torch.equal(b.vertices, b2.vertices) and s == s2
    # a shorter list is a prefix of a longer one
    b3 = convert.make_mooresbay_inputs(8, 5, device="cpu", dtype=torch.float32)[2]
    assert torch.equal(b3.vertices, b.vertices[:8]) and torch.equal(b3.energies, b.energies[:8])


def test_simulation_defaults_windows_from_reflections():
    from nuradiomc_tpu_torch.sim.simulation import Simulation
    inp = convert.mooresbay_event_input(4, 1)
    for n_refl, n_win, want in ((0, None, 1), (1, None, 3), (2, None, 5), (2, 2, 2)):
        prop = {"n_reflections": n_refl, **({"n_windows": n_win} if n_win else {})}
        sim = convert.mooresbay_simulation(inp, {"propagation": prop}, device="cpu")
        assert (sim.settings.n_reflections, sim.settings.n_windows) == (n_refl, want)
    with pytest.raises(ValueError, match="reflective bottom"):
        sim = convert.mooresbay_simulation(
            inp, {"propagation": {"ice_model": "southpole_2015"}}, device="cpu")
        sim.run()
    assert isinstance(sim, Simulation)


def _jax_pin_sets():
    """The JAX package's float64 triggered set on the first PIN_GROUPS groups
    of ``convert.make_mooresbay_inputs`` (28 solver steps, GL-8, band limit
    1e-2, as the workload runs), in chunks of 256 groups."""
    port = convert.mooresbay_simulation(convert.mooresbay_event_input(PIN_GROUPS, 0),
                                        device="cpu", dtype=torch.float64)
    batch_np = port._build_batches()[-1]
    jsim = _jax_twin(port)
    settings = dataclasses.replace(jsim.settings, band_limit_eps=1e-2)
    step = jax.jit(lambda b: jpipe.simulate_batch(b, jsim.channel_params, settings).triggered)
    trig = [np.asarray(step(_jax_batch(batch_np, slice(lo, lo + 256))))
            for lo in range(0, PIN_GROUPS, 256)]
    return np.concatenate(trig)


def test_pin_matches_port_on_a_prefix():
    """The committed JAX set holds for the port on its first 128 groups."""
    pin = np.load(PIN)
    assert pin["triggered"].shape == (PIN_GROUPS,) and pin["triggered"].sum() > 20
    s, ch, b = convert.make_mooresbay_inputs(128, 0, device="cpu", dtype=torch.float64)
    out = tpipe.simulate_batch(b, ch, s)
    np.testing.assert_array_equal(out.triggered.numpy(), pin["triggered"][:128])


if __name__ == "__main__":
    triggered = _jax_pin_sets()
    np.savez_compressed(PIN, triggered=triggered, n_groups=PIN_GROUPS, seed=0)
    print(f"wrote {PIN}: {int(triggered.sum())} of {PIN_GROUPS} groups trigger")
