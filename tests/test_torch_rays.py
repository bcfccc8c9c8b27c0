"""The port's ray solvers beyond the analytic one held to the JAX package's,
on the CPU in float64, on the same numpy-seeded inputs:

* the stratified profiles (``models/ice_profiles.py``): n(z) at rtol 1e-14;
* ``raytrace.reflection_angle``: 1e-12 rad and the same NaN pattern;
* ``raytrace.find_solution_ice_to_air``: tests/test_ice_to_air.py's four
  geometries and its unreachable one at 1e-10 (relative; angles absolute),
  and that test's scipy ray ODE applied to the port's own solutions;
* ``raytrace_numeric.find_solutions_numeric``: the exponential (the analytic
  ice seen as a profile), firn, shadow-zone, poly5 and perturbation
  geometries of tests/test_raytrace_numeric.py: masks and types equal, s
  and travel time at rtol 1e-10;
* ``raytrace_3d``: tests/test_raytrace_3d.py's cases (two stratified pairs,
  the surface bounce, the blob field with its base, the tilted field's
  Newton polish) at reduced settings (ds 5 m, 300 steps or 600 for the
  farther pair, a fan of 16, 8 bisections, 6 Newton steps): masks equal, angles, path lengths and
  travel times within 1e-9 (relative for lengths and times).

The JAX solvers run once per module (fixtures); their loops compile on
first use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import integrate

from nuradiomc_tpu.models import ice as jice
from nuradiomc_tpu.models import ice_profiles as jprof
from nuradiomc_tpu.ops import raytrace as jrt
from nuradiomc_tpu.ops import raytrace_3d as j3d
from nuradiomc_tpu.ops import raytrace_numeric as jnum
from nuradiomc_tpu_torch.models import ice as tice
from nuradiomc_tpu_torch.models import ice_profiles as tprof
from nuradiomc_tpu_torch.ops import raytrace as trt
from nuradiomc_tpu_torch.ops import raytrace_3d as t3d
from nuradiomc_tpu_torch.ops import raytrace_numeric as tnum
from nuradiomc_tpu_torch.utils.constants import speed_of_light

F64 = torch.float64


# ---- ice profiles -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jprof.PROFILES))
def test_profiles_equal_the_jax_package(name):
    import dataclasses
    z = np.concatenate([np.linspace(-3000.0, -1.0, 997), np.linspace(-20.0, 5.0, 51)])
    got = tprof.get_profile(name).index_of_refraction(torch.as_tensor(z)).numpy()
    want = np.asarray(jprof.get_profile(name).index_of_refraction(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    a, b = tprof.get_profile(name), jprof.get_profile(name)
    if name != "greenland_perturbation":
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(NotImplementedError):
        tprof.get_profile("no_such_profile")


# ---- reflection angle -------------------------------------------------------

def test_reflection_angle_matches_the_jax_package():
    """Shallow pairs and a spread of C0 around the surface's turning point,
    so both reflected (a zenith) and other (NaN) entries occur."""
    rng = np.random.default_rng(5)
    n = 400
    ice_j, ice_t = jice.southpole_2015, tice.southpole_2015
    x1z = rng.uniform(-300.0, -5.0, n)
    x2z = rng.uniform(-100.0, -2.0, n)
    x2y = rng.uniform(10.0, 1500.0, n)
    c0 = 1.0 / (ice_j.n_ice - ice_j.delta_n) * rng.uniform(0.98, 1.3, n)
    want = np.asarray(jax.jit(jax.vmap(lambda c, a, b, d: jrt.reflection_angle(
        c, 0.0, a, d, b, ice_j)))(c0, x1z, x2z, x2y))
    got = trt.reflection_angle(*(torch.as_tensor(x) for x in (c0, np.zeros(n), x1z, x2y, x2z)),
                               ice_t).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert 50 < ok.sum() < n - 50
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-12)


# ---- ice to air -------------------------------------------------------------

AIR_PAIRS = [((0.0, -20.0), (300.0, 500.0)), ((0.0, -100.0), (100.0, 200.0)),
             ((0.0, -300.0), (50.0, 100.0)), ((0.0, -50.0), (1000.0, 2000.0)),
             ((0.0, -1000.0), (5000.0, 10.0))]      # the last: tests/test_ice_to_air.py's unreachable


@pytest.fixture(scope="module")
def air():
    a = np.array([[p[0][0], p[0][1], p[1][0], p[1][1]] for p in AIR_PAIRS])
    ice_j = jice.southpole_2015
    want = jax.jit(jax.vmap(lambda p: jrt.find_solution_ice_to_air(p[0], p[1], p[2], p[3],
                                                                  ice_j)))(jnp.asarray(a))
    got = trt.find_solution_ice_to_air(*(torch.as_tensor(a[:, k]) for k in range(4)),
                                       tice.southpole_2015, device="cpu")
    return want, got


def test_ice_to_air_matches_the_jax_package(air):
    want, got = air
    for field in want._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.shape == w.shape == (len(AIR_PAIRS), 1), field
        if w.dtype.kind in "bi":
            np.testing.assert_array_equal(g, w, err_msg=field)
        elif field in ("launch_angle", "receive_angle"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10, err_msg=field)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=0, err_msg=field)
    assert bool(got.mask[:4].all()) and np.isfinite(got.c0.numpy()).all()


@pytest.mark.parametrize("k", range(4))
def test_ice_to_air_port_solution_hits_the_receiver(air, k):
    """tests/test_ice_to_air.py's scipy ray ODE on the port's own solution."""
    (x1y, x1z), (x2y, x2z) = AIR_PAIRS[k]
    ice = tice.southpole_2015
    sols = air[1]
    c0 = float(sols.c0[k, 0])

    def n(z):
        return ice.n_ice - ice.delta_n * np.exp(z / ice.z_0)

    def dy_dz(z, y):
        return 1.0 / np.sqrt(c0 ** 2 * n(z) ** 2 - 1.0)

    y_exit = integrate.solve_ivp(dy_dz, (x1z, 0.0), [x1y], rtol=1e-10, atol=1e-12).y[0][-1]
    sin_air = n(0.0) / (c0 * n(0.0))
    np.testing.assert_allclose(y_exit + x2z * sin_air / np.sqrt(1 - sin_air ** 2), x2y,
                               atol=1e-3)
    t_ice = integrate.solve_ivp(lambda z, t: np.sqrt(1 + dy_dz(z, None) ** 2) * n(z)
                                / speed_of_light, (x1z, 0.0), [0.0], rtol=1e-10,
                                atol=1e-12).y[0][-1]
    np.testing.assert_allclose(float(sols.travel_time[k, 0]),
                               t_ice + np.hypot(x2y - y_exit, x2z) / speed_of_light, rtol=1e-6)
    np.testing.assert_allclose(np.sin(float(sols.launch_angle[k, 0])), 1.0 / (c0 * n(x1z)),
                               rtol=1e-9)


# ---- the stratified numeric solver ----------------------------------------

class _Adapter:
    """An analytic ice model seen as a generic n(z) profile
    (tests/test_raytrace_numeric.py's _SimpleAdapter)."""
    z_bottom = -3000.0

    def __init__(self, ice):
        self.ice = ice

    def index_of_refraction(self, z):
        return self.ice.index_of_refraction(z)


def _numeric_cases():
    rng = np.random.default_rng(0)
    expo = np.array([[rng.uniform(-1500, -200), rng.uniform(-150, -40), rng.uniform(100, 1500)]
                     for _ in range(4)])                            # (z1, z2, r)
    rng = np.random.default_rng(1)
    firn = np.stack([rng.uniform(-1200, -200, 6), rng.uniform(-150, -30, 6),
                     rng.uniform(100, 1200, 6)], -1)
    return {
        "exponential": ("adapter", expo),
        # the last pair: tests/test_raytrace_numeric.py's shadow zone
        "firn and shadow": ("greenland_firn", np.vstack([[[-700.0, -80.0, 900.0]], firn,
                                                         [[-20.0, -10.0, 4000.0]]])),
        "poly5": ("greenland_poly5", np.array([[-600.0, -100.0, 700.0]])),
        "perturbation": ("greenland_perturbation",
                         np.array([[-1500.0, -400.0, 800.0], [-150.0, -80.0, 200.0]])),
    }


@pytest.mark.parametrize("case", sorted(_numeric_cases()))
def test_numeric_solver_matches_the_jax_package(case):
    name, pts = _numeric_cases()[case]
    if name == "adapter":
        jp, tp = _Adapter(jice.greenland_simple), _Adapter(tice.greenland_simple)
    else:
        jp, tp = jprof.get_profile(name), tprof.get_profile(name)
    want = jax.jit(jax.vmap(lambda a, b, c: jnum.find_solutions_numeric(jp, 0.0, a, c, b)))(
        pts[:, 0], pts[:, 1], pts[:, 2])
    got = tnum.find_solutions_numeric(tp, np.zeros(len(pts)), pts[:, 0], pts[:, 2], pts[:, 1],
                                      device="cpu")
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_array_equal(got.sol_type.numpy(), np.asarray(want.sol_type))
    assert mask.any()
    if case == "firn and shadow":
        assert not mask[-1].any()
    for field, atol in (("s", 0), ("travel_time", 0), ("path_length", 0),
                        ("launch_angle", 1e-10), ("receive_angle", 1e-10)):
        np.testing.assert_allclose(getattr(got, field).numpy()[mask],
                                   np.asarray(getattr(want, field))[mask],
                                   rtol=1e-10 if atol == 0 else 0, atol=atol, err_msg=field)


# ---- the 3D solver ----------------------------------------------------------

KW3 = dict(ds=5.0, n_fan=16, n_bisect=8)
J_ICE, T_ICE = jice.southpole_simple, tice.southpole_simple


def _j_strat(x, y, z):
    return jnp.where(z > 0, 1.000293, J_ICE.index_of_refraction(z))


def _t_strat(x, y, z):
    return torch.where(z > 0, 1.000293, T_ICE.index_of_refraction(z))


def _j_blob(x, y, z):
    blob = 0.05 * jnp.exp(-(((x - 300.0) / 120.0) ** 2 + (y / 120.0) ** 2
                            + ((z + 450.0) / 120.0) ** 2))
    return _j_strat(x, y, z) + jnp.where(z > 0, 0.0, blob)


def _t_blob(x, y, z):
    blob = 0.05 * torch.exp(-(((x - 300.0) / 120.0) ** 2 + (y / 120.0) ** 2
                              + ((z + 450.0) / 120.0) ** 2))
    return _t_strat(x, y, z) + torch.where(z > 0, 0.0, blob)


def _j_tilt(x, y, z):
    return _j_strat(x, y, z) + jnp.where(z > 0, 0.0, 2e-5 * y)


def _t_tilt(x, y, z):
    return _t_strat(x, y, z) + torch.where(z > 0, 0.0, 2e-5 * y)


# (JAX field, port field, source, receiver, steps): steps of 5 m enough for
# the longer ray of each case to reach the receiver's distance
CASES_3D = {
    "stratified_a": (_j_strat, _t_strat, (600.0, 200.0, -800.0), (0.0, 0.0, -100.0), 300),
    "stratified_b": (_j_strat, _t_strat, (1200.0, -300.0, -1500.0), (0.0, 0.0, -200.0), 600),
    "reflected": (_j_strat, _t_strat, (700.0, 0.0, -300.0), (0.0, 0.0, -50.0), 300),
    "blob": (_j_blob, _t_blob, (600.0, 0.0, -800.0), (0.0, 0.0, -100.0), 300),
    "tilted": (_j_tilt, _t_tilt, (500.0, 0.0, -700.0), (0.0, 0.0, -100.0), 300),
}


def _same_solutions(got, want):
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    assert mask.any()
    np.testing.assert_array_equal(got.n_reflections.numpy()[mask],
                                  np.asarray(want.n_reflections)[mask])
    for field in ("launch_zenith", "launch_vector", "receive_vector"):
        np.testing.assert_allclose(getattr(got, field).numpy()[mask],
                                   np.asarray(getattr(want, field))[mask], rtol=0, atol=1e-9,
                                   err_msg=field)
    for field in ("path_length", "travel_time"):
        np.testing.assert_allclose(getattr(got, field).numpy()[mask],
                                   np.asarray(getattr(want, field))[mask], rtol=1e-9,
                                   err_msg=field)


@pytest.fixture(scope="module")
def solved_3d():
    """Both packages' solutions of every case; the JAX solver jitted once
    per field, with the points as arguments (one compile for the three
    stratified cases)."""
    out, jitted = {}, {}
    for case, (jf, tf, src, rec, n_steps) in CASES_3D.items():
        if (jf, n_steps) not in jitted:
            jitted[jf, n_steps] = jax.jit(lambda a, b, f=jf, n=n_steps: j3d.find_solutions_3d(
                f, a, b, n_steps=n, **KW3))
        want = jitted[jf, n_steps](jnp.asarray(src), jnp.asarray(rec))
        got = t3d.find_solutions_3d(tf, src, rec, device="cpu", n_steps=n_steps, **KW3)
        out[case] = (want, got)
    return out


@pytest.mark.parametrize("case", sorted(CASES_3D))
def test_3d_solver_matches_the_jax_package(solved_3d, case):
    want, got = solved_3d[case]
    _same_solutions(got, want)


def test_3d_newton_polish_matches_the_jax_package(solved_3d):
    jf, tf, src, rec, n_steps = CASES_3D["tilted"]
    kw = dict(ds=KW3["ds"], n_steps=n_steps)
    want, beta_j = jax.jit(lambda a, b, sols: j3d.refine_solutions_3d(jf, a, b, sols, **kw))(
        jnp.asarray(src), jnp.asarray(rec), solved_3d["tilted"][0])
    got, beta_t = t3d.refine_solutions_3d(tf, src, rec, solved_3d["tilted"][1], device="cpu",
                                          **kw)
    _same_solutions(got, want)
    mask = np.asarray(want.mask)
    np.testing.assert_allclose(beta_t.numpy()[mask], np.asarray(beta_j)[mask], rtol=0, atol=1e-9)
    assert np.max(np.abs(beta_t.numpy()[mask])) > 1e-5       # the polish left the plane
    # the polished rays hit the receiver (tests/test_raytrace_3d.py's check)
    for k in np.where(mask)[0]:
        miss, _ = t3d._miss2_of_angles(tf, torch.as_tensor(src, dtype=F64),
                                       torch.as_tensor(rec, dtype=F64), got.launch_zenith[k],
                                       beta_t[k], kw["ds"], kw["n_steps"])
        assert float(miss.abs().max()) < 0.05
