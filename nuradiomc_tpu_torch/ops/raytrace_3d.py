"""Ray tracing through any 3D refractive-index field (torch).

Counterpart of ``nuradiomc_tpu/ops/raytrace_3d.py`` (the reference's
RadioPropa path, radioproparaytracing.py:39-516): a fixed-step RK4
integration of the ray equations

    dx/ds = p / n,      dp/ds = grad n        (|p| = n along a true ray)

with ``grad n`` by automatic differentiation of the user's field, a torch
callable ``n_field(x, y, z)`` acting elementwise on tensors.

* :func:`shoot_ray` integrates a batch of rays (leading axes) with a
  perfect mirror at the surface and keeps the crossing record at the
  receiver's horizontal distance: frozen once taken, while the state
  integrates on.
* :func:`find_solutions_3d` shoots a fan of launch zeniths in the vertical
  plane through source and receiver, brackets the sign changes of the
  vertical miss, and bisects each bracket. The fan is one batch, and the
  bisection steps of all brackets run ``_TREE_LEVELS`` at a time: one batch
  holds every midpoint a run of that many bisection steps can visit, each
  computed as the bisection computes it, so the chosen path is the JAX
  package's bisection step for step (the last batch also holds the final
  midpoints, so it gives the solutions' observables).
* :func:`refine_solutions_3d` polishes the solutions by damped Newton steps
  in (zenith, out-of-plane azimuth), the 2x2 Jacobian of the (vertical,
  lateral) miss by forward-mode differentiation through the integration,
  as the JAX package's ``jacfwd`` (``shoot_ray(p0_dot=)``: each step's
  derivative carried beside it, the field's Hessian-vector products by
  ``torch.autograd``), all slots and both tangents in one batch.

The functions take one source-receiver pair, as the JAX package's do.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from nuradiomc_tpu_torch.utils import device as device_util
from nuradiomc_tpu_torch.utils.constants import speed_of_light

# bisection steps L taken per batch of rays in find_solutions_3d (2^L - 1
# midpoints per bracket): the card's time goes to launches, not to rays
_TREE_LEVELS = {"cpu": 4, "cuda": 15}
# RK4 steps per CUDA graph on the card (0: every step launched eagerly)
_GRAPH_STEPS = 100


class Ray3DSolutions(NamedTuple):
    mask: torch.Tensor           # [n_slots]
    launch_zenith: torch.Tensor  # [n_slots] in-plane launch zenith (rad)
    launch_vector: torch.Tensor  # [n_slots, 3]
    receive_vector: torch.Tensor # [n_slots, 3]
    path_length: torch.Tensor    # [n_slots]
    travel_time: torch.Tensor    # [n_slots]
    n_reflections: torch.Tensor  # [n_slots] surface bounces


def _plane_basis(x1, x2):
    """(u, d_h): unit horizontal direction from x1 toward x2 and the
    horizontal distance."""
    d = x2 - x1
    d_h = torch.sqrt(d[0] ** 2 + d[1] ** 2)
    safe = torch.clamp(d_h, min=1e-12)
    zero = torch.zeros_like(d_h)
    u = torch.stack([d[0] / safe, d[1] / safe, zero])
    return torch.where(d_h > 1e-9, u, torch.stack([zero + 1.0, zero, zero])), d_h


def _field(n_field: Callable, x, x_dot=None):
    """(n [...], grad n [..., 3]) at points x [..., 3] by one
    ``torch.autograd.grad`` of the summed field (the points are
    independent, so its gradient is each point's gradient); with a tangent
    ``x_dot`` also the Hessian-vector product H x_dot (reverse over
    reverse)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        n = n_field(xg[..., 0], xg[..., 1], xg[..., 2])
        g, = torch.autograd.grad(n.sum(), xg, create_graph=x_dot is not None)
        hv = None if x_dot is None else torch.autograd.grad((g * x_dot).sum(), xg)[0]
    return n.detach(), g.detach(), hv


def _mirror_z(x):
    return torch.cat([x[..., :2], -x[..., 2:]], dim=-1)


def shoot_ray(n_field: Callable, x0, p0, ds: float, n_steps: int, d_h_target,
              u=None, v=None, p0_dot=None):
    """Integrate rays from ``x0`` [3] along ``p0`` [..., 3] (any batch axes)
    for ``n_steps`` steps of arc length ``ds`` (raytrace_3d.py:52-142).
    Returns (crossed [...], record): the record at horizontal distance
    ``d_h_target`` from x0, ``z``, ``lat`` (the v-offset when a plane basis
    (u, v) is given; the advance is then the u-projection), ``s``, ``t``,
    ``p`` (the momentum at the start of the crossing step; the launch
    direction before any crossing) and ``n_refl``. The surface z = 0
    mirrors upgoing rays; the record is frozen once taken while the state
    integrates on, as the JAX package's scan does.

    With ``p0_dot`` (a tangent of ``p0``) the record also holds ``z_dot``
    and ``lat_dot``, the directional derivatives of ``z`` and ``lat``: the
    derivative of every step carried beside it, as forward-mode
    differentiation of the steps gives it (the JAX package's ``jacfwd``).
    The tangent is carried by hand: ``torch.func.jvp`` through the loop
    dispatches every small operation through a decomposition, tens of
    milliseconds a step."""
    tangent = p0_dot is not None
    x0 = x0.expand(p0.shape)
    d_h_target = d_h_target.reshape(1)

    def rhs(x, p, X=None, P=None):
        n, g, hX = _field(n_field, x, X)
        kx = p / n[..., None]
        if not tangent:
            return kx, g, None, None, n, g
        gX = (g * X).sum(-1)
        return kx, g, P / n[..., None] - p * (gX / n ** 2)[..., None], hX, n, g

    def horiz(x):
        d = x - x0
        if u is None:
            return torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
        return d[..., 0] * u[0] + d[..., 1] * u[1]

    def lateral(x):
        if u is None:
            return torch.zeros_like(x[..., 0])
        d = x - x0
        return d[..., 0] * v[0] + d[..., 1] * v[1]

    def linear(X, w):        # derivative of horiz / lateral along X (planar basis)
        return X[..., 0] * w[0] + X[..., 1] * w[1]

    n0 = n_field(x0[..., 0], x0[..., 1], x0[..., 2])
    norm0 = torch.sqrt(p0[..., 0] ** 2 + p0[..., 1] ** 2 + p0[..., 2] ** 2)
    zero = torch.zeros_like(n0)
    state = {"x": x0, "p": p0 * (n0 / norm0)[..., None], "s": zero, "t": zero,
             "crossed": torch.zeros_like(n0, dtype=torch.bool),
             "n_refl": torch.zeros_like(n0, dtype=torch.int32), "d": horiz(x0),
             "rec_z": torch.full_like(n0, math.nan), "rec_lat": zero, "rec_s": zero,
             "rec_t": zero, "rec_p": p0, "rec_n_refl": torch.zeros_like(n0, dtype=torch.int32)}
    if tangent:
        state.update(X=torch.zeros_like(p0), rec_z_dot=zero, rec_lat_dot=zero,
                     P=(p0_dot * (n0 / norm0)[..., None]
                        - p0 * (n0 * (p0 * p0_dot).sum(-1) / norm0 ** 3)[..., None]))

    def step(st):
        x, p, d0 = st["x"], st["p"], st["d"]
        if tangent:
            X, P = st["X"], st["P"]
            k1x, k1p, K1x, K1p, n_here, _ = rhs(x, p, X, P)
            k2x, k2p, K2x, K2p, _, _ = rhs(x + 0.5 * ds * k1x, p + 0.5 * ds * k1p,
                                           X + 0.5 * ds * K1x, P + 0.5 * ds * K1p)
            k3x, k3p, K3x, K3p, _, _ = rhs(x + 0.5 * ds * k2x, p + 0.5 * ds * k2p,
                                           X + 0.5 * ds * K2x, P + 0.5 * ds * K2p)
            k4x, k4p, K4x, K4p, _, _ = rhs(x + ds * k3x, p + ds * k3p,
                                           X + ds * K3x, P + ds * K3p)
        else:
            k1x, k1p, _, _, n_here, _ = rhs(x, p)
            k2x, k2p, _, _, _, _ = rhs(x + 0.5 * ds * k1x, p + 0.5 * ds * k1p)
            k3x, k3p, _, _, _, _ = rhs(x + 0.5 * ds * k2x, p + 0.5 * ds * k2p)
            k4x, k4p, _, _, _, _ = rhs(x + ds * k3x, p + ds * k3p)
        x_new = x + ds / 6.0 * (k1x + 2 * k2x + 2 * k3x + k4x)
        p_new = p + ds / 6.0 * (k1p + 2 * k2p + 2 * k3p + k4p)

        # surface mirror for upgoing rays
        hit = ((x_new[..., 2] > 0.0) & (p_new[..., 2] > 0.0))[..., None]
        x_new = torch.where(hit, _mirror_z(x_new), x_new)
        p_new = torch.where(hit, _mirror_z(p_new), p_new)
        n_refl = st["n_refl"] + hit[..., 0].to(torch.int32)

        d1 = horiz(x_new)
        now = (~st["crossed"]) & (d1 >= d_h_target) & (d1 > d0)
        # linear interpolation inside the step for the crossing record
        span = torch.clamp(d1 - d0, min=1e-12)
        f = torch.where(now, (d_h_target - d0) / span, 0.0)
        lat0, lat1 = lateral(x), lateral(x_new)
        out = {"x": x_new, "p": p_new, "crossed": st["crossed"] | now, "n_refl": n_refl,
               "d": d1, "s": st["s"] + ds, "t": st["t"] + ds * n_here / speed_of_light,
               "rec_z": torch.where(now, x[..., 2] + f * (x_new[..., 2] - x[..., 2]),
                                    st["rec_z"]),
               "rec_lat": torch.where(now, lat0 + f * (lat1 - lat0), st["rec_lat"]),
               "rec_s": torch.where(now, st["s"] + f * ds, st["rec_s"]),
               "rec_t": torch.where(now, st["t"] + f * ds * n_here / speed_of_light,
                                    st["rec_t"]),
               "rec_p": torch.where(now[..., None], p, st["rec_p"]),
               "rec_n_refl": torch.where(now, n_refl, st["rec_n_refl"])}
        if tangent:
            X_new = X + ds / 6.0 * (K1x + 2 * K2x + 2 * K3x + K4x)
            P_new = P + ds / 6.0 * (K1p + 2 * K2p + 2 * K3p + K4p)
            X_new = torch.where(hit, _mirror_z(X_new), X_new)
            P_new = torch.where(hit, _mirror_z(P_new), P_new)
            # horiz is planar here (u given), so its tangent is linear
            D0, D1 = linear(X, u), linear(X_new, u)
            F = torch.where(now & (d1 - d0 > 1e-12),
                            -D0 / span - (d_h_target - d0) * (D1 - D0) / span ** 2, 0.0)
            Z = (X[..., 2] + F * (x_new[..., 2] - x[..., 2])
                 + f * (X_new[..., 2] - X[..., 2]))
            L0, L1 = linear(X, v), linear(X_new, v)
            out.update(X=X_new, P=P_new,
                       rec_z_dot=torch.where(now, Z, st["rec_z_dot"]),
                       rec_lat_dot=torch.where(now, L0 + F * (lat1 - lat0) + f * (L1 - L0),
                                               st["rec_lat_dot"]))
        return out

    state = _integrate(step, state, n_steps)
    rec = {k[4:]: v for k, v in state.items() if k.startswith("rec_")}
    return state["crossed"], rec


def _integrate(step, state, n_steps: int):
    """``n_steps`` applications of ``step`` to the state dict. On the card
    a block of ``_GRAPH_STEPS`` steps is captured once in a CUDA graph and
    replayed (the same kernels on the same buffers: the same numbers, at a
    fraction of the launch cost), the remainder run eagerly."""
    block = _GRAPH_STEPS
    if state["x"].device.type != "cuda" or block < 1 or n_steps < 2 * block:
        for _ in range(n_steps):
            state = step(state)
        return state
    static = {k: v.clone() for k, v in state.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up on a copy: allocations, autograd
        scratch = {k: v.clone() for k, v in state.items()}
        for _ in range(2):
            scratch = step(scratch)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = static
        for _ in range(block):
            out = step(out)
        for k, v in out.items():
            static[k].copy_(v)
    for _ in range(n_steps // block):
        graph.replay()
    state = {k: v.clone() for k, v in static.items()}
    del graph
    for _ in range(n_steps % block):
        state = step(state)
    return state


def _in_plane(u, zenith):
    """Launch directions [..., 3] at ``zenith`` in the vertical plane along u."""
    st = torch.sin(zenith)
    return torch.stack([u[0] * st, u[1] * st, torch.cos(zenith)], dim=-1)


def _miss_of_zenith(n_field, x1, x2, zenith, ds, n_steps):
    """Signed vertical miss z(ray at the receiver distance) - z2 for in-plane
    launch zeniths [...]; NaN where the ray never gets there."""
    u, d_h = _plane_basis(x1, x2)
    crossed, rec = shoot_ray(n_field, x1, _in_plane(u, zenith), ds, n_steps, d_h)
    return torch.where(crossed, rec["z"] - x2[2], math.nan), rec


def _out_of_plane(u, v, zen, beta):
    h = torch.sin(zen)
    return torch.stack([h * (u[0] * torch.cos(beta) + v[0] * torch.sin(beta)),
                        h * (u[1] * torch.cos(beta) + v[1] * torch.sin(beta)),
                        torch.cos(zen)], dim=-1)


def _out_of_plane_dot(u, v, zen, beta, zen_dot, beta_dot):
    """The derivative of :func:`_out_of_plane` along (zen_dot, beta_dot)."""
    h, h_dot = torch.sin(zen), torch.cos(zen) * zen_dot
    cb, sb = torch.cos(beta), torch.sin(beta)
    cb_dot, sb_dot = -sb * beta_dot, cb * beta_dot
    return torch.stack([h_dot * (u[0] * cb + v[0] * sb) + h * (u[0] * cb_dot + v[0] * sb_dot),
                        h_dot * (u[1] * cb + v[1] * sb) + h * (u[1] * cb_dot + v[1] * sb_dot),
                        -torch.sin(zen) * zen_dot], dim=-1)


def _miss2_of_angles(n_field, x1, x2, zen, beta, ds, n_steps, tangent=None):
    """(vertical, lateral) miss [..., 2] for launch angles (zenith,
    out-of-plane azimuth beta), the objective of the Newton polish; with
    ``tangent`` [..., 2] (d zenith, d beta) the record also holds the
    miss's derivative along it (``z_dot``, ``lat_dot``)."""
    u, d_h = _plane_basis(x1, x2)
    v = torch.stack([-u[1], u[0], torch.zeros_like(u[0])])
    p0_dot = None if tangent is None else _out_of_plane_dot(u, v, zen, beta, tangent[..., 0],
                                                            tangent[..., 1])
    crossed, rec = shoot_ray(n_field, x1, _out_of_plane(u, v, zen, beta), ds, n_steps,
                             d_h, u=u, v=v, p0_dot=p0_dot)
    miss = torch.stack([rec["z"] - x2[2], rec["lat"]], dim=-1)
    return torch.where(crossed[..., None], miss, math.nan), rec


def _receive(p):
    return p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True), min=1e-30)


def _as_points(x1, x2, device):
    dev = device_util.resolve(device)

    def one(x):
        return x.to(dev) if torch.is_tensor(x) else torch.as_tensor(
            x, dtype=torch.float64, device=dev)

    return one(x1), one(x2)


def refine_solutions_3d(n_field: Callable, x1, x2, sols: Ray3DSolutions,
                        ds: float = 2.0, n_steps: int = 4000, n_newton: int = 6,
                        damping: float = 0.7, device=device_util.DEFAULT):
    """Newton-polish in-plane solutions over (zenith, out-of-plane azimuth)
    for media with horizontal gradients (raytrace_3d.py:166-225); returns
    (refined Ray3DSolutions, beta [n_slots]). Each step solves
    (J + 1e-12 I) delta = miss in closed form and keeps the old angles
    where the step or the miss is not finite."""
    x1, x2 = _as_points(x1, x2, device)
    zen0 = sols.launch_zenith.to(x1.device)
    angles = torch.stack([zen0, torch.zeros_like(zen0)], dim=-1)          # [S, 2]
    S = angles.shape[0]
    # the rays are independent: one batch of 2S rays, the first S carrying
    # the tangent d/d zenith, the others d/d beta, gives both columns of J
    tangents = torch.eye(2, dtype=angles.dtype, device=angles.device).repeat_interleave(S, 0)

    for _ in range(n_newton):
        a2 = angles.repeat(2, 1)
        m, rec = _miss2_of_angles(n_field, x1, x2, a2[..., 0], a2[..., 1], ds, n_steps,
                                  tangent=tangents)
        cols = torch.stack([rec["z_dot"], rec["lat_dot"]], dim=-1)
        m, J = m[:S], torch.stack([cols[:S], cols[S:]], dim=-1)   # J[s, i, j] = d m_i / d a_j
        a_, b_ = J[..., 0, 0] + 1e-12, J[..., 0, 1]
        c_, d_ = J[..., 1, 0], J[..., 1, 1] + 1e-12
        det = a_ * d_ - b_ * c_
        delta = torch.stack([(d_ * m[..., 0] - b_ * m[..., 1]) / det,
                             (a_ * m[..., 1] - c_ * m[..., 0]) / det], dim=-1)
        a_new = angles - damping * delta
        ok = torch.isfinite(a_new).all(dim=-1) & torch.isfinite(m).all(dim=-1)
        angles = torch.where(ok[..., None], a_new, angles)

    miss, rec = _miss2_of_angles(n_field, x1, x2, angles[..., 0], angles[..., 1], ds,
                                 n_steps)
    u, _ = _plane_basis(x1, x2)
    v = torch.stack([-u[1], u[0], torch.zeros_like(u[0])])
    mask = sols.mask.to(x1.device) & torch.isfinite(miss).all(dim=-1)
    return Ray3DSolutions(
        mask=mask, launch_zenith=angles[..., 0],
        launch_vector=_out_of_plane(u, v, angles[..., 0], angles[..., 1]),
        receive_vector=_receive(rec["p"]), path_length=rec["s"], travel_time=rec["t"],
        n_reflections=rec["n_refl"]), angles[..., 1]


def _sign(x):
    """sign(x) with NaN for NaN, as jnp.sign (torch.sign gives 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _bisect(shoot, lo, hi, f_lo, n_bisect: int, tree_levels: int):
    """``n_bisect`` bisection steps of every bracket [lo, hi] (the side kept
    where sign(f(mid)) == sign(f_lo); a NaN miss counts as a change of
    sign), ``tree_levels`` steps per call of ``shoot(zeniths [S, N]) ->
    (miss, record)``: each call gets the 2^L - 1 midpoints those steps can
    visit, each the mean of its own interval's ends as the step computes
    it. The last call also gets the midpoints of the intervals it can end
    in, so it returns the solution 0.5 (lo + hi) with its miss and record."""
    s_lo = _sign(f_lo)
    done = 0
    while True:
        levels = min(tree_levels, n_bisect - done)
        last = done + levels == n_bisect
        nodes, intervals = [], [(lo, hi)]
        for _ in range(levels + last):
            mids = [0.5 * (a + b) for a, b in intervals]
            nodes.append(torch.stack(mids, dim=-1))                       # [S, 2^k]
            intervals = [iv for (a, b), m in zip(intervals, mids) for iv in ((a, m), (m, b))]
        f, rec = shoot(torch.cat(nodes, dim=-1))
        start, idx = 0, torch.zeros_like(lo, dtype=torch.int64)
        for k in range(levels):
            mid = torch.gather(nodes[k], -1, idx[..., None])[..., 0]
            fm = torch.gather(f[..., start:start + 2 ** k], -1, idx[..., None])[..., 0]
            same = _sign(fm) == s_lo
            lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
            idx = 2 * idx + same.to(torch.int64)
            start += 2 ** k
        done += levels
        if last:
            pick = start + idx

            def at(x):
                i = pick.reshape(*pick.shape, *([1] * (x.dim() - f.dim() + 1)))
                return torch.take_along_dim(x, i.expand(*pick.shape, 1, *x.shape[f.dim():]),
                                            dim=f.dim() - 1)[:, 0]

            return torch.gather(nodes[-1], -1, idx[..., None])[..., 0], at(f), {
                k: at(v) for k, v in rec.items()}


def find_solutions_3d(n_field: Callable, x1, x2, n_slots: int = 4, n_fan: int = 90,
                      n_bisect: int = 30, ds: float = 2.0, n_steps: int = 4000,
                      device=device_util.DEFAULT) -> Ray3DSolutions:
    """Two-point solutions through an arbitrary 3D field (raytrace_3d.py:
    228-289): a fan of ``n_fan`` launch zeniths brackets the sign changes of
    the vertical miss, the first ``n_slots`` brackets by fan index are
    bisected ``n_bisect`` times. ``x1``/``x2`` [3] numbers, arrays or
    tensors, put on ``device`` (float64 when not tensors)."""
    x1, x2 = _as_points(x1, x2, device)
    dtype = x1.dtype
    zeniths = torch.linspace(0.02, math.pi - 0.02, n_fan, dtype=dtype, device=x1.device)
    miss_fan, _ = _miss_of_zenith(n_field, x1, x2, zeniths, ds, n_steps)

    # sign-change brackets (NaN-safe), ranked by fan index, the first n_slots
    ok = torch.isfinite(miss_fan[:-1]) & torch.isfinite(miss_fan[1:])
    sign_change = ok & (torch.sign(miss_fan[:-1]) != torch.sign(miss_fan[1:]))
    idx = torch.arange(n_fan - 1, device=x1.device)
    order = torch.argsort(torch.where(sign_change, idx, n_fan + idx))
    slots = order[:n_slots]
    slot_valid = sign_change[slots]

    zen_sol, miss, rec = _bisect(
        lambda z: _miss_of_zenith(n_field, x1, x2, z, ds, n_steps), zeniths[slots],
        zeniths[slots + 1], miss_fan[slots], n_bisect, _TREE_LEVELS[x1.device.type])
    u, _ = _plane_basis(x1, x2)
    return Ray3DSolutions(
        mask=slot_valid & torch.isfinite(miss), launch_zenith=zen_sol,
        launch_vector=_in_plane(u, zen_sol), receive_vector=_receive(rec["p"]),
        path_length=rec["s"], travel_time=rec["t"], n_reflections=rec["n_refl"])
