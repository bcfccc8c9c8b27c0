"""ARZ2019/ARZ2020 semi-analytic Askaryan model (torch, batched).

Counterpart of ``nuradiomc_tpu/ops/arz.py`` (reference
NuRadioMC/SignalGen/ARZ/ARZ.py): the time-domain vector potential is the
convolution of a tabulated charge-excess profile with the parametrized
Cherenkov form factor A_C(tt) (get_vector_potential:36-275); the electric
field is its negative time derivative, rotated into on-sky coordinates with
the viewing angle relative to the shower maximum (get_time_trace:500-655).

The profile integral is a fixed-shape sum, as in the JAX package: a coarse
trapezoid over the whole profile plus two dense windows of ``n_dense``
points centred on the two coarse grid points closest to tt = 0, where the
form-factor peak crosses the profile.

Every function is elementwise over one leading batch axis of (shower,
viewing direction) pairs. One pair makes (N+1) x P integrand values per
component, so ``get_time_trace`` walks the pairs in chunks whose
temporaries fit ``_CHUNK_BYTES`` (a quarter of the card's free memory on a
CUDA device, 256 MiB on the CPU).

Model parameters from ARZ.py:394-434; em_fraction from :436-447.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from nuradiomc_tpu_torch.ops.attenuation import interp
from nuradiomc_tpu_torch.utils import fft, geometry, units

RHO = 0.924 * units.g / units.cm ** 3        # ice density (ARZ.py:31)
XMU = 12.566370e-7 * units.newton / units.ampere ** 2
C = 2.99792458e8 * units.m / units.s

# (Af, t0_pos, freq_pos, exp_pos, t0_neg, freq_neg, exp_neg) per shower type
PARAMS = {
    "ARZ2019": {
        "EM": (-4.5e-14 * 0.88 * units.V * units.s, 0.057, 2.87, -3.00, 0.030, 3.05, -3.50),
        "HAD": (-3.2e-14 * units.V * units.s, 0.065, 3.00, -2.65, 0.043, 2.92, -3.21),
        "em_factor": False,
    },
    "ARZ2020": {
        "EM": (-4.445e-14 * units.V * units.s, 0.0348, 2.298, -3.588, 0.0203, 2.616, -4.043),
        "HAD": (-4.071e-14 * units.V * units.s, 0.0391, 2.338, -3.320, 0.0234, 2.686, -3.687),
        "em_factor": True,
    },
}

# temporaries of size (N+1) x P that one pair of vector_potential holds at
# its peak (measured on the CPU: the integrand's distance, delay, form
# factor, weight, two components, their segment means and the window masks)
_LIVE_ARRAYS = 14
_CPU_CHUNK_BYTES = 256 * 2 ** 20


def em_fraction(energy):
    """EM energy fraction of a hadronic shower (ARZ.py:436-447, ARZ2020)."""
    eps = torch.log10(energy / units.eV)
    return -21.98905 - 2.32492 * eps + 0.019650 * eps ** 2 + 13.76152 * torch.sqrt(eps)


def theta_to_thetaprime(theta, xmax_m, R):
    """Viewing angle w.r.t. shower max from angle w.r.t. vertex
    (ARZ.py:299-315). ``xmax_m`` is the distance of shower max along the
    axis in metres (the library's depth grid is divided by RHO at load time:
    column depths in internal units are ~1e40 and overflow float32)."""
    return torch.atan2(R * torch.sin(theta), R * torch.cos(theta) - xmax_m)


def _form_factor(tt, t0_pos, freq_pos, exp_pos, t0_neg, freq_neg, exp_neg):
    """A_Cherenkov(tt) / (Af E_TeV) (Eq. 16, get_vector_potential:245-261)."""
    a = torch.abs(tt)
    pos = torch.exp(-a / t0_pos) + (1.0 + freq_pos * a) ** exp_pos
    neg = torch.exp(-a / t0_neg) + (1.0 + freq_neg * a) ** exp_neg
    return torch.where(tt > 0, pos, neg)


def vector_potential(shower_energy, theta, N: int, dt: float,
                     profile_depth, profile_ce, is_em, n_index, distance,
                     version: str = "ARZ2020", em_frac=None,
                     window_halfwidth: int = 3, n_dense: int = 96):
    """Vector potential A(t) with N+1 samples, [B, N+1, 3]
    (get_vector_potential:36-275, arz.py:74).

    ``shower_energy``, ``theta``, ``is_em`` (bool), ``n_index``, ``distance``
    are [B]; ``profile_depth`` is the (P,) uniform depth grid in metres and
    ``profile_ce`` [B, P] (or (P,)) the charge excess per pair."""
    dtype, dev = theta.dtype, theta.device
    p = PARAMS[version]
    prm = torch.where(is_em[:, None],
                      torch.tensor(p["EM"][:7], dtype=dtype, device=dev),
                      torch.tensor(p["HAD"][:7], dtype=dtype, device=dev))
    # [B, 1, 1]: broadcast over (time, profile point)
    Af, t0p, fqp, exp_p, t0n, fqn, exp_n = (prm[:, i, None, None] for i in range(7))

    if em_frac is None:
        em_frac = em_fraction(shower_energy) if p["em_factor"] else torch.ones_like(theta)
    em_factor = torch.where(is_em, torch.ones_like(theta), em_frac)[:, None, None]

    ttt = torch.arange(N + 1, dtype=dtype, device=dev) * dt
    ttt = ttt + 0.5 * dt - torch.mean(ttt)

    n_idx = torch.as_tensor(n_index, dtype=dtype, device=dev).expand(theta.shape)[:, None, None]
    cher = torch.arccos(1.0 / n_idx)
    length = profile_depth                           # (P,) metres
    profile_ce = profile_ce.expand(theta.shape[0], length.shape[0])
    X0 = (distance * torch.sin(theta))[:, None, None]
    X2 = (distance * torch.cos(theta))[:, None, None]

    dz_coarse = length[1] - length[0]
    xntot = (torch.sum(profile_ce, dim=-1) * dz_coarse)[:, None, None]   # total track length
    factor = -XMU / (4 * math.pi)
    fc = 4 * math.pi / (XMU * torch.sin(cher))
    E_TeV = (shower_energy / units.TeV)[:, None, None]
    R0 = torch.sqrt(X0 ** 2 + X2 ** 2)
    tobs = ttt[None, :, None] + R0 / C * n_idx                          # [B, T, 1]

    def integrand(z, ce):
        """The x and z components of -v_perp ce F_p / R at the shower
        coordinates z (the y component is zero), and tt."""
        R = torch.sqrt(X0 ** 2 + (X2 - z) ** 2)
        tt = -(z - (C * tobs - n_idx * R)) / C
        in_window = (tt < 20.0) & (tt > -20.0)
        Acher = Af * E_TeV * _form_factor(tt, t0p, fqp, exp_p, t0n, fqn, exp_n)
        F_p = torch.where(in_window, Acher * fc / xntot * em_factor, 0.0)
        u_x = X0 / R
        u_z = (X2 - z) / R
        g = ce * F_p / R
        return -(u_x * u_z) * g, (u_x * u_x) * g, tt

    w = window_halfwidth
    P = length.shape[0]
    f_x, f_z, tt = integrand(length, profile_ce[:, None, :])             # [B, T, P]
    seg_x = 0.5 * (f_x[..., 1:] + f_x[..., :-1])
    seg_z = 0.5 * (f_z[..., 1:] + f_z[..., :-1])
    del f_x, f_z
    coarse = torch.stack([torch.sum(seg_x, dim=-1), torch.sum(seg_z, dim=-1)]) * dz_coarse

    # two dense windows around the two |tt| = 0 crossings
    att = torch.abs(tt)
    del tt
    i1 = torch.clamp(torch.argmin(att, dim=-1), w, P - 1 - w)            # [B, T]
    arange_p = torch.arange(P, device=dev)
    masked = torch.where(torch.abs(arange_p - i1[..., None]) <= 2 * w, torch.inf, att)
    i2 = torch.clamp(torch.argmin(masked, dim=-1), w, P - 1 - w)
    del att, masked
    lin = torch.linspace(0.0, 1.0, n_dense, dtype=dtype, device=dev)
    seg = torch.arange(P - 1, device=dev)

    def window_correction(ic):
        z_lo = length[ic - w][..., None]
        z_hi = length[ic + w][..., None]
        # dense replacement integral over [z_lo, z_hi]
        zd = lin * (z_hi - z_lo) + z_lo                                   # [B, T, D]
        ced = interp(zd, length, profile_ce[:, None, :])
        d_x, d_z, _ = integrand(zd, ced)
        dzd = zd[..., 1:] - zd[..., :-1]
        dense = torch.stack([
            torch.sum(0.5 * (d_x[..., 1:] + d_x[..., :-1]) * dzd, dim=-1),
            torch.sum(0.5 * (d_z[..., 1:] + d_z[..., :-1]) * dzd, dim=-1)])
        # subtract the coarse contribution of the same interval
        w_seg = (seg >= (ic - w)[..., None]) & (seg < (ic + w)[..., None])
        coarse_win = torch.stack([
            torch.sum(torch.where(w_seg, seg_x, 0.0), dim=-1),
            torch.sum(torch.where(w_seg, seg_z, 0.0), dim=-1)]) * dz_coarse
        return dense - coarse_win

    vp = coarse + window_correction(i1) + window_correction(i2)          # [2, B, T]
    return torch.stack([vp[0], torch.zeros_like(vp[0]), vp[1]], dim=-1) * factor


def _pairs_per_chunk(N: int, P: int, dtype, device) -> int:
    """How many pairs ``vector_potential`` takes at once: the budget (a
    quarter of the free device memory on a CUDA device, 256 MiB on the CPU)
    over ``_LIVE_ARRAYS`` temporaries of (N+1) x P values a pair."""
    if torch.device(device).type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] // 4
    else:
        budget = _CPU_CHUNK_BYTES
    per_pair = (N + 1) * P * torch.finfo(dtype).bits // 8 * _LIVE_ARRAYS
    return max(1, int(budget // per_pair))


def get_time_trace(shower_energy, theta, N: int, dt: float,
                   profile_depth, profile_ce, is_em, n_index, R,
                   version: str = "ARZ2020",
                   maximum_angle=20 * units.deg, **kwargs):
    """On-sky (eR, eTheta, ePhi) electric-field traces [B, 3, N]
    (ARZ.get_time_trace:500-655, arz.py:156); zero outside
    ``maximum_angle`` of the cone. The arguments are as in
    :func:`vector_potential`, one leading axis of pairs, walked in chunks."""
    theta = torch.as_tensor(theta)
    dtype, dev = theta.dtype, theta.device

    def vec(x, dt_=dtype):
        return torch.as_tensor(x, dtype=dt_, device=dev).expand(theta.shape)

    shower_energy, n_index, R = vec(shower_energy), vec(n_index), vec(R)
    is_em = vec(is_em, torch.bool)
    B, P = theta.shape[0], profile_depth.shape[0]
    profile_ce = profile_ce.expand(B, P)
    step = _pairs_per_chunk(N, P, dtype, dev)
    out = []
    for lo in range(0, B, step):
        sl = slice(lo, lo + step)
        vp = vector_potential(shower_energy[sl], theta[sl], N, dt, profile_depth,
                              profile_ce[sl], is_em[sl], n_index[sl], R[sl], version,
                              **kwargs)
        trace = -(vp[:, 1:] - vp[:, :-1]) / dt                            # [b, N, 3] ground
        xmax = profile_depth[torch.argmax(profile_ce[sl], dim=-1)]
        thetaprime = theta_to_thetaprime(theta[sl], xmax, R[sl])[:, None]
        onsky = geometry.ground_to_onsky(trace, thetaprime, torch.zeros_like(thetaprime))
        cher = torch.arccos(1.0 / n_index[sl])
        keep = torch.abs(theta[sl] - cher) <= maximum_angle
        out.append(torch.where(keep[:, None, None], onsky.transpose(-1, -2), 0.0))
    return torch.cat(out) if out else theta.new_zeros((0, 3, N))


def get_frequency_spectrum(shower_energy, theta, N: int, dt: float, library, is_em,
                           n_index, R, profile_idx, version: str = "ARZ2020"):
    """The scalar spectrum [B, N//2+1] the pipeline uses: the eTheta
    component of the trace of each pair's library profile (pipeline.py:774)."""
    ce = select_profile(library, shower_energy, is_em, profile_idx)
    tr = get_time_trace(shower_energy, theta, N, dt, library.depth, ce, is_em, n_index, R,
                        version=version)
    return fft.time2freq(tr[:, 1], 1.0 / dt)


# ---- shower-profile library --------------------------------------------------

class ShowerLibrary(NamedTuple):
    """Packed charge-excess profile library.

    Profiles are stored per shower type on a common depth grid, with the
    energy they were simulated at (amplitudes rescale linearly with energy,
    ARZ.get_time_trace:563-570). ``depth`` holds the grid as axis distance
    in METRES (column depth / RHO, converted at load time): raw column
    depths carry units.g (~6e33) and overflow float32. The loaders return
    numpy leaves; ``to`` moves them to a device.
    """

    depth: object        # (P,) common depth grid, metres (= X/RHO)
    ce_em: object        # (M_em, P)
    e_em: object         # (M_em,) simulation energies
    ce_had: object       # (M_had, P)
    e_had: object        # (M_had,)

    def to(self, device, dtype):
        return ShowerLibrary(*(
            a.to(device=device, dtype=dtype) if torch.is_tensor(a)
            else torch.as_tensor(np.asarray(a), dtype=dtype, device=device) for a in self))


# copied from nuradiomc_tpu/ops/arz.py:199 (load_library_pickle), numpy leaves
def load_library_pickle(path: str) -> ShowerLibrary:
    """Load a reference-format shower library pickle
    (dict[shower_type][energy] -> {'depth', 'charge_excess'})."""
    import pickle

    with open(path, "rb") as f:
        lib = pickle.load(f, encoding="latin1")

    def pack(sub):
        depths, ces, es = None, [], []
        for E, entry in sorted(sub.items()):
            depths = np.asarray(entry["depth"])
            for ce in entry["charge_excess"]:
                ces.append(np.asarray(ce))
                es.append(E)
        return depths, np.array(ces), np.array(es)

    d_em, ce_em, e_em = pack(lib.get("EM", lib.get("em", {})))
    d_had, ce_had, e_had = pack(lib.get("HAD", lib.get("had", {})))
    depth = (d_em if d_em is not None else d_had) / float(RHO)
    return ShowerLibrary(depth=depth, ce_em=ce_em, e_em=e_em, ce_had=ce_had, e_had=e_had)


# copied from nuradiomc_tpu/ops/arz.py:224 (build_library_from_t_files)
def build_library_from_t_files(file_electron: str, file_positron: str,
                               energy: float) -> ShowerLibrary:
    """Build a single-shower library from raw AIRES .t1005/.t1006 exports
    (charge excess = N_e - N_p; scripts/A01preprocess_shower_library_v1.2.py)."""
    depth_e, N_e = np.loadtxt(file_electron, unpack=True, usecols=(1, 2))
    depth_p, N_p = np.loadtxt(file_positron, unpack=True, usecols=(1, 2))
    depth = (depth_e - 1000.0) * float(units.g / units.cm ** 2 / RHO)
    ce = (N_e - N_p)[None, :]
    return ShowerLibrary(depth=depth, ce_em=ce, e_em=np.asarray([energy]),
                         ce_had=ce, e_had=np.asarray([energy]))


def select_profile(lib: ShowerLibrary, shower_energy, is_em, i_profile):
    """Profile ``i_profile`` of each pair's shower type with the energy
    rescaling, [B, P] (arz.py:237; ARZ.py:563-599). ``lib`` holds tensors."""
    def pick(ce, es):
        i = torch.clamp(i_profile.long(), 0, ce.shape[0] - 1)
        return ce[i] * (shower_energy / es[i])[..., None]

    return torch.where(is_em[..., None], pick(lib.ce_em, lib.e_em),
                       pick(lib.ce_had, lib.e_had))
