# frozen copy of nuradiomc_tpu_torch/sim/muon_propagation.py:31-39 (the muon
# loss constants), :49-117 (propagate_muons), :118-155 (the tau loss table and
# decay length), :158-222 (sample_tau_decay) and :225-294 (propagate_taus), and
# of nuradiomc_tpu_torch/sim/evtgen.py:284-393 (_insert_lepton_secondaries),
# commit 9f76fe9; imports rewritten to portbench.reference.
"""Lepton secondaries for the benchmark's generator: the outgoing muon or tau
of a nu_mu / nu_tau CC interaction is propagated through ice by the port's
stochastic propagator (catastrophic losses from the 1/v spectrum, in-flight
tau decay, daughter muons followed), and every loss inside the volume becomes
one more shower of the same event group, offset in time by its flight. A mix
asks for it with ``"secondaries": "stochastic"`` in its generator
arguments."""

from __future__ import annotations

import numpy as np

from portbench.reference import constants, units

# energy-loss parameters in ice (per g/cm^2)
A_ION = 2.67e-3 * units.GeV            # GeV cm^2/g
B_BREMS = 1.6e-6
B_PAIR = 1.5e-6
B_PHOTONUCL = 0.4e-6
B_TOTAL = B_BREMS + B_PAIR + B_PHOTONUCL
RHO_ICE = 0.917                        # g/cm^3
M_TO_GCM2 = RHO_ICE * 100.0            # column depth per meter of ice


def propagate_muons(energies, max_length, rng=None, v_cut=1e-3,
                    shower_energy_threshold=1e15, e_mu_min=1e14,
                    max_steps=2000):
    """Propagate muons through ice, returning their stochastic losses.

    Parameters
    ----------
    energies : (N,) initial muon energies (internal units, eV)
    max_length : float or (N,) maximum geometric track length [m]
    v_cut : relative-loss threshold between continuous and stochastic
    shower_energy_threshold : record losses above this energy as showers
    e_mu_min : stop tracking below this muon energy

    Returns
    -------
    losses : list over muons of (distance [m], shower_energy, shower_type)
    final_energies : (N,) muon energy at the end of the track (0 if stopped)
    """
    rng = rng or np.random.default_rng()
    energies = np.asarray(energies, dtype=float)
    N = len(energies)
    max_length = np.broadcast_to(np.asarray(max_length, dtype=float), (N,))

    E = energies.copy()
    X_pos = np.zeros(N)                       # column depth travelled
    X_max = max_length * M_TO_GCM2
    alive = E > e_mu_min
    losses = [[] for _ in range(N)]

    rate = B_TOTAL * np.log(1.0 / v_cut)      # stochastic interactions per g/cm^2
    p_had = B_PHOTONUCL / B_TOTAL

    for _ in range(max_steps):
        if not alive.any():
            break
        idx = np.where(alive)[0]
        # distance to the next stochastic interaction
        dX = rng.exponential(1.0 / rate, len(idx))
        X_new = X_pos[idx] + dX
        ends = X_new > X_max[idx]
        dX_eff = np.where(ends, X_max[idx] - X_pos[idx], dX)

        # continuous losses over the step: dE/dX = -(a + b v_cut E)
        bc = B_TOTAL * v_cut
        E_after = (E[idx] + A_ION / bc) * np.exp(-bc * dX_eff) - A_ION / bc
        E_after = np.maximum(E_after, 0.0)
        X_pos[idx] += dX_eff
        E[idx] = E_after

        stopped = E[idx] <= e_mu_min
        finished = ends | stopped
        alive[idx[finished]] = False

        # stochastic loss for the still-alive ones: v from 1/v on [v_cut, 1)
        act = idx[~finished]
        if len(act):
            u = rng.random(len(act))
            v = v_cut ** (1.0 - u)            # inverse CDF of 1/v spectrum
            dE = v * E[act]
            is_had = rng.random(len(act)) < p_had
            for j, k in enumerate(act):
                if dE[j] >= shower_energy_threshold:
                    losses[k].append((X_pos[k] / M_TO_GCM2, dE[j],
                                      "had" if is_had[j] else "em"))
            E[act] = E[act] - dE
            newly_dead = E[act] <= e_mu_min
            alive[act[newly_dead]] = False

    return losses, np.where(E > e_mu_min, E, 0.0)


# ---------------------------------------------------------------------------
# tau propagation + decay (reference: EvtGen/NuRadioProposal.py get_decays /
# get_secondaries_array and utilities/inelasticities.py:160-271)
# ---------------------------------------------------------------------------

# tau energy-loss parameters in ice (per g/cm^2), high-energy values from
# Dutta, Reno, Sarcevic & Seckel, PRD 63, 094020 (2001): bremsstrahlung is
# suppressed by (m_mu/m_tau)^2, pair production by ~m^-1, photonuclear weakly;
# photonuclear dominates for taus.
TAU_B_BREMS = 6.0e-9
TAU_B_PAIR = 1.0e-7
TAU_B_PHOTONUCL = 1.8e-7
TAU_B_TOTAL = TAU_B_BREMS + TAU_B_PAIR + TAU_B_PHOTONUCL

# PROPOSAL-calibrated energy dependence of the tau radiative-loss
# coefficient b(E) [cm^2/g]: median -dlnE/dX extracted from the
# reference's committed PROPOSAL decay library
# (EvtGen/decay_library.hdf5 -> tests/golden/; extraction in
# tools/proposal_delta.py). b rises ~linearly in log10 E — photonuclear
# losses dominate at EeV energies — so the constant TAU_B_TOTAL
# (2.86e-7, the ~1e16 eV value) let EeV taus fly 1.5-2x too far
# (measured quantile deltas in docs/physics.md). Interpolated per step
# in :func:`propagate_taus`.
TAU_B_LOG10E = np.arange(15.0, 20.01, 0.5)
TAU_B_TABLE = np.array([1.362e-7, 1.852e-7, 2.716e-7, 3.582e-7, 4.524e-7,
                        5.446e-7, 6.334e-7, 7.224e-7, 8.105e-7, 8.869e-7,
                        9.483e-7])


def tau_b_total(E):
    """PROPOSAL-library-calibrated total radiative b for taus at energy E
    [eV] (clipped to the table ends)."""
    return np.interp(np.log10(np.maximum(E, 1.0)),
                     TAU_B_LOG10E, TAU_B_TABLE)


_CTAU_TAU = constants.tau_rest_lifetime * constants.speed_of_light  # m (87 um)


def sample_tau_decay(tau_energy, rnd=None):
    """Sample one tau decay: branch + products.

    Port of the reference decay kinematics (inelasticities.random_tau_branch
    :160-187 and inelasticity_tau_decay:190-271, distributions from
    Comput.Phys.Commun. 184 (2013) 2070 and arXiv:1607.00193):

    - branch ratios 0.18 (tau->mu nu nu), 0.18 (tau->e nu nu), 0.64 (hadrons)
    - hadronic: y from the pi/rho770/a1/rho1450 mixture of g_pi/g_1/g_0
      distributions by rejection sampling; hadrons carry (1-y) E_tau
    - leptonic: rest-frame x from (3-2x)x^2, boosted with a uniform decay
      angle; the charged lepton carries y_lab E_tau

    Returns
    -------
    (kind, energy): kind in {'em', 'had', 'mu'}; energy of the visible
    product ('mu' = a daughter muon to be propagated further, em/had = a
    shower at the decay point).
    """
    rnd = rnd or np.random.default_rng()
    branching = rnd.uniform(0, 1)
    m_tau = constants.tau_mass

    if branching >= 0.36:                       # hadronic branch
        b = np.array([0.12, 0.26, 0.13, 0.13])
        rs = np.array([constants.pi_mass, constants.rho770_mass,
                       constants.a1_mass, constants.rho1450_mass]) / m_tau

        def g_pi(y, r):
            return np.where((y < 0) | (y > 1 - r ** 2), 0.0,
                            -(2 * y - 1 + r) / (1 - r ** 2) ** 2)

        def g_1(y, r):
            return np.where((y < 0) | (y > 1 - r ** 2), 0.0,
                            -(2 * y - 1 + r) * (1 - 2 * r)
                            / (1 - r) ** 2 / (1 + 2 * r))

        def g_0(y, r):
            return np.where((y < 0) | (y > 1 - r ** 2), 0.0, 1 / (1 - r))

        def y_dist(y):
            out = b[0] * (g_pi(y, rs[0]) + g_0(y, rs[0]))
            for bk, r in zip(b[1:], rs[1:]):
                out = out + bk * (g_1(y, r) + g_0(y, r))
            return out

        while True:                              # rejection sampling, ymax=3
            y = rnd.uniform(0, 1)
            if rnd.uniform(0, 3) < y_dist(y):
                break
        return "had", (1.0 - y) * tau_energy

    # leptonic branches
    m_l = constants.mu_mass if branching < 0.18 else constants.e_mass
    kind = "mu" if branching < 0.18 else "em"
    nu_max = (m_tau ** 2 + m_l ** 2) / (2 * m_tau)
    xmin = m_l / nu_max
    while True:                                  # rejection on (3-2x)x^2, max at x=1
        x = rnd.uniform(0, 1)
        if x >= xmin and rnd.uniform(0, 1) < (3 - 2 * x) * x ** 2:
            break
    y_rest = x * nu_max / m_tau
    cos_theta = rnd.uniform(-1, 1)
    y_lab = y_rest - np.sqrt(max(y_rest ** 2 - (m_l / m_tau) ** 2, 0.0)) * cos_theta
    return kind, y_lab * tau_energy


def propagate_taus(energies, max_length, rng=None, v_cut=1e-3,
                   shower_energy_threshold=1e15, e_tau_min=1e14,
                   max_steps=2000):
    """Propagate taus through ice: stochastic losses + in-flight decay.

    Same a+bE stochastic treatment as :func:`propagate_muons` with
    tau-specific b parameters, plus decay-length competition: at each step
    the geometric distance to decay is drawn from an exponential with mean
    gamma c tau (using the step-start energy) and compared against the
    column-depth distance to the next catastrophic loss.

    Returns
    -------
    losses : list over taus of (distance [m], shower_energy, shower_type)
        with the decay product appended ('em'/'had' shower, or 'mu' marking
        a daughter muon to be handed to :func:`propagate_muons` with the
        given energy from the decay point).
    decay_info : list over taus of (decay_distance [m] or None, final kind,
        tau energy at decay [eV] — 0.0 when the tau never decayed)
    """
    rng = rng or np.random.default_rng()
    energies = np.asarray(energies, dtype=float)
    N = len(energies)
    max_length = np.broadcast_to(np.asarray(max_length, dtype=float), (N,))

    ln_vcut = np.log(1.0 / v_cut)
    p_had = TAU_B_PHOTONUCL / TAU_B_TOTAL
    m_tau = constants.tau_mass

    losses = [[] for _ in range(N)]
    decay_info = [(None, "none", 0.0)] * N

    for i in range(N):
        E = energies[i]
        x = 0.0                                  # geometric distance [m]
        if E <= e_tau_min:
            continue
        for _ in range(max_steps):
            # competing exponentials: catastrophic loss (column depth) vs
            # decay, with the PROPOSAL-calibrated b(E) at step-start energy
            b_tot = tau_b_total(E)
            rate = b_tot * ln_vcut
            bc = b_tot * v_cut
            d_int = rng.exponential(1.0 / rate) / M_TO_GCM2
            d_dec = rng.exponential((E / m_tau) * _CTAU_TAU / units.m)
            d_end = max_length[i] - x
            d = min(d_int, d_dec, d_end)
            # continuous losses over d (ionization negligible for taus but kept)
            E = max((E + A_ION / bc) * np.exp(-bc * d * M_TO_GCM2) - A_ION / bc, 0.0)
            x += d
            if E <= e_tau_min or d == d_end:
                break
            if d == d_dec:                       # decay wins
                kind, e_prod = sample_tau_decay(E, rng)
                if kind == "mu" or e_prod >= shower_energy_threshold:
                    losses[i].append((x, e_prod, kind))
                decay_info[i] = (x, kind, E)
                break
            # catastrophic loss
            u = rng.random()
            v = v_cut ** (1.0 - u)
            dE = v * E
            if dE >= shower_energy_threshold:
                losses[i].append((x, dE,
                                  "had" if rng.random() < p_had else "em"))
            E -= dE
            if E <= e_tau_min:
                break

    return losses, decay_info


def insert_lepton_secondaries(data, attributes, rnd):
    """Insert secondary showers from outgoing mu/tau of CC interactions.

    TPU-native equivalent of the reference's PROPOSAL branch
    (generator.py:1282-1380 + EvtGen/NuRadioProposal.py): the charged lepton
    of a nu_mu/nu_tau CC event carries E_nu(1-y) from the vertex along the
    neutrino direction; its catastrophic losses (and the tau decay products,
    including daughter muons) become additional showers of the same event
    group, time-offset by flight time. Mutates ``data`` in place.
    """
    primary = data["n_interaction"] == 1
    lep_mask = primary & (data["interaction_type"] == "cc") & \
        np.isin(np.abs(data["flavors"]), (14, 16))
    idx = np.where(lep_mask)[0]
    if not len(idx):
        return

    e_lep = data["energies"][idx] * (1 - data["inelasticity"][idx])
    zen, azi = data["zeniths"][idx], data["azimuths"][idx]
    prop_dir = -np.stack([np.sin(zen) * np.cos(azi),
                          np.sin(zen) * np.sin(azi),
                          np.cos(zen)], axis=-1)
    vertex = np.stack([data["xx"][idx], data["yy"][idx], data["zz"][idx]], axis=-1)

    # generous track cap: volume diagonal (losses outside are filtered below)
    if "rmax" in attributes:
        diag = np.hypot(2 * attributes["rmax"],
                        attributes["zmax"] - attributes["zmin"])
    else:
        diag = np.sqrt((attributes["xmax"] - attributes["xmin"]) ** 2
                       + (attributes["ymax"] - attributes["ymin"]) ** 2
                       + (attributes["zmax"] - attributes["zmin"]) ** 2)

    rows = {k: [] for k in data.keys()}

    def _inside(pos):
        if "rmax" in attributes:
            r_h = np.hypot(pos[0] - attributes["x0"], pos[1] - attributes["y0"])
            if r_h > attributes["rmax"]:
                return False
        else:
            if not (attributes["xmin"] <= pos[0] <= attributes["xmax"]
                    and attributes["ymin"] <= pos[1] <= attributes["ymax"]):
                return False
        return attributes["zmin"] <= pos[2] <= attributes["zmax"]

    for j, i in enumerate(idx):
        is_tau = abs(data["flavors"][i]) == 16
        if is_tau:
            loss_lists, decay_info = propagate_taus(
                [e_lep[j]], diag, rng=rnd)
            track_losses = list(loss_lists[0])
        else:
            loss_lists, _ = propagate_muons(
                [e_lep[j]], diag, rng=rnd)
            track_losses = list(loss_lists[0])

        # expand tau daughter muons into their own loss chains
        expanded = []
        for dist, e_sh, kind in track_losses:
            if kind == "mu":
                mu_losses, _ = propagate_muons(
                    [e_sh], diag - dist, rng=rnd)
                expanded.extend((dist + d2, e2, k2) for d2, e2, k2 in mu_losses[0])
            else:
                expanded.append((dist, e_sh, kind))

        n_int = 2
        for dist, e_sh, kind in sorted(expanded):
            pos = vertex[j] + prop_dir[j] * dist
            if not _inside(pos):
                continue
            for key in data.keys():
                if key == "xx":
                    rows[key].append(pos[0])
                elif key == "yy":
                    rows[key].append(pos[1])
                elif key == "zz":
                    rows[key].append(pos[2])
                elif key == "vertex_times":
                    rows[key].append(data["vertex_times"][i] + dist / constants.speed_of_light)
                elif key == "shower_energies":
                    rows[key].append(e_sh)
                elif key == "shower_type":
                    rows[key].append(kind)
                elif key == "interaction_type":
                    rows[key].append(kind)
                elif key == "inelasticity":
                    rows[key].append(e_sh / data["energies"][i])
                elif key == "n_interaction":
                    rows[key].append(n_int)
                else:
                    rows[key].append(data[key][i])
            n_int += 1

    if not len(rows["xx"]):
        return
    order = np.argsort(np.concatenate(
        [data["event_group_ids"], np.asarray(rows["event_group_ids"])]),
        kind="stable")
    for key in list(data.keys()):
        extra = np.asarray(rows[key], dtype=data[key].dtype if
                           data[key].dtype.kind != "U" else None)
        if data[key].dtype.kind == "U":
            extra = extra.astype(data[key].dtype)
        data[key] = np.concatenate([data[key], extra])[order]

