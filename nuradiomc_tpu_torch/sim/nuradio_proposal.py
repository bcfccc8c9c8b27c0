# copied from nuradiomc_tpu/sim/nuradio_proposal.py:1-146 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""NuRadioProposal-compatible lepton-propagation API.

The reference's ``EvtGen/NuRadioProposal.py`` wraps the external PROPOSAL
C++ propagator and exposes two entry points used by the generator:
``ProposalFunctions.get_secondaries_array`` (:569-674, shower-inducing
secondaries along mu/tau tracks) and ``get_decays`` (:676-751, tau decay
products). This module provides the same API backed by the in-repo
stochastic propagators (sim/muon_propagation.py) so code written against the
reference's interface runs without the external dependency.

The physics approximation is documented in sim/muon_propagation.py: mean
a+bE energy loss with 1/v catastrophic-loss sampling and the reference's tau
decay kinematics — not PROPOSAL's exact differential cross sections. If the
``proposal`` package is installed, prefer the reference wrapper for
PROPOSAL-exact results.

Interaction codes follow the reference's PDG-style private range
(NuRadioProposal.py:96-130): 81 brems, 83 e_pair, 85 nucl_int, 86 hadrons
(tau decay), 11/-11 decay electrons, 13/-13 decay muons.
"""

from __future__ import annotations

import numpy as np

from nuradiomc_tpu_torch.sim import muon_propagation as mp
from nuradiomc_tpu_torch.utils import units


class SecondaryProperties:
    """Shower-inducing secondary along a lepton track
    (NuRadioProposal.SecondaryProperties:45-78)."""

    def __init__(self, distance, energy, shower_type, code, name,
                 parent_energy):
        self.distance = distance
        self.energy = energy
        self.shower_type = shower_type
        self.code = code
        self.name = name
        self.parent_energy = parent_energy

    def __str__(self):
        return (f"Particle and code    : {self.name} ({self.code})\n"
                f"Energy               : {self.energy / units.PeV} PeV\n"
                f"Distance from vertex : {self.distance / units.km} km\n"
                f"Shower type          : {self.shower_type}\n"
                f"Parent energy        : {self.parent_energy / units.PeV} PeV")


_EM_NAMES = {81: "brems", 83: "e_pair"}


class ProposalFunctions:
    """API-compatible replacement for NuRadioProposal.ProposalFunctions."""

    def __init__(self, config_file=None, log_level=None, tables_path=None,
                 seed=12, create_new=False, upper_energy_limit=None):
        self._rng = np.random.default_rng(seed)
        # relative probability of brems vs pair for 'em' losses, from the
        # loss parameters (muon_propagation.py)
        self._p_brems = mp.B_BREMS / (mp.B_BREMS + mp.B_PAIR)

    def _propagate_one(self, energy, code, low, prop_length, min_loss,
                       propagate_decay_muons=True):
        out = []
        is_tau = abs(code) == 15
        decay_dist = None
        if is_tau:
            losses, decay_info = mp.propagate_taus(
                [energy], prop_length, rng=self._rng,
                shower_energy_threshold=min_loss, e_tau_min=low)
            track = losses[0]
            decay_dist = decay_info[0][0]
        else:
            losses, _ = mp.propagate_muons(
                [energy], prop_length, rng=self._rng,
                shower_energy_threshold=min_loss, e_mu_min=low)
            track = losses[0]

        for dist, e_sh, kind in track:
            is_decay_product = decay_dist is not None and dist == decay_dist
            if kind == "mu":
                # daughter muon from tau decay: follow up its own losses
                if propagate_decay_muons and e_sh > low:
                    mu_losses, _ = mp.propagate_muons(
                        [e_sh], prop_length - dist, rng=self._rng,
                        shower_energy_threshold=min_loss, e_mu_min=low)
                    for d2, e2, k2 in mu_losses[0]:
                        c2 = self._em_code() if k2 == "em" else 85
                        out.append(SecondaryProperties(
                            dist + d2, e2, "had" if k2 == "had" else "em",
                            c2, _EM_NAMES.get(c2, "nucl_int"), e_sh))
            elif is_decay_product and kind == "had":
                out.append(SecondaryProperties(
                    dist, e_sh, "had", 86, "hadrons", energy))
            elif is_decay_product and kind == "em":
                out.append(SecondaryProperties(
                    dist, e_sh, "em", 11, "e-", energy))
            else:
                code_out = self._em_code() if kind == "em" else 85
                out.append(SecondaryProperties(
                    dist, e_sh, "had" if kind == "had" else "em",
                    code_out, _EM_NAMES.get(code_out, "nucl_int"), energy))

        out.sort(key=lambda s: s.distance)
        return out

    def _em_code(self):
        return 81 if self._rng.random() < self._p_brems else 83

    def get_secondaries_array(self, energy_leptons_nu, lepton_codes,
                              lepton_positions_nu=None, lepton_directions=None,
                              low_nu=0.5 * units.PeV,
                              propagation_length_nu=1000 * units.km,
                              min_energy_loss_nu=0.5 * units.PeV,
                              propagate_decay_muons=True):
        """2D list of :class:`SecondaryProperties` per input lepton
        (NuRadioProposal.get_secondaries_array:569-674)."""
        return [self._propagate_one(float(E), int(c), float(low_nu),
                                    float(propagation_length_nu),
                                    float(min_energy_loss_nu),
                                    propagate_decay_muons)
                for E, c in zip(energy_leptons_nu, lepton_codes)]

    def get_decays(self, energy_leptons_nu, lepton_codes,
                   lepton_positions_nu=None, lepton_directions=None,
                   low_nu=0.1 * units.PeV,
                   propagation_length_nu=1000 * units.km):
        """(decay distance, decay-product energy) tuples per tau
        (NuRadioProposal.get_decays:676-751)."""
        out = []
        for E, code in zip(energy_leptons_nu, lepton_codes):
            if abs(int(code)) != 15:
                out.append((None, None))
                continue
            losses, decay_info = mp.propagate_taus(
                [float(E)], float(propagation_length_nu), rng=self._rng,
                shower_energy_threshold=np.inf, e_tau_min=float(low_nu))
            dist, kind = decay_info[0][0], decay_info[0][1]
            if dist is None:
                out.append((None, None))
            else:
                e_prod = losses[0][-1][1] if losses[0] else 0.0
                out.append((dist, e_prod))
        return out
