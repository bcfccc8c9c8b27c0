# copied from nuradiomc_tpu/utils/particle_names.py:1-76 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""PDG particle-id <-> name mapping
(NuRadioReco/utilities/particle_names.py:1-84; the table itself is from the
reference's event_generation manual)."""

from __future__ import annotations

import numpy as np

particle_names = {
    0: "Gamma (photon)",
    11: "Electron",
    -11: "Positron",
    12: "Electron neutrino",
    -12: "Electron antineutrino",
    13: "Muon (negative)",
    -13: "Antimuon (positive muon)",
    14: "Muon neutrino",
    -14: "Muon antineutrino",
    15: "Tau (negative)",
    -15: "Antitau (or positive tau)",
    16: "Tau neutrino",
    -16: "Tau antineutrino",
    # 81-100: generator-specific pseudoparticles and concepts
    80: "Particle",
    81: "Bremsstrahlung photon",
    82: "Ionised electron",
    83: "Electron-positron pair",
    84: "Hadron blundle",
    85: "Nuclear interaction products",
    86: "Hadronic Decay bundle",
    87: "Muon pair",
    88: "Continuous loss",
    89: "Weak interaction",
    90: "Compton",
    91: "Decay",
    111: "Pion (neutral)",
    211: "Pion (positive)",
    -211: "Pion (negative)",
    311: "Kaon (neutral)",
    321: "Kaon (positive)",
    -321: "Kaon (negative)",
    2212: "Proton",
    -2212: "Antiproton",
}

particle_ids = {v: k for k, v in particle_names.items()}

em_primary_names = ["Gamma (photon)", "Electron", "Positron",
                    "Bremsstrahlung photon", "Ionised electron",
                    "Electron-positron pair", "Weak interaction", "Compton"]

had_primary_names = ["Hadron blundle", "Nuclear interaction products",
                     "Hadronic Decay bundle", "Pion (neutral)",
                     "Pion (positive)", "Pion (negative)", "Kaon (neutral)",
                     "Kaon (positive)", "Kaon (negative)", "Proton",
                     "Antiproton"]

primary_names = em_primary_names + had_primary_names


def particle_name(id):
    """Name for a PDG id (particle_names.particle_name:56-66)."""
    if not isinstance(id, (int, np.integer)):
        raise TypeError("This function only takes integers.")
    if id not in particle_names:
        raise ValueError(f"Particle id: {id:d} unknown")
    return particle_names[id]


def particle_id(name):
    """PDG id for a name (particle_names.particle_id:68-81)."""
    if not isinstance(name, str):
        raise TypeError("This function only takes strings.")
    if name not in particle_ids:
        raise ValueError(f"Particle name: {name} unknown")
    return particle_ids[name]
