# frozen copy of nuradiomc_tpu_torch/utils/constants.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
# copied from nuradiomc_tpu/utils/constants.py:1-30 (the port keeps its own copy; it imports nothing of the JAX package)
"""Physical constants in the internal unit system (see units.py)."""

from portbench.reference import units

# CODATA speed of light, 299792458 m/s, expressed in m/ns
speed_of_light = 299792458.0 * units.m / units.s  # = 0.299792458 m/ns

# Boltzmann constant (J/K -> eV/K in the internal system)
boltzmann = 1.380649e-23 * units.joule / units.kelvin

# vacuum impedance (for fluence calculations)
Z_0 = 376.730313667 * units.ohm

# electron mass
m_e = 0.51099895e6 * units.eV

# Avogadro
N_A = 6.02214076e23 / units.mole

# lepton / meson masses and weak constants used by the tau decay sampler
# (reference: NuRadioReco/utilities/constants.py:14-25)
e_mass = m_e
mu_mass = 105.6583745 * units.MeV
tau_mass = 1776.86 * units.MeV
G_F = 1.1663787e-5 * units.GeV ** (-2)    # Fermi coupling constant
pi_mass = 139.57061 * units.MeV
rho770_mass = 775.49 * units.MeV
rho1450_mass = 1465.0 * units.MeV
a1_mass = 1230.0 * units.MeV
tau_rest_lifetime = 290.3 * units.fs      # -> c*tau = 87.03 um
