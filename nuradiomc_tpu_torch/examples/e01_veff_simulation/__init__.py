"""examples/01_Veff_simulation: the event list, the dipole Veff run, its
Veff table."""
