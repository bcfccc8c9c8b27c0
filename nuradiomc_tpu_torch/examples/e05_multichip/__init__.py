"""examples/05_multichip: a production step and a Veff run over a mesh."""
