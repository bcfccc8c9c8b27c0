"""examples/12_sensitivities: a flux limit and the expected GZK count."""
