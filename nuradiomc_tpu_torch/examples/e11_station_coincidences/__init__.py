"""examples/11_station_coincidences: a grid of stations and how often one
neutrino fires several."""
