"""examples/02_phased_array: the deep phased array's Veff with noise."""
