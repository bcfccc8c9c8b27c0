"""examples/14_alias_phased_array: the phased array in higher Nyquist zones."""
