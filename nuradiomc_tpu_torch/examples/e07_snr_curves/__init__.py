"""examples/07_snr_curves: the phased array's trigger efficiency against SNR."""
