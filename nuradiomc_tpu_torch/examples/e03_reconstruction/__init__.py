"""examples/03_reconstruction: a simple MC reconstruction chain."""
