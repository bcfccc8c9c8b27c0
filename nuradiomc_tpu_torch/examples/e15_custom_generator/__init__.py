"""examples/15_custom_generator: an event list built by hand."""
