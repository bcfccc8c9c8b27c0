"""examples/08_interop: NuRadioReco-format ``.nur`` files and trigger modules."""
