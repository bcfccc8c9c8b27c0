"""examples/10_pulser_calibration: a square-pulse emitter's amplitude sweep."""
