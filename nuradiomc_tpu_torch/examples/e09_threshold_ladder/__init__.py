"""examples/09_threshold_ladder: five high/low thresholds in one pass."""
