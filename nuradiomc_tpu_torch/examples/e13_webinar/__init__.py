"""examples/13_webinar: the guided chain (input lists, a run with two
named triggers and ``.nur`` output, the output, Veff, electric fields)."""
