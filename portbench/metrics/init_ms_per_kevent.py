"""Host time of job construction (``Simulation.__init__``: configuration,
detector, Vrms calibration, channel tensors, the list read), the program's
span ``sim.init``, per 1000 input events of the window."""

from portbench import program_spans


def read(rec):
    return program_spans.span_ms_per_kevent(rec, "sim.init")
