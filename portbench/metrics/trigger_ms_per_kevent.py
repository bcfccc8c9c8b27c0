"""Host time of the step's stage 8 over all readout windows (noise, the
filter chains, every trigger: kernel 2 in the dipole cell, noise and kernel
3 in deep_pa; the decisions across windows), the program's spans
``step.trigger``, per 1000 input events of the window."""

from portbench import program_spans


def read(rec):
    return program_spans.span_ms_per_kevent(rec, "step.trigger")
