"""Host time of the step's ray tracing (stage 1 of ``simulate_batch``:
``find_solutions_all`` and the launch and receive vectors, the host's
dispatch of the solver's fixed-count loops), the program's spans
``step.raytrace``, per 1000 input events of the window."""

from portbench import program_spans


def read(rec):
    return program_spans.span_ms_per_kevent(rec, "step.raytrace")
