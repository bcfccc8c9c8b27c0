"""Host time of the padded [group x shower] batch (``Simulation._build_batches``:
grouping, padding, the k_L draws), the program's span ``sim.batch``, per 1000
input events of the window."""

from portbench import program_spans


def read(rec):
    return program_spans.span_ms_per_kevent(rec, "sim.batch")
