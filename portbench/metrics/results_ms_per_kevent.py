"""Host time of the results (the chunks merged per station, the stations
merged, Veff, the results dict), the program's spans ``sim.results``, per
1000 input events of the window."""

from portbench import program_spans


def read(rec):
    return program_spans.span_ms_per_kevent(rec, "sim.results")
