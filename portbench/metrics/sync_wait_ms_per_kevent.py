"""Host time spent in blocking device-to-host reads, the program's
``sync.<site>`` spans (``timing.host_sync``), per 1000 input events of the
window. In a traced run the harness's ``step`` wrapper synchronizes after
each step, so the readback's reads wait for nothing there and this reads the
waits inside the step (and the station's cable delays)."""

from portbench import program_spans


def read(rec):
    return program_spans.span_ms_per_kevent(rec, "sync.")
