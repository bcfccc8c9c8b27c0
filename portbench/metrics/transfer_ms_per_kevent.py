"""Host time of moving each chunk to the card and its outputs back, less the
waits: the program's spans ``sim.h2d`` (the chunk's host-to-device copy)
and ``sim.readback`` (every read of the chunk's outputs and their packing)
less the ``sync.*`` spans inside them, per 1000 input events of the window.
In a traced run the harness's ``step`` wrapper has synchronized before the
readback, so its first read waits for nothing."""

from portbench import program_spans

SPANS = ("sim.h2d", "sim.readback")


def read(rec):
    def transfer(job):
        outer = program_spans.durations(job, SPANS)
        if not outer:
            return None
        return sum(outer) - sum(program_spans.durations(job, "sync.", within=SPANS))
    return program_spans.ms_per_kevent(rec, transfer)
