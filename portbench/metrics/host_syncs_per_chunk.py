"""Blocking device-to-host reads per chunk: the program's ``host_syncs.<site>``
counters summed over sites and over the window's jobs, over its ``chunks``
counter."""

from portbench import program_spans


def read(rec):
    jobs = program_spans.window_jobs(rec)
    if not jobs:
        return None
    chunks = sum(j["counters"].get("chunks", 0) for j in jobs)
    if not chunks:
        return None
    syncs = sum(n for j in jobs for name, n in j["counters"].items()
                if name.startswith("host_syncs."))
    return syncs / chunks
