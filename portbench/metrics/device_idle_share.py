"""Share of the profiled job's unprofiled wall time in which no device op
ran: 1 minus the union of its device op intervals (from the profiler's trace)
over the wall time of the same job on the same list without the profiler."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
