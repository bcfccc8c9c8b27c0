"""Arithmetic that several metric readers share."""


def roofline_share(rec, op, bound):
    """100 x the summed bound time of the profiled job's calls of ``op``
    over the summed device time of the kernels whose name holds
    ``op["kernel"]``; None where the job made no such call or launched no
    such kernel."""
    prof = rec.get("profile")
    if not prof:
        return None
    calls = prof["ops"].get(op["name"])
    device_s = sum(t for name, (_, t) in prof["kernels"].items() if op["kernel"] in name)
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(bound(p)[0] for p in calls) / device_s
