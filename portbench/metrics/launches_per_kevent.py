"""Device kernels launched in the profiled job, per 1000 of its input events
(memory copies and sets not counted)."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["launches"]:
        return None
    return prof["launches"] / (prof["events"] / 1e3)
