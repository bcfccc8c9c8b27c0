"""Self time of the orchestrator (``sim.simulation``: job construction,
batch building, the chunk loop, readback, results, Veff): each window job's
wall time less the time of its child spans, per 1000 input events."""


def read(rec):
    jobs = rec["jobs"]
    if not jobs or not all("spans" in j for j in jobs):
        return None
    self_s = sum(j["wall_s"] - sum(j["spans"].values()) for j in jobs)
    return 1e3 * self_s / (sum(j["events"] for j in jobs) / 1e3)
