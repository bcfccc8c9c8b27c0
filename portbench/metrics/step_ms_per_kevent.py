"""Wall time of the simulation step (``sim.pipeline.simulate_batch`` as
``sim.simulation`` calls it), each call ending in a device synchronize, per
1000 input events of the window."""

SPAN = {"module": "nuradiomc_tpu_torch.sim.simulation", "attr": "simulate_batch",
        "name": "step", "sync": True}


def read(rec):
    jobs = rec["jobs"]
    if not jobs or not all("step" in j.get("spans", {}) for j in jobs):
        return None
    return 1e3 * sum(j["spans"]["step"] for j in jobs) / (sum(j["events"] for j in jobs) / 1e3)
