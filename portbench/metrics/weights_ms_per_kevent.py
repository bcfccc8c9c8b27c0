"""Host wall time inside the Earth-absorption weights
(``sim.earth_attenuation.get_weight``), per 1000 input events of the window."""

SPAN = {"module": "nuradiomc_tpu_torch.sim.earth_attenuation", "attr": "get_weight",
        "name": "weights", "sync": False}


def read(rec):
    jobs = rec["jobs"]
    if not jobs or not all("weights" in j.get("spans", {}) for j in jobs):
        return None
    return 1e3 * sum(j["spans"]["weights"] for j in jobs) / (sum(j["events"] for j in jobs) / 1e3)
