"""The comparison that decides ``correct``: one job of the window, drawn from
the seed, against the reference's run of the same list.

Numbers compared (each against the limit of the same name in the
configuration file's ``limits``):

- ``decisions``: groups whose decision, or whose decision of any named
  trigger, differs, or, where both sides give ``triggered_per_station``,
  whose decision at any station differs (an exact comparison; a group
  counts once);
- ``amplitude``: the widest gap of the readout amplitude per group and
  channel, over the larger of the reference's amplitude and the noise RMS;
- ``trigger_time_ns``: the widest gap of a trigger time where both fired;
- ``weight``: the widest relative gap of the Earth-absorption weights;
- ``veff``: the relative gap of the job's effective volume."""

from __future__ import annotations

import numpy as np

NAMES = ("decisions", "amplitude", "trigger_time_ns", "weight", "veff")


def station_differ(prog: dict, ref: dict):
    """Per group, whether any station's decision differs, where both sides
    give ``triggered_per_station`` ({station id: decision per group}); a
    station that one side lacks differs in every group. False where either
    side gives none."""
    p_st, r_st = prog.get("triggered_per_station"), ref.get("triggered_per_station")
    if p_st is None or r_st is None:
        return False
    p_st = {int(k): np.asarray(v, dtype=bool) for k, v in p_st.items()}
    r_st = {int(k): np.asarray(v, dtype=bool) for k, v in r_st.items()}
    G = len(ref["group_ids"])
    if set(p_st) != set(r_st):
        return np.ones(G, dtype=bool)
    differ = np.zeros(G, dtype=bool)
    for sid, r in r_st.items():
        differ |= p_st[sid] != r
    return differ


def readings(prog: dict, ref: dict, vrms: float) -> dict:
    """The numbers compared, program ``prog`` (the results dict of
    ``Simulation.run``) against the reference's ``ref``."""
    if not np.array_equal(np.asarray(prog["group_ids"]), ref["group_ids"]):
        return {name: None for name in NAMES}
    p_mt = np.asarray(prog["multiple_triggers"], dtype=bool)
    r_mt = ref["multiple_triggers"]
    differ = ((np.asarray(prog["triggered"], dtype=bool) != ref["triggered"])
              | np.any(p_mt != r_mt, axis=1) | station_differ(prog, ref))
    decisions = int(np.sum(differ))
    p_amp = np.asarray(prog["max_amplitude"], dtype=np.float64)
    r_amp = ref["max_amplitude"]
    amplitude = float(np.max(np.abs(p_amp - r_amp) / np.maximum(np.abs(r_amp), vrms),
                             initial=0.0))
    both = p_mt & r_mt
    p_tt = np.asarray(prog["trigger_times_per_trigger"], dtype=np.float64)
    r_tt = ref["trigger_times_per_trigger"]
    trigger_time = float(np.max(np.abs(p_tt - r_tt)[both], initial=0.0))
    trig = np.asarray(prog["triggered"], dtype=bool) & ref["triggered"]
    trigger_time = max(trigger_time, float(np.max(np.abs(
        np.asarray(prog["trigger_times"], dtype=np.float64) - ref["trigger_times"])[trig],
        initial=0.0)))
    p_w = np.asarray(prog["weights"], dtype=np.float64)
    r_w = np.asarray(ref["weights"], dtype=np.float64)
    weight = float(np.max(np.abs(p_w - r_w) / np.maximum(np.abs(r_w), 1e-30), initial=0.0))
    r_v = float(ref["veff"])
    veff = abs(float(prog["veff"]) - r_v) / max(abs(r_v), 1e-30)
    return {"decisions": decisions, "amplitude": amplitude,
            "trigger_time_ns": trigger_time, "weight": weight, "veff": veff}


def judge(values: dict, limits: dict) -> tuple:
    """(all within their limits, [[name, value, limit], ...]); a number
    that is missing or not finite (None, NaN) fails its limit."""
    rows = [[name, values[name], limits[name]] for name in NAMES]
    return all(v is not None and v <= lim for _, v, lim in rows), rows
