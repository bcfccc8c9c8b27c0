# copied from nuradiomc_tpu/sim/eventbrowser.py:1-291 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""Event viewer: plot traces/spectra/station overviews from event files.

A lightweight CLI/matplotlib replacement for the reference's Dash event
browser (NuRadioReco/eventbrowser/app.py — overview/traces/simulation tabs,
trace + spectrum plots, launched via `NuRadioViewer`). Renders the same
per-channel time traces and spectra plus the station overview, to files or
interactive windows.

Usage::

    python -m nuradiomc_tpu_torch.sim.eventbrowser events.nur [--event N] [--out dir]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from nuradiomc_tpu_torch.sim.io_nur import EventReader
from nuradiomc_tpu_torch.utils import units


def plot_event(event, out_path=None, show=False):
    """Trace + spectrum grid for every channel of every station."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for station in event.get_stations():
        cids = station.get_channel_ids()
        n = max(len(cids), 1)
        fig, axes = plt.subplots(n, 2, figsize=(11, 2.2 * n), squeeze=False)
        for i, cid in enumerate(cids):
            ch = station.get_channel(cid)
            tr = ch.get_trace()
            tt = ch.get_times()
            axes[i][0].plot(tt, tr / units.mV, lw=0.8)
            axes[i][0].set_ylabel(f"ch {cid}\n[mV]")
            spec = np.abs(ch.get_frequency_spectrum())
            ff = ch.get_frequencies()
            axes[i][1].plot(ff / units.MHz, spec, lw=0.8)
            axes[i][1].set_yscale("log")
        axes[-1][0].set_xlabel("time [ns]")
        axes[-1][1].set_xlabel("frequency [MHz]")
        fig.suptitle(f"run {event.get_run_number()} event {event.get_id()} "
                     f"station {station.get_id()}"
                     + (" TRIGGERED" if station.has_triggered() else ""))
        fig.tight_layout()
        if out_path:
            fn = os.path.join(
                out_path, f"event_{event.get_id()}_station_{station.get_id()}.png")
            fig.savefig(fn, dpi=120)
            print("wrote", fn)
        if show:
            plt.show()
        plt.close(fig)


def _event_payload(event, max_samples=4096):
    """JSON-serializable dict of one event (channels, triggers, sim info)."""
    from nuradiomc_tpu_torch.framework import parameters as par

    def ds(x):
        x = np.asarray(x, dtype=float)
        if x.size > max_samples:
            stride = int(np.ceil(x.size / max_samples))
            return x[::stride]
        return x

    payload = {"run": int(event.get_run_number()), "id": int(event.get_id()),
               "stations": [], "showers": []}
    for station in event.get_stations():
        st = {"id": int(station.get_id()),
              "triggered": bool(station.has_triggered()),
              "triggers": [], "channels": [], "efields": [],
              "params": {}}
        for name, trig in station.get_triggers().items():
            st["triggers"].append({
                "name": name, "type": trig.get_type(),
                "triggered": bool(trig.has_triggered()),
                "time": (float(trig.get_trigger_time())
                         if trig.has_triggered()
                         and trig.get_trigger_time() is not None else None)})
        for p in (par.stationParameters.zenith, par.stationParameters.azimuth,
                  par.stationParameters.cr_energy):
            try:
                if station.has_parameter(p):
                    st["params"][p.name] = float(station.get_parameter(p))
            except Exception:
                pass
        for cid in station.get_channel_ids():
            ch = station.get_channel(cid)
            tr = np.asarray(ch.get_trace(), dtype=float)
            spec = np.abs(np.asarray(ch.get_frequency_spectrum()))
            st["channels"].append({
                "id": int(cid),
                "t0": float(ch.get_trace_start_time()),
                "fs": float(ch.get_sampling_rate()),
                "trace_mV": ds(tr / units.mV).tolist(),
                "spec": ds(spec).tolist(),
                "fmax_MHz": float(ch.get_sampling_rate() / 2 / units.MHz),
            })
        sim = station.get_sim_station() if station.has_sim_station() else None
        if sim is not None:
            for ef in sim.get_electric_fields():
                e = np.asarray(ef.get_trace(), dtype=float)
                if e.ndim == 2 and e.shape[0] == 3:
                    st["efields"].append({
                        "channels": [int(c) for c in
                                     np.atleast_1d(ef.get_channel_ids())],
                        "eTheta": ds(e[1] * units.m / units.micro).tolist(),
                        "ePhi": ds(e[2] * units.m / units.micro).tolist(),
                        "fs": float(ef.get_sampling_rate()),
                    })
        payload["stations"].append(st)
    for sh in event.get_sim_showers():
        from nuradiomc_tpu_torch.framework.parameters import showerParameters as shp
        d = {"id": int(sh.get_id())}
        for p, key in ((shp.energy, "energy"), (shp.zenith, "zenith"),
                       (shp.azimuth, "azimuth"), (shp.type, "type")):
            try:
                if sh.has_parameter(p):
                    v = sh.get_parameter(p)
                    d[key] = v if isinstance(v, str) else float(v)
            except Exception:
                pass
        try:
            if sh.has_parameter(shp.vertex):
                d["vertex"] = [float(v) for v in sh.get_parameter(shp.vertex)]
        except Exception:
            pass
        payload["showers"].append(d)
    return payload


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>nuradiomc-tpu event browser</title>
<style>
body {font-family: sans-serif; margin: 0; background: #fafafa; color: #222}
#bar {background: #20313f; color: #eee; padding: 8px 14px; display: flex;
      gap: 14px; align-items: center}
#bar select {font-size: 14px}
.tab {cursor: pointer; padding: 4px 10px; border-radius: 4px}
.tab.active {background: #3c5a74}
#content {padding: 14px}
table {border-collapse: collapse; margin: 8px 0}
td, th {border: 1px solid #ccc; padding: 3px 9px; font-size: 13px}
canvas {background: #fff; border: 1px solid #ddd; margin: 4px}
h3 {margin: 10px 0 2px 0; font-size: 15px}
.ok {color: #0a7d2c; font-weight: bold} .no {color: #a00}
</style></head><body>
<div id="bar"><b>nuradiomc-tpu event browser</b>
<select id="evsel" onchange="render()"></select>
<span class="tab active" data-tab="overview" onclick="setTab(this)">Overview</span>
<span class="tab" data-tab="traces" onclick="setTab(this)">Traces</span>
<span class="tab" data-tab="simulation" onclick="setTab(this)">Simulation</span>
<span class="tab" data-tab="showers" onclick="setTab(this)">Showers</span>
</div>
<div id="content"></div>
<script>
const EVENTS = __EVENTS_JSON__;
let tab = "overview";
function setTab(el) {
  document.querySelectorAll(".tab").forEach(t => t.classList.remove("active"));
  el.classList.add("active"); tab = el.dataset.tab; render();
}
function lineplot(parent, ys, labels, title, w=560, h=170) {
  const c = document.createElement("canvas"); c.width = w; c.height = h;
  parent.appendChild(c);
  const g = c.getContext("2d");
  g.fillStyle = "#444"; g.font = "12px sans-serif"; g.fillText(title, 6, 12);
  let lo = Infinity, hi = -Infinity;
  ys.forEach(y => y.forEach(v => {lo = Math.min(lo, v); hi = Math.max(hi, v);}));
  if (!(hi > lo)) { hi = lo + 1; }
  const colors = ["#1965b0", "#dc050c", "#4eb265", "#f7a600"];
  ys.forEach((y, k) => {
    g.strokeStyle = colors[k % colors.length]; g.beginPath();
    y.forEach((v, i) => {
      const x = 8 + (w - 16) * i / (y.length - 1);
      const yy = h - 8 - (h - 30) * (v - lo) / (hi - lo);
      if (i === 0) g.moveTo(x, yy); else g.lineTo(x, yy);
    });
    g.stroke();
    if (labels[k]) { g.fillStyle = colors[k % colors.length];
      g.fillText(labels[k], w - 70, 14 + 13 * k); }
  });
  g.fillStyle = "#666";
  g.fillText(hi.toExponential(2), 6, 26); g.fillText(lo.toExponential(2), 6, h - 2);
}
function render() {
  const ev = EVENTS[document.getElementById("evsel").value];
  const el = document.getElementById("content"); el.innerHTML = "";
  if (tab === "overview") {
    ev.stations.forEach(st => {
      const d = document.createElement("div");
      d.innerHTML = `<h3>Station ${st.id} ` +
        (st.triggered ? `<span class=ok>TRIGGERED</span>` : `<span class=no>not triggered</span>`) + `</h3>`;
      let rows = st.triggers.map(t =>
        `<tr><td>${t.name}</td><td>${t.type}</td>` +
        `<td>${t.triggered ? "yes" : "no"}</td><td>${t.time == null ? "-" : t.time.toFixed(2) + " ns"}</td></tr>`).join("");
      d.innerHTML += `<table><tr><th>trigger</th><th>type</th><th>fired</th><th>time</th></tr>${rows}</table>`;
      const pk = Object.keys(st.params);
      if (pk.length) d.innerHTML += `<table>` + pk.map(k =>
        `<tr><td>${k}</td><td>${st.params[k].toPrecision(5)}</td></tr>`).join("") + `</table>`;
      d.innerHTML += `<p>${st.channels.length} channels, ${st.efields.length} sim efields</p>`;
      el.appendChild(d);
    });
  } else if (tab === "traces") {
    ev.stations.forEach(st => st.channels.forEach(ch => {
      const d = document.createElement("div"); el.appendChild(d);
      lineplot(d, [ch.trace_mV], [""], `station ${st.id} channel ${ch.id} - V(t) [mV], fs=${ch.fs} GHz`);
      lineplot(d, [ch.spec.map(v => Math.log10(v + 1e-30))], [""],
               `station ${st.id} channel ${ch.id} - log10 |V(f)|, 0..${ch.fmax_MHz} MHz`);
    }));
  } else if (tab === "simulation") {
    ev.stations.forEach(st => st.efields.forEach((ef, i) => {
      const d = document.createElement("div"); el.appendChild(d);
      lineplot(d, [ef.eTheta, ef.ePhi], ["eTheta", "ePhi"],
               `station ${st.id} sim efield ${i} (channels ${ef.channels}) [uV/m]`);
    }));
  } else {
    let rows = ev.showers.map(s => `<tr><td>${s.id}</td><td>${s.type || "-"}</td>` +
      `<td>${s.energy ? s.energy.toExponential(3) : "-"}</td>` +
      `<td>${s.zenith == null ? "-" : (s.zenith * 57.2958).toFixed(1)}</td>` +
      `<td>${s.azimuth == null ? "-" : (s.azimuth * 57.2958).toFixed(1)}</td>` +
      `<td>${s.vertex ? s.vertex.map(v => v.toFixed(1)).join(", ") : "-"}</td></tr>`).join("");
    el.innerHTML = `<table><tr><th>shower</th><th>type</th><th>energy [eV]</th>` +
      `<th>zenith [deg]</th><th>azimuth [deg]</th><th>vertex [m]</th></tr>${rows}</table>`;
  }
}
const sel = document.getElementById("evsel");
EVENTS.forEach((ev, i) => {
  const o = document.createElement("option"); o.value = i;
  o.text = `run ${ev.run} event ${ev.id}`; sel.appendChild(o);
});
render();
</script></body></html>
"""


def export_html(filename, out_dir, max_events=100):
    """Self-contained static-HTML event browser (no server, no Dash): one
    page with Overview / Traces / Simulation / Showers tabs — the capability
    of the reference Dash app's four tabs (eventbrowser/app.py +
    apps/{overview,traces,simulation,cosmic_rays}) as a file:// artifact."""
    import json

    os.makedirs(out_dir, exist_ok=True)
    reader = EventReader(filename)
    payloads = []
    for event in reader.get_events():
        payloads.append(_event_payload(event))
        if len(payloads) >= max_events:
            break
    reader.end()
    html = _HTML_TEMPLATE.replace("__EVENTS_JSON__", json.dumps(payloads))
    out = os.path.join(out_dir, "index.html")
    with open(out, "w") as f:
        f.write(html)
    print(f"wrote {out} ({len(payloads)} events)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="nuradiomc-tpu event viewer")
    ap.add_argument("filename")
    ap.add_argument("--event", type=int, default=None,
                    help="only plot this event id")
    ap.add_argument("--out", default=".", help="output directory for PNGs")
    ap.add_argument("--html", default=None, metavar="DIR",
                    help="export a self-contained HTML browser to DIR")
    ap.add_argument("--show", action="store_true")
    args = ap.parse_args(argv)

    if args.html is not None:
        export_html(args.filename, args.html)
        return

    reader = EventReader(args.filename)
    for event in reader.get_events():
        if args.event is not None and event.get_id() != args.event:
            continue
        plot_event(event, out_path=args.out, show=args.show)
    reader.end()


if __name__ == "__main__":
    main()
