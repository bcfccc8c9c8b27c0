# copied from nuradiomc_tpu/utils/templates.py:1-117 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""Template provider for correlation modules
(NuRadioReco/utilities/templates.py:7-163).

Serves cosmic-ray / neutrino voltage templates from per-station pickle files
``templates_cr_station_<id>.pickle`` / ``templates_nu_station_<id>.pickle``
with the reference's nesting:

* cr: list over CoREAS pulses -> {zenith: {azimuth: {channel: trace}}}
* nu: {zenith: {azimuth: {dCherenkov: {channel: trace}}}}

Reference directions: cr (60 deg, 0 deg); nu (140 deg, 45 deg, on-cone).
Unlike the reference this provider is not a process-wide singleton — every
instance owns its cache (the reference's ``__new__`` singleton made its
``set_template_directory`` a global side effect).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

# station -> CR-sensitive channel (templates.py:52-58 hardcoded table)
_CR_CHANNEL = {51: 4, 52: 4, 32: 1, 61: 5}


class Templates:
    def __init__(self, path):
        self._path = path
        self._cr = {}
        self._nu = {}

    def set_template_directory(self, path):
        self._path = path

    # -- loading -------------------------------------------------------------

    def _load(self, kind, station_id):
        cache = self._cr if kind == "cr" else self._nu
        if station_id not in cache:
            path = os.path.join(self._path,
                                f"templates_{kind}_station_{station_id}.pickle")
            if not os.path.exists(path):
                raise IOError(f"template file {path} not found")
            with open(path, "rb") as f:
                cache[station_id] = pickle.load(f)
        return cache[station_id]

    # -- cosmic ray ----------------------------------------------------------

    def get_cr_ref_templates(self, station_id):
        """One CR template per channel for the (60 deg, 0 deg) reference
        direction (templates.py:38-45)."""
        data = self._load("cr", station_id)
        return data[0][np.deg2rad(60)][np.deg2rad(0)]

    def get_cr_ref_template(self, station_id):
        """One CR template (the station's CR-sensitive channel,
        templates.py:47-63)."""
        channel = _CR_CHANNEL.get(station_id)
        if channel is None:
            raise ValueError(
                f"no CR-sensitive channel known for station {station_id}; "
                "use get_cr_ref_templates() and pick a channel")
        return self.get_cr_ref_templates(station_id)[channel]

    def get_set_of_cr_templates_full(self, station_id, n=100):
        """Flat set of up to n CR templates over all pulses/directions
        (templates.py:65-87)."""
        data = self._load("cr", station_id)
        out = {}
        for templates in data:
            for zen_templates in templates.values():
                for template in zen_templates.values():
                    out[len(out)] = template
                    if len(out) >= n:
                        return out
        return out

    def get_set_of_cr_templates(self, station_id, n=100):
        """Up to n CR templates looping pulses within (zen, az) in the
        reference's order (templates.py:89-112)."""
        data = self._load("cr", station_id)
        out = {}
        for zen in np.deg2rad([60, 50, 70]):
            for az in np.deg2rad([0, 22.5, 45]):
                for templates in data:
                    out[len(out)] = templates[zen][az]
                    if len(out) >= n:
                        return out
        return out

    # -- neutrino ------------------------------------------------------------

    def get_nu_ref_templates(self, station_id):
        """One nu template per channel, reference direction, on-cone
        (templates.py:151-157)."""
        data = self._load("nu", station_id)
        return data[np.deg2rad(140)][np.deg2rad(45)][0.0]

    def get_nu_ref_template(self, station_id):
        """One nu template (channel 0, templates.py:159-163)."""
        return self.get_nu_ref_templates(station_id)[0]

    def get_set_of_nu_templates(self, station_id, n=100):
        """Up to n nu templates over (zen, az, dCherenkov)
        (templates.py:114-139)."""
        data = self._load("nu", station_id)
        out = {}
        for zen in np.deg2rad([100, 120, 140]):
            for az in np.deg2rad([0, 22.5, 45]):
                for dCh in np.deg2rad([0, -0.5, -1, -1.5, -2, -3, -4, -5]):
                    out[len(out)] = data[zen][az][dCh]
                    if len(out) >= n:
                        return out
        return out
