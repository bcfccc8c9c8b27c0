"""Per-ray-solution amplitude after the antenna response (torch).

Counterpart of ``nuradiomc_tpu/reco/custom_deltaT.py``
(NuRadioReco/modules/custom/deltaT/calculateAmplitudePerRaySolution.py:13-86):
each simulated efield (one per ray-tracing solution) is folded with the
antenna response of every channel it maps to, all of its channels in one
batch on the module's device, and the max |V| and the max Hilbert-envelope
amplitude per (efield, channel) are stored.
"""

from __future__ import annotations

import numpy as np
import torch

from nuradiomc_tpu_torch.framework import parameters as par
from nuradiomc_tpu_torch.ops.trace import hilbert_envelope
from nuradiomc_tpu_torch.reco.base import Module, host, register_run, spectrum_tensor
from nuradiomc_tpu_torch.reco.efield_converters import get_channel_vel
from nuradiomc_tpu_torch.utils import fft as fft_utils
from nuradiomc_tpu_torch.utils import units

efp = par.electricFieldParameters


class calculateAmplitudePerRaySolution(Module):
    """Max signal amplitude per ray solution after the antenna
    (calculateAmplitudePerRaySolution.py:13-86)."""

    def begin(self, debug=False, antenna_replacements=None):
        self._antenna_replacements = antenna_replacements

    @register_run()
    def run(self, evt, station, det):
        sim_station = station.get_sim_station()
        sim_station_id = sim_station.get_id()

        for efield in sim_station.get_electric_fields():
            channel_ids = list(efield.get_channel_ids())
            if not channel_ids:
                continue
            zenith = efield[efp.zenith]
            azimuth = efield[efp.azimuth]
            ff = np.asarray(efield.get_frequencies())
            efield_fft = spectrum_tensor(efield, self.device)
            vt, vp = (torch.stack(v) for v in zip(*(
                get_channel_vel(det, sim_station_id, cid, ff, zenith, azimuth,
                                antenna_replacements=self._antenna_replacements,
                                device=self.device)
                for cid in channel_ids)))

            # apply antenna response, remove the DC band (<5 MHz)
            voltage_fft = efield_fft[2] * vp + efield_fft[1] * vt
            voltage_fft = torch.where(self.tensor(ff < 5 * units.MHz), 0.0, voltage_fft)
            voltage = fft_utils.freq2time(voltage_fft, efield.get_sampling_rate())
            max_amp = host(torch.abs(voltage).amax(-1))
            max_env = host(hilbert_envelope(voltage).amax(-1))

            if not efield.has_parameter(efp.max_amp_antenna):
                efield[efp.max_amp_antenna] = {}
                efield[efp.max_amp_antenna_envelope] = {}
            for cid, amp, env in zip(channel_ids, max_amp, max_env):
                efield[efp.max_amp_antenna][cid] = float(amp)
                efield[efp.max_amp_antenna_envelope][cid] = float(env)
