# frozen copy of nuradiomc_tpu_torch/ops/phased_array.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
"""Phased-array (beamformed) power trigger (torch).

Counterpart of ``nuradiomc_tpu/ops/phased_array.py:31-105`` (reference
NuRadioReco/modules/phasedarray/phasedArrayBase.py): integer beam delays
from antenna depths and cable delays (host numpy, copied), coherent beam
sums by static rolls, sliding power sums at ``step`` intervals, the
power-integration trigger of the RNO-G / Gen2 deep arrays and the
beamformed envelope trigger.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.constants import speed_of_light

main_low_angle = np.deg2rad(-55.0)
main_high_angle = -main_low_angle
default_angles = np.arcsin(np.linspace(np.sin(main_low_angle),
                                       np.sin(main_high_angle), 11))


# copied from nuradiomc_tpu/ops/phased_array.py:31 (host numpy)
def beam_rolls(ant_z, cable_delays, phasing_angles, ref_index,
               sampling_frequency, group_delays=None) -> np.ndarray:
    """Integer roll (sample delay) per (beam, channel); host-side numpy.

    Mirrors calculate_time_delays (phasedArrayBase.py:58-124):
    delays = (z - z_ref)/c * n_ref * sin(angle) - cable - group, shifted to
    min zero, rounded to samples.
    """
    ant_z = np.asarray(ant_z, dtype=float)
    cable_delays = np.asarray(cable_delays, dtype=float)
    group_delays = np.zeros_like(ant_z) if group_delays is None else np.asarray(group_delays)
    ref_z = np.max(ant_z)
    rolls = np.zeros((len(phasing_angles), len(ant_z)), dtype=int)
    for b, angle in enumerate(np.asarray(phasing_angles)):
        delays = ((ant_z - ref_z) / speed_of_light * ref_index * np.sin(angle)
                  - cable_delays - group_delays)
        delays -= np.min(delays)
        rolls[b] = np.round(delays * sampling_frequency).astype(int)
    return rolls


def phase_signals(traces, rolls):
    """Coherent beam sums (phase_signals:183-215): traces [..., C, N],
    static (B, C) integer rolls -> [..., B, N]."""
    rolls = np.asarray(rolls, dtype=int)
    beams = []
    for b in range(rolls.shape[0]):
        acc = 0.0
        for c in range(rolls.shape[1]):
            acc = acc + torch.roll(traces[..., c, :], int(rolls[b, c]), dims=-1)
        beams.append(acc)
    return torch.stack(beams, dim=-2)


def power_sum(coh_sum, window: int, step: int, averaging_divisor=None):
    """Sliding power sums over ``window`` ticks at ``step`` intervals
    (power_sum:217-271), as a cumsum difference: [..., N] -> [..., frames]."""
    if averaging_divisor is None:
        averaging_divisor = window
    n = coh_sum.shape[-1]
    num_frames = int(np.floor((n - window) / step))
    c = torch.nn.functional.pad(torch.cumsum(coh_sum * coh_sum, dim=-1), (1, 0))
    starts = torch.arange(num_frames, device=coh_sum.device) * step
    power = c[..., starts + window] - c[..., starts]
    return power / averaging_divisor, num_frames


def phased_power_trigger(traces, rolls, threshold, window: int = 32, step: int = 16,
                         averaging_divisor=None):
    """Power-integration phased trigger (phased_trigger, mode='power_sum'),
    traces [..., C, N]. Returns (triggered [...], first frame above threshold
    [...] (0 if none), maximum windowed power [...], triggered beams [..., B])."""
    beams = phase_signals(traces, rolls)                          # [..., B, N]
    power, _ = power_sum(beams, window, step, averaging_divisor)
    above = power > threshold                                     # [..., B, F]
    any_beam = torch.any(above, dim=-2)                           # [..., F]
    triggered = torch.any(any_beam, dim=-1)
    frame = torch.argmax(any_beam.to(torch.int8), dim=-1)
    return triggered, frame, torch.amax(power, dim=(-2, -1)), torch.any(above, dim=-1)
