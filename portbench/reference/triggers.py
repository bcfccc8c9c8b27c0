# frozen copy of nuradiomc_tpu_torch/ops/triggers.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
"""Trigger bins with majority logic (torch).

Counterpart of ``nuradiomc_tpu/ops/triggers.py`` (reference
modules/trigger/highLowThreshold.py:13-142, simpleThreshold.py:14-31,
envelopeTrigger.py, multiHighLowThreshold.py:24-58, powerIntegration.py and
the ARA tunnel diode, utilities/diodeSimulator.py): strict ``>=``/``<=``
comparisons, sliding windows with left zero padding so a trigger bin sits at
the last sample of its window, and the first triggered bin by argmax (0 when
nothing fired). All functions act on the last (time) axis.
"""

from __future__ import annotations


import torch


def _sliding_window_any(x: torch.Tensor, window: int) -> torch.Tensor:
    """out[i] = any(x[max(0, i-window+1) .. i]), as a prefix count:
    P[i] - P[i-window] > 0 with zeros to the left."""
    p = torch.cumsum(x.to(torch.int32), dim=-1)
    shifted = torch.zeros_like(p)
    if window < p.shape[-1]:
        shifted[..., window:] = p[..., :-window]
    return (p - shifted) > 0


# AraSim tunnel-diode response parameters (utilities/diodeSimulator.py:38-45)
_TD_DOWN1 = (-0.8, 15.0, 2.3)      # (amp, mu [ns], sigma [ns])
_TD_DOWN2 = (-0.2, 15.0, 4.0)
_TD_UP_MU, _TD_UP_SIGMA = 18.0, 7.0
