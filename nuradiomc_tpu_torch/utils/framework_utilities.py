# copied from nuradiomc_tpu/utils/framework_utilities.py:1-41 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""Helpers on the event data model
(NuRadioReco/utilities/framework_utilities.py:5-42)."""

from __future__ import annotations

import collections

import numpy as np

from nuradiomc_tpu_torch.framework.event import Event


def get_averaged_channel_parameter(event_or_station, key, channels_to_include=None):
    """Average of a channel parameter over the included channels; dict-valued
    parameters are averaged key-wise
    (framework_utilities.get_averaged_channel_parameter:5-42)."""
    if isinstance(event_or_station, Event):
        station = event_or_station.get_station()
    else:
        station = event_or_station

    params = None
    for channel in station.iter_channels(channels_to_include):
        if not channel.has_parameter(key):
            raise KeyError(f"Channel {channel.get_id()} has no parameter {key}.")
        param = channel.get_parameter(key)
        if isinstance(param, dict):
            if params is None:
                params = collections.defaultdict(list)
            for k, v in param.items():
                params[k].append(v)
        elif isinstance(param, (float, int, np.floating, np.integer)):
            if params is None:
                params = []
            params.append(param)
        else:
            raise ValueError(f"Unknown type ({type(param)}) for parameter {key}")

    if isinstance(params, dict):
        return {k: np.average(v) for k, v in params.items()}
    return np.average(params)
