"""The device an entry point runs on.

Every entry point of the port (``Simulation``, ``convert.from_jax``,
``convert.make_*_inputs``) takes ``device="cuda"`` by default: the port is
written for the card, and the CPU runs only when a caller asks for it with
``device="cpu"`` (the tests do). Without a card, the default raises instead
of carrying on on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when no
    card is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for (the default) but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
