# copied from nuradiomc_tpu/utils/logging.py:1-44 (the port keeps its own copy; it imports
# nothing of the JAX package)
"""Logging utilities: the STATUS level + logger setup.

Re-implementation of NuRadioReco/utilities/logging.py: a custom STATUS log
level (25, between INFO and WARNING) used for production progress messages,
a Logger subclass exposing ``.status(...)``, and a ``setup_logger`` helper
that installs the class and a formatted stream handler.
"""

from __future__ import annotations

import logging

LOGGING_STATUS = 25


class NuRadioLogger(logging.Logger):
    """Logger with a STATUS level (utilities/logging.py:6-20)."""

    def __init__(self, name):
        super().__init__(name)
        logging.addLevelName(LOGGING_STATUS, "STATUS")

    def status(self, message, *args, **kwargs):
        if self.isEnabledFor(LOGGING_STATUS):
            self._log(LOGGING_STATUS, message, args, **kwargs)


def setup_logger(name: str = "nuradiomc_tpu_torch", level=LOGGING_STATUS):
    """Install NuRadioLogger as the logger class and return a configured
    logger with a formatted stream handler (the reference's set_general_
    log_level + get_logger pattern)."""
    previous = logging.getLoggerClass()
    logging.setLoggerClass(NuRadioLogger)
    try:
        logger = logging.getLogger(name)
    finally:
        logging.setLoggerClass(previous)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(levelname)s - %(asctime)s - %(name)s - %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger
