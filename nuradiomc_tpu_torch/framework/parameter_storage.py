# copied from nuradiomc_tpu/framework/parameter_storage.py:1-47 (the port keeps its own copy; it imports nothing of the JAX package)
"""Enum-keyed parameter storage (NuRadioReco/framework/parameter_storage.py:17-146)."""

from __future__ import annotations


class ParameterStorage:
    """Mixin holding enum-keyed parameters and covariances."""

    def __init__(self, parameter_types=()):
        self._parameters = {}
        self._parameter_covariances = {}
        self._parameter_types = tuple(parameter_types)

    def __setitem__(self, key, value):
        self.set_parameter(key, value)

    def __getitem__(self, key):
        return self.get_parameter(key)

    def _check_key(self, key):
        if self._parameter_types and not isinstance(key, self._parameter_types):
            raise ValueError(
                f"parameter key {key!r} must be one of {self._parameter_types}")

    def set_parameter(self, key, value):
        self._check_key(key)
        self._parameters[key] = value

    def get_parameter(self, key):
        self._check_key(key)
        return self._parameters[key]

    def has_parameter(self, key) -> bool:
        return key in self._parameters

    def get_parameters(self):
        return dict(self._parameters)

    def set_parameter_error(self, key, covariance):
        self._check_key(key)
        self._parameter_covariances[key] = covariance

    def get_parameter_error(self, key):
        return self._parameter_covariances[key]

    def remove_parameter(self, key):
        self._parameters.pop(key, None)
