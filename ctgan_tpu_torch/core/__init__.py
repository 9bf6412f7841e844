"""Parameter store and randomness provider."""

from .rng import Randomness
from .store import ParamInit, format_param_table, param_count, print_model_settings, split_params

__all__ = [
    "ParamInit", "Randomness", "format_param_table", "param_count", "print_model_settings",
    "split_params",
]
