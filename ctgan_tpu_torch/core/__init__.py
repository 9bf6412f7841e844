"""Parameter store, precision policy and randomness provider."""

from .precision import compute_dtype, default_policy, precision_policy
from .rng import Randomness
from .store import ParamInit, format_param_table, param_count, print_model_settings, split_params

__all__ = [
    "ParamInit", "Randomness", "compute_dtype", "default_policy", "format_param_table",
    "param_count", "precision_policy", "print_model_settings", "split_params",
]
