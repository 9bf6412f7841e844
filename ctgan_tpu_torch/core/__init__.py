"""Parameter store and randomness provider."""

from .rng import Randomness
from .store import ParamInit, param_count, split_params

__all__ = ["ParamInit", "Randomness", "param_count", "split_params"]
