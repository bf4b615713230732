from .registry import (
    FEW_SHOT_METHODS,
    ZERO_SHOT_METHODS,
    get_few_shot_method,
    get_zero_shot_method,
)

__all__ = ["get_zero_shot_method", "get_few_shot_method",
           "ZERO_SHOT_METHODS", "FEW_SHOT_METHODS"]
