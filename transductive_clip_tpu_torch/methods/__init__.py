from .registry import get_zero_shot_method, ZERO_SHOT_METHODS

__all__ = ["get_zero_shot_method", "ZERO_SHOT_METHODS"]
