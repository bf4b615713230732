from .zero_shot import EvaluatorZeroShot

__all__ = ["EvaluatorZeroShot"]
