from .few_shot import EvaluatorFewShot
from .zero_shot import EvaluatorZeroShot

__all__ = ["EvaluatorFewShot", "EvaluatorZeroShot"]
