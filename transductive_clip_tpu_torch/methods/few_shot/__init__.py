from .em_dirichlet import EM_DIRICHLET
from .hard_em_dirichlet import HARD_EM_DIRICHLET
from .tim import ALPHA_TIM, TIM_GD

__all__ = ["EM_DIRICHLET", "HARD_EM_DIRICHLET", "ALPHA_TIM", "TIM_GD"]
