from .em_dirichlet import EM_DIRICHLET
from .hard_em_dirichlet import HARD_EM_DIRICHLET

__all__ = ["EM_DIRICHLET", "HARD_EM_DIRICHLET"]
