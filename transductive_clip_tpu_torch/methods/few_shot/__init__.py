from .em_dirichlet import EM_DIRICHLET
from .hard_em_dirichlet import HARD_EM_DIRICHLET
from .paddle import PADDLE
from .bdcspn import BDCSPN
from .laplacian_shot import LAPLACIAN_SHOT
from .tim import ALPHA_TIM, TIM_GD

__all__ = [
    "EM_DIRICHLET",
    "HARD_EM_DIRICHLET",
    "PADDLE",
    "BDCSPN",
    "LAPLACIAN_SHOT",
    "ALPHA_TIM",
    "TIM_GD",
]
