from .em_dirichlet import EM_DIRICHLET
from .hard_em_dirichlet import HARD_EM_DIRICHLET
from .soft_kmeans import SOFT_KMEANS
from .hard_kmeans import HARD_KMEANS
from .kl_kmeans import KL_KMEANS
from .em_gaussian import EM_GAUSSIAN
from .em_gaussian_cov import EM_GAUSSIAN_COV
from .inductive_clip import CLIP

__all__ = [
    "EM_DIRICHLET",
    "HARD_EM_DIRICHLET",
    "SOFT_KMEANS",
    "HARD_KMEANS",
    "KL_KMEANS",
    "EM_GAUSSIAN",
    "EM_GAUSSIAN_COV",
    "CLIP",
]
