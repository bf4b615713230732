from .config import CfgNode, load_cfg_from_cfg_file, merge_cfg_from_list, load_full_config
from .logger import Logger, get_log_file, make_log_dir
from .metrics import compute_confidence_interval
from .io import save_pickle, load_pickle

__all__ = [
    "CfgNode",
    "load_cfg_from_cfg_file",
    "merge_cfg_from_list",
    "load_full_config",
    "Logger",
    "get_log_file",
    "make_log_dir",
    "compute_confidence_interval",
    "save_pickle",
    "load_pickle",
]
