from .cache import (
    softmax_cache_path,
    visual_cache_path,
    load_feature_cache,
    save_feature_cache,
)

__all__ = [
    "softmax_cache_path",
    "visual_cache_path",
    "load_feature_cache",
    "save_feature_cache",
]
