from . import clip

__all__ = ["clip"]
