from .daemon import Manager

__all__ = ["Manager"]
