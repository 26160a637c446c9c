from . import vision

__all__ = ["vision"]
