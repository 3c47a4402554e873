from .loader import Config

__all__ = ["Config"]
