"""Model code: shared layers, the four families and their registry."""
from .config import ModelConfig
from .registry import build, get_family

__all__ = ["ModelConfig", "build", "get_family"]
