"""Model registry of the port. Importing this package registers GPT and
the MNIST MLP."""

from . import gpt  # noqa: F401  (registers "gpt" and "gpt_tiny")
from . import mlp  # noqa: F401  (registers "mlp")
from .base import get_model, list_models, register_model

__all__ = ["get_model", "list_models", "register_model"]
