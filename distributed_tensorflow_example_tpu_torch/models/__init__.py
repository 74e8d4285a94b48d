"""Model registry of the port. Importing this package registers GPT."""

from . import gpt  # noqa: F401  (registers "gpt" and "gpt_tiny")
from .base import get_model, list_models, register_model

__all__ = ["get_model", "list_models", "register_model"]
