"""Model registry of the port. Importing this package registers BERT,
GPT, the MNIST MLP, LeNet and the ResNets."""

from . import bert  # noqa: F401  (registers "bert", "bert_large", "bert_tiny")
from . import gpt  # noqa: F401  (registers "gpt" and "gpt_tiny")
from . import lenet  # noqa: F401  (registers "lenet")
from . import mlp  # noqa: F401  (registers "mlp")
from . import resnet  # noqa: F401  (registers "resnet20" and "resnet50")
from .base import get_model, list_models, register_model

__all__ = ["get_model", "list_models", "register_model"]
