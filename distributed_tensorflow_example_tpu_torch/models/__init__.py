"""Model registry of the port. Importing this package registers BERT,
MoE-BERT, GPT, the MNIST MLP, LeNet, the ResNets and the pipeline models
(pipe_mlp, pipe_bert, pipe_moe_bert)."""

from . import bert  # noqa: F401  (registers "bert", "bert_large", "bert_tiny")
from . import gpt  # noqa: F401  (registers "gpt" and "gpt_tiny")
from . import lenet  # noqa: F401  (registers "lenet")
from . import mlp  # noqa: F401  (registers "mlp")
from . import moe  # noqa: F401  (registers "moe_bert" and "moe_bert_tiny")
from . import pipe_bert  # noqa: F401  ("pipe_bert", "pipe_bert_tiny")
from . import pipe_mlp  # noqa: F401  (registers "pipe_mlp")
from . import pipe_moe  # noqa: F401  ("pipe_moe_bert", "pipe_moe_bert_tiny")
from . import resnet  # noqa: F401  (registers "resnet20" and "resnet50")
from .base import get_model, list_models, register_model

__all__ = ["get_model", "list_models", "register_model"]
