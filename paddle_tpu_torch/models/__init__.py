"""Models of the port: GPT-2 (serving and training) and BERT / ERNIE
(pretraining)."""
from .bert import Bert, BertConfig, Ernie, ErnieConfig  # noqa: F401
from .gpt2 import (GPT2, GPT2Config, build_train_step,  # noqa: F401
                   from_reference_params)

__all__ = ["GPT2", "GPT2Config", "build_train_step", "from_reference_params",
           "Bert", "BertConfig", "Ernie", "ErnieConfig"]
