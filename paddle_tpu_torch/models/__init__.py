"""Models of the port: GPT-2 (serving, offline generation and its
exported generator, training), BERT / ERNIE
(pretraining) and the seq2seq Transformer (training, greedy and beam
decoding)."""
from .bert import Bert, BertConfig, Ernie, ErnieConfig  # noqa: F401
from .gpt2 import (GPT2, GPT2Config, build_train_step,  # noqa: F401
                   export_generator, from_reference_params,
                   quantized_params_from_reference)
from .transformer import (TransformerConfig, TransformerModel,  # noqa: F401
                          sinusoid_position_encoding)

__all__ = ["GPT2", "GPT2Config", "build_train_step", "export_generator",
           "from_reference_params",
           "quantized_params_from_reference",
           "Bert", "BertConfig", "Ernie", "ErnieConfig",
           "TransformerConfig", "TransformerModel",
           "sinusoid_position_encoding"]
