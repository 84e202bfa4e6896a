"""Neural-network programs and layers of the port: `decode` (the paged
decoder) and `layer` (the Paddle layers BERT is built from)."""
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.norm import LayerNorm  # noqa: F401
from .layer.transformer import (MultiHeadAttention,  # noqa: F401
                                TransformerEncoder, TransformerEncoderLayer,
                                set_dropout_generator)

__all__ = ["Dropout", "Embedding", "Linear", "set_dropout_generator",
           "LayerNorm", "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
