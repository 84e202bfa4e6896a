"""Neural-network programs and layers of the port: `decode` (the paged
decoder), `layer` (the Paddle layers BERT and the seq2seq Transformer
are built from, the batch norms) and `clip` (gradient clipping)."""
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.norm import (BatchNorm1D, BatchNorm2D,  # noqa: F401
                         BatchNorm3D, LayerNorm, SyncBatchNorm)
from . import clip  # noqa: F401,E402
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer.transformer import (MultiHeadAttention,  # noqa: F401
                                Transformer, TransformerDecoder,
                                TransformerDecoderLayer, TransformerEncoder,
                                TransformerEncoderLayer,
                                set_dropout_generator)

__all__ = ["Dropout", "Embedding", "Linear", "set_dropout_generator",
           "LayerNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer", "TransformerDecoder",
           "TransformerDecoderLayer", "Transformer", "clip",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
