"""`paddle.nn` of the port: the `Layer` base and containers, the common
layers, activations, convolutions, pools, losses, norms, recurrent
layers and the Transformer (`layer`), `functional`, `initializer`,
`utils` (weight norm), `clip` (gradient clipping), `decode` (the
paged decoder of the serving path), and the fluid-era layer classes
with the beam-search decoder (`layer.legacy`)."""
import sys

import torch

from . import clip  # noqa: F401
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, GradientClipByGlobalNorm,
                   GradientClipByNorm, GradientClipByValue)
from .layer.activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign, Swish, Tanh,
    Tanhshrink, ThresholdedReLU,
)
from .layer.common import (  # noqa: F401
    AlphaDropout, Bilinear, CosineSimilarity, Dropout, Dropout2D, Dropout3D,
    Embedding, Flatten, Identity, Linear, Pad1D, Pad2D, Pad3D,
    PairwiseDistance, PixelShuffle, PixelUnshuffle, Unflatten, Unfold,
    Upsample, UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D,
)
from .layer.conv import (  # noqa: F401
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D, Conv3DTranspose,
)
from .layer.layers import (Layer, LayerList, ParameterList,  # noqa: F401
                           Sequential)
from .layer.loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    CTCLoss, KLDivLoss, L1Loss, MarginRankingLoss, MSELoss, NLLLoss,
    SmoothL1Loss, TripletMarginLoss,
)
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, RMSNorm, SpectralNorm, SyncBatchNorm,
)
from .layer.pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AvgPool1D, AvgPool2D, AvgPool3D,
    MaxPool1D, MaxPool2D, MaxPool3D,
)
from .layer.rnn import (GRU, LSTM, RNN, BiRNN, GRUCell,  # noqa: F401
                        LSTMCell, RNNCellBase, SimpleRNN, SimpleRNNCell)
from .layer.transformer import (MultiHeadAttention,  # noqa: F401
                                Transformer, TransformerDecoder,
                                TransformerDecoderLayer, TransformerEncoder,
                                TransformerEncoderLayer,
                                set_dropout_generator)
from . import utils  # noqa: F401,E402
# the fluid 1.x layer classes and decoding the 2.0 nn namespace keeps
from .layer.legacy import (  # noqa: F401,E402
    AdaptiveMaxPool3D, BeamSearchDecoder, BilinearTensorProduct, Decoder,
    DynamicRNN, HSigmoidLoss, NCELoss, Pool2D, RowConv, StaticRNN, TreeConv,
    ctc_greedy_decoder, dynamic_decode,
)
from ..ops.control import cond, while_loop  # noqa: F401,E402
from .functional.legacy import crf_decoding  # noqa: F401,E402


def clip_by_norm(x, max_norm, name=None):
    """x scaled down to L2 norm `max_norm` when its norm exceeds it (the
    reference's `nn.clip_by_norm`)."""
    n = torch.sqrt(torch.sum(x * x))
    return torch.where(n > max_norm, x * (max_norm / n), x)


def set_gradient_clip(clip, param_list=None, program=None):
    """Record a default gradient clip on `nn.clip`, as the reference's
    `nn.set_gradient_clip` does."""
    from . import clip as clip_mod
    clip_mod._default_grad_clip = clip


# the reference's topic submodules of nn are aliases of nn itself
_self = sys.modules[__name__]
common = conv = extension = loss = norm = pooling = rnn = vision = \
    weight_norm_hook = _self

def Input(shape=None, dtype="float32", name=None):
    """A feed placeholder of the current static Program (`static.data`)."""
    from ..static import data
    return data(name or "input", shape, dtype)


__all__ = [
    "clip", "functional", "initializer", "utils", "ClipGradByGlobalNorm",
    "ClipGradByNorm", "ClipGradByValue", "CELU", "ELU", "GELU", "GLU",
    "SELU", "Hardshrink", "Hardsigmoid", "Hardswish", "Hardtanh",
    "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout", "Mish", "PReLU",
    "ReLU", "ReLU6", "Sigmoid", "Silu", "Softmax", "Softplus", "Softshrink",
    "Softsign", "Swish", "Tanh", "Tanhshrink", "ThresholdedReLU",
    "AlphaDropout", "Bilinear", "CosineSimilarity", "Dropout", "Dropout2D",
    "Dropout3D", "Embedding", "Flatten", "Identity", "Linear", "Pad1D",
    "Pad2D", "Pad3D", "PairwiseDistance", "PixelShuffle", "PixelUnshuffle",
    "Unflatten", "Unfold", "Upsample", "UpsamplingBilinear2D",
    "UpsamplingNearest2D", "ZeroPad2D", "Conv1D", "Conv1DTranspose",
    "Conv2D", "Conv2DTranspose", "Conv3D", "Conv3DTranspose", "Layer",
    "LayerList", "ParameterList", "Sequential", "BCELoss",
    "BCEWithLogitsLoss", "CosineEmbeddingLoss", "CrossEntropyLoss",
    "CTCLoss", "KLDivLoss", "L1Loss", "MarginRankingLoss", "MSELoss",
    "NLLLoss", "SmoothL1Loss", "TripletMarginLoss", "BatchNorm",
    "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "GroupNorm",
    "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D", "LayerNorm",
    "LocalResponseNorm", "RMSNorm", "SpectralNorm", "SyncBatchNorm",
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
    "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AvgPool1D", "AvgPool2D",
    "AvgPool3D", "MaxPool1D", "MaxPool2D", "MaxPool3D", "GRU", "LSTM",
    "RNN", "BiRNN", "GRUCell", "LSTMCell", "RNNCellBase", "SimpleRNN",
    "SimpleRNNCell", "MultiHeadAttention", "Transformer",
    "TransformerDecoder", "TransformerDecoderLayer", "TransformerEncoder",
    "TransformerEncoderLayer", "set_dropout_generator", "AdaptiveMaxPool3D",
    "BeamSearchDecoder", "BilinearTensorProduct", "Decoder", "DynamicRNN",
    "HSigmoidLoss", "NCELoss", "Pool2D", "RowConv", "StaticRNN", "TreeConv",
    "ctc_greedy_decoder", "dynamic_decode", "cond", "while_loop",
    "GradientClipByValue", "GradientClipByNorm", "GradientClipByGlobalNorm",
    "crf_decoding", "clip_by_norm", "set_gradient_clip", "Input"]
