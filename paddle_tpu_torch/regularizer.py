"""paddle.regularizer: the coupled weight-decay regularizers the
optimizers read (a parameter's `regularizer`, or an optimizer's
`weight_decay`) — `L2Decay` adds coeff · p to the gradient, `L1Decay`
coeff · sign(p)."""
from __future__ import annotations


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L2Decay(WeightDecayRegularizer):
    """Coupled L2 regularization: g + coeff * p."""


class L1Decay(WeightDecayRegularizer):
    """Coupled L1 regularization: g + coeff * sign(p)."""


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay

__all__ = ["WeightDecayRegularizer", "L2Decay", "L1Decay",
           "L2DecayRegularizer", "L1DecayRegularizer"]
