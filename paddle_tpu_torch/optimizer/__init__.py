"""Optimizers of the port: the reference's rules, their stateful API and
functional bridge (`optimizer`), and the learning-rate schedulers
(`lr`)."""
from . import lr  # noqa: F401
from .optimizer import (  # noqa: F401
    SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, L1Decay, L2Decay, Lamb,
    Lars, Momentum, Optimizer, RMSProp,
)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "L1Decay",
           "L2Decay"]
