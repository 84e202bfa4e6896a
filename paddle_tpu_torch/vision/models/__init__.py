"""The vision model zoo (ref: python/paddle/vision/models/): the port of
`paddle_tpu/vision/models/`. Parameters are made on the default device
(the card unless the caller asks for the CPU)."""
from __future__ import annotations

from .lenet import LeNet  # noqa: F401
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401

from . import mobilenet as mobilenetv1  # noqa: E402,F401
from . import mobilenet as mobilenetv2  # noqa: E402,F401
