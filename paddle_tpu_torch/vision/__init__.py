"""paddle.vision (ref: python/paddle/vision/): the port of
`paddle_tpu/vision/` — the model zoo (`models`), the box and RoI ops
(`ops`), the numpy transforms (`transforms`) and the datasets
(`datasets`), with the reference's top-level names."""
from __future__ import annotations

from . import datasets, models, ops, transforms  # noqa: F401
from .models import LeNet, MobileNetV1, MobileNetV2, ResNet, VGG  # noqa: F401
from .models import (  # noqa: F401
    mobilenet_v1, mobilenet_v2, resnet18, resnet34, resnet50, resnet101,
    resnet152, vgg11, vgg13, vgg16, vgg19,
)
from .datasets import (  # noqa: F401
    Cifar10, Cifar100, DatasetFolder, FashionMNIST, Flowers, ImageFolder,
    MNIST, VOC2012)
from .transforms import (  # noqa: F401
    BaseTransform, BrightnessTransform, CenterCrop, ColorJitter, Compose,
    ContrastTransform, Grayscale, HueTransform, Normalize, Pad, RandomCrop,
    RandomHorizontalFlip, RandomResizedCrop, RandomRotation,
    RandomVerticalFlip, Resize, SaturationTransform, ToTensor, Transpose,
    adjust_brightness, adjust_contrast, adjust_hue, center_crop, crop,
    hflip, normalize, pad, resize, rotate, to_grayscale, to_tensor, vflip)


def set_image_backend(backend):
    if backend not in ("pil", "cv2", "numpy", "tensor"):
        raise ValueError(f"unsupported image backend {backend!r}")


def get_image_backend():
    return "numpy"


def image_load(path, backend=None):
    """An image file as an HWC numpy array (.npy loaded as it is; other
    files decoded by PIL to RGB)."""
    import numpy as np
    if str(path).endswith(".npy"):
        return np.load(path)
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


import sys as _sys  # noqa: E402

image = _sys.modules[__name__]  # the reference's vision.image path
