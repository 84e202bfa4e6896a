"""ref: python/paddle/dataset/image.py — numpy image transforms used by
the 1.x readers (no cv2 dependency here; pure-numpy equivalents)."""
from __future__ import annotations

import numpy as np

__all__ = [
    "load_image", "resize_short", "to_chw", "center_crop", "random_crop",
    "left_right_flip", "simple_transform", "load_and_transform",
]


def load_image(file_path, is_color=True):
    from ..vision.datasets import _load_image
    img = _load_image(file_path)
    if not is_color and img.ndim == 3:
        img = img.mean(axis=-1, keepdims=True)
    return img


def _resize(img, h, w):
    """Nearest-neighbor resize (HWC uint8/float)."""
    ih, iw = img.shape[:2]
    ys = (np.arange(h) * ih / h).astype(np.int32)
    xs = (np.arange(w) * iw / w).astype(np.int32)
    return img[ys][:, xs]


def resize_short(im, size):
    h, w = im.shape[:2]
    if h < w:
        return _resize(im, size, int(w * size / h))
    return _resize(im, int(h * size / w), size)


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    y0 = max(0, (h - size) // 2)
    x0 = max(0, (w - size) // 2)
    return im[y0:y0 + size, x0:x0 + size]


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    y0 = np.random.randint(0, max(1, h - size + 1))
    x0 = np.random.randint(0, max(1, w - size + 1))
    return im[y0:y0 + size, x0:x0 + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    if im.ndim == 2:
        im = im[:, :, None]
    im = to_chw(im).astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        im -= mean if mean.ndim >= 2 else mean[:, None, None]
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)
