"""Vision transforms (ref: python/paddle/vision/transforms/): the port of
`paddle_tpu/vision/transforms/__init__.py`.

Host-side numpy transforms (CHW / HWC aware) with the reference's draws
from Python's `random` and numpy, so a seeded pipeline gives the
reference's arrays bit for bit; images are numpy arrays (HWC uint8 or
float). `ToTensor` / `to_tensor` return a CPU `torch.Tensor` (float32,
CHW unless asked for HWC): the DataLoader moves batches to the card."""
from __future__ import annotations

import numbers
import random

import numpy as np
import torch


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, img):
        return self._apply_image(img)


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.data_format == "CHW":
            arr = np.transpose(arr, (2, 0, 1))
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32))


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m = self.mean
            s = self.std
        return (arr - m) / s


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        arr = np.asarray(img)
        hwc = arr.ndim == 3 and arr.shape[-1] <= 4
        h, w = (arr.shape[0], arr.shape[1]) if hwc or arr.ndim == 2 \
            else (arr.shape[1], arr.shape[2])
        th, tw = self.size
        ys = (np.arange(th) * h / th).astype(int).clip(0, h - 1)
        xs = (np.arange(tw) * w / tw).astype(int).clip(0, w - 1)
        if arr.ndim == 2:
            return arr[np.ix_(ys, xs)]
        if hwc:
            return arr[np.ix_(ys, xs)]
        return arr[:, ys][:, :, xs]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[0], arr.shape[1]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        arr = np.asarray(img)
        if self.padding:
            p = self.padding
            pad = ((p, p), (p, p)) + (((0, 0),) if arr.ndim == 3 else ())
            arr = np.pad(arr, pad)
        h, w = arr.shape[0], arr.shape[1]
        th, tw = self.size
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return np.asarray(img)[:, ::-1].copy()
        return np.asarray(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return np.asarray(img)[::-1].copy()
        return np.asarray(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return np.transpose(arr, self.order)


def _jitter_range(value, name):
    """Reference _check_input semantics (transforms.py:56): a scalar v
    becomes the factor range [max(0, 1-v), 1+v]; a (lo, hi) pair is taken
    verbatim. Factors never go negative."""
    if isinstance(value, (tuple, list)):
        lo, hi = float(value[0]), float(value[1])
        if lo > hi or lo < 0:
            raise ValueError(f"{name} range {value!r} must satisfy "
                             "0 <= lo <= hi")
        return lo, hi
    if value < 0:
        raise ValueError(f"{name} value should be non-negative")
    return max(0.0, 1.0 - float(value)), 1.0 + float(value)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = _jitter_range(value, "brightness")

    def _apply_image(self, img):
        f = random.uniform(*self.value)
        return np.clip(np.asarray(img, np.float32) * f, 0,
                       255 if np.asarray(img).dtype == np.uint8 else None)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.asarray(img)[:, ::-1].copy()


def vflip(img):
    return np.asarray(img)[::-1].copy()

import sys as _sys  # noqa: E402

_self = _sys.modules[__name__]
functional = _self
transforms = _self


# functional transforms (ref: python/paddle/vision/transforms/functional.py);
# images are numpy HWC (or CHW for tensors) — no PIL dependency
def _hwc(img):
    import numpy as np
    a = np.asarray(img)
    chw = a.ndim == 3 and a.shape[0] in (1, 3) and a.shape[2] not in (1, 3)
    return (a.transpose(1, 2, 0), True) if chw else (a, False)


def _restore(a, was_chw):
    return a.transpose(2, 0, 1) if was_chw else a


def crop(img, top, left, height, width):
    a, chw = _hwc(img)
    return _restore(a[top:top + height, left:left + width], chw)


def center_crop(img, output_size):
    a, chw = _hwc(img)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    th, tw = output_size
    i = max((a.shape[0] - th) // 2, 0)
    j = max((a.shape[1] - tw) // 2, 0)
    return _restore(a[i:i + th, j:j + tw], chw)


def pad(img, padding, fill=0, padding_mode="constant"):
    import numpy as np
    a, chw = _hwc(img)
    if isinstance(padding, int):
        padding = (padding,) * 4
    if len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    l, t, r, b = padding
    pads = [(t, b), (l, r)] + [(0, 0)] * (a.ndim - 2)
    if padding_mode == "constant":
        out = np.pad(a, pads, constant_values=fill)
    else:
        out = np.pad(a, pads, mode={"edge": "edge", "reflect": "reflect",
                                    "symmetric": "symmetric"}[padding_mode])
    return _restore(out, chw)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    import numpy as np
    a, chw = _hwc(img)
    k = int(round(angle / 90.0)) % 4
    if abs(angle - 90.0 * round(angle / 90.0)) < 1e-6 \
            and (not expand or center is None):
        out = np.rot90(a, k)  # right-angle fast path, no resampling
        # for right angles rot90 IS the expanded canvas; without expand
        # the reference also returns the rotated (possibly transposed)
        # frame only when square — crop/pad back to the input frame
        if not expand and out.shape[:2] != a.shape[:2]:
            h, w = a.shape[:2]
            oh, ow = out.shape[:2]
            canvas = np.full_like(a, fill)
            ct, cl = max((oh - h) // 2, 0), max((ow - w) // 2, 0)
            t, l = max((h - oh) // 2, 0), max((w - ow) // 2, 0)
            ch_, cw_ = min(h, oh), min(w, ow)
            canvas[t:t + ch_, l:l + cw_] = out[ct:ct + ch_, cl:cl + cw_]
            out = canvas
    else:
        # nearest-neighbour rotation about the image center; expand=True
        # grows the canvas to hold the whole rotated image (ref:
        # functional rotate expand semantics)
        h, w = a.shape[:2]
        rad = np.deg2rad(angle)
        if expand:
            oh = int(np.ceil(abs(h * np.cos(rad)) + abs(w * np.sin(rad))))
            ow = int(np.ceil(abs(w * np.cos(rad)) + abs(h * np.sin(rad))))
        else:
            oh, ow = h, w
        cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None \
            else (center[1], center[0])
        ocy, ocx = ((oh - 1) / 2.0, (ow - 1) / 2.0) if expand \
            else (cy, cx)
        ys, xs = np.mgrid[0:oh, 0:ow]
        sy = cy + (ys - ocy) * np.cos(rad) - (xs - ocx) * np.sin(rad)
        sx = cx + (ys - ocy) * np.sin(rad) + (xs - ocx) * np.cos(rad)
        yi = np.clip(np.round(sy).astype(int), 0, h - 1)
        xi = np.clip(np.round(sx).astype(int), 0, w - 1)
        valid = (sy >= -0.5) & (sy < h - 0.5) & (sx >= -0.5) & (sx < w - 0.5)
        out = a[yi, xi]
        out[~valid] = fill
    return _restore(out, chw)


def to_grayscale(img, num_output_channels=1):
    import numpy as np
    a, chw = _hwc(img)
    gray = (0.299 * a[..., 0] + 0.587 * a[..., 1]
            + 0.114 * a[..., 2]).astype(a.dtype)
    out = np.stack([gray] * num_output_channels, axis=-1)
    return _restore(out, chw)


def adjust_brightness(img, brightness_factor):
    import numpy as np
    a, chw = _hwc(img)
    hi = 255 if a.dtype == np.uint8 else 1.0
    return _restore(np.clip(a * brightness_factor, 0, hi).astype(a.dtype),
                    chw)


def adjust_contrast(img, contrast_factor):
    import numpy as np
    a, chw = _hwc(img)
    hi = 255 if a.dtype == np.uint8 else 1.0
    mean = a.mean()
    out = np.clip((a - mean) * contrast_factor + mean, 0, hi).astype(a.dtype)
    return _restore(out, chw)


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor (in [-0.5, 0.5] turns) via RGB<->HSV."""
    import numpy as np
    a, chw = _hwc(img)
    scale = 255.0 if a.dtype == np.uint8 else 1.0
    x = a.astype(np.float32) / scale
    mx, mn = x.max(-1), x.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = np.where(mx == r, (g - b) / diff % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4))
    h = (h / 6.0 + hue_factor) % 1.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0)
    v = mx
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(int) % 6
    rgb = np.select(
        [i[..., None] == k for k in range(6)],
        [np.stack(c, -1) for c in
         [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]])
    out = (rgb * scale).astype(a.dtype)
    return _restore(out, chw)


def adjust_saturation(img, saturation_factor):
    """Blend between the grayscale image (factor 0) and the original
    (factor 1); >1 over-saturates. (ref: functional adjust_saturation)"""
    a, chw = _hwc(img)
    hi = 255 if a.dtype == np.uint8 else 1.0
    gray = (0.299 * a[..., 0] + 0.587 * a[..., 1]
            + 0.114 * a[..., 2])[..., None]
    out = np.clip(gray + (a.astype(np.float32) - gray) * saturation_factor,
                  0, hi).astype(a.dtype)
    return _restore(out, chw)


# ---- class transforms over the functionals above (ref: transforms.py) ----

class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = _jitter_range(value, "contrast")

    def _apply_image(self, img):
        return adjust_contrast(img, random.uniform(*self.value))


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = _jitter_range(value, "saturation")

    def _apply_image(self, img):
        return adjust_saturation(img, random.uniform(*self.value))


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if isinstance(value, (tuple, list)):
            lo, hi = float(value[0]), float(value[1])
            if not -0.5 <= lo <= hi <= 0.5:
                raise ValueError("hue range must be within [-0.5, 0.5]")
            self.value = (lo, hi)
        else:
            if not 0 <= value <= 0.5:
                raise ValueError("hue value should be in [0, 0.5]")
            self.value = (-float(value), float(value))

    def _apply_image(self, img):
        return adjust_hue(img, random.uniform(*self.value))


class ColorJitter(BaseTransform):
    """Randomly jitter brightness/contrast/saturation/hue, applying the
    four sub-transforms in random order (ref: transforms.py ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        ops = []
        if brightness:
            ops.append(BrightnessTransform(brightness))
        if contrast:
            ops.append(ContrastTransform(contrast))
        if saturation:
            ops.append(SaturationTransform(saturation))
        if hue:
            ops.append(HueTransform(hue))
        self._ops = ops

    def _apply_image(self, img):
        for t in random.sample(self._ops, len(self._ops)):
            img = t(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError("degrees must be non-negative")
            self.degrees = (-degrees, degrees)
        else:
            self.degrees = tuple(degrees)
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return rotate(img, angle, self.interpolation, self.expand,
                      self.center, self.fill)


class RandomResizedCrop(BaseTransform):
    """Crop a random area/aspect patch then resize to `size` — the
    standard ImageNet train-time augmentation (ref: transforms.py
    RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4, 4.0 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        import math
        arr = np.asarray(img)
        h, w = arr.shape[0], arr.shape[1]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            log_r = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            ar = math.exp(random.uniform(*log_r))
            cw = int(round(math.sqrt(target * ar)))
            ch = int(round(math.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = random.randint(0, h - ch)
                j = random.randint(0, w - cw)
                patch = arr[i:i + ch, j:j + cw]
                break
        else:  # fallback: center crop of the feasible aspect
            ch = cw = min(h, w)
            i, j = (h - ch) // 2, (w - cw) // 2
            patch = arr[i:i + ch, j:j + cw]
        return np.asarray(Resize(self.size, self.interpolation)(patch))
