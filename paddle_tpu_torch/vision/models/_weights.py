"""Pretrained weights for the vision zoo, from a local directory.

The reference's `pretrained=True` (ref: vision/models/resnet.py:261-264)
downloads; this package never does. It reads `<dir>/<arch>.pdparams`
(dir: $PADDLE_TPU_PRETRAINED_DIR, else ~/.cache/paddle_tpu/hub) with
`paddle.load` — a state dict the port saved, or the reference's file —
and raises FileNotFoundError when there is none, never returning random
weights in its place.
"""
from __future__ import annotations

import os

PRETRAINED_DIR_ENV = "PADDLE_TPU_PRETRAINED_DIR"
_DEFAULT_DIR = os.path.expanduser("~/.cache/paddle_tpu/hub")


def load_pretrained(model, arch):
    """Load `<dir>/<arch>.pdparams` into `model`; raise with guidance
    when it is absent."""
    d = os.environ.get(PRETRAINED_DIR_ENV, _DEFAULT_DIR)
    path = os.path.join(d, f"{arch}.pdparams")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained=True for '{arch}' but no weights at {path}. "
            "Weights are never downloaded; place a state_dict saved with "
            f"paddle.save at that path (or set ${PRETRAINED_DIR_ENV} to "
            "your weights directory), or pass pretrained=False for random "
            "initialization.")
    from ...framework.io import load
    model.set_state_dict(load(path))
    return model
