"""paddle.utils.download of the port (the reference's
`paddle_tpu/utils/download.py`, Paddle's python/paddle/utils/download.py).

Nothing downloads: a weights URL resolves to its file's basename inside
the local weights directory the vision zoo documents
($PADDLE_TPU_PRETRAINED_DIR, else ~/.cache/paddle_tpu/hub), and an absent
file raises with staging guidance — never a silent random model.
"""
from __future__ import annotations

import os

from ..vision.models._weights import _DEFAULT_DIR as WEIGHTS_HOME
from ..vision.models._weights import PRETRAINED_DIR_ENV

__all__ = ["get_weights_path_from_url"]


def _weights_dir():
    return os.environ.get(PRETRAINED_DIR_ENV, WEIGHTS_HOME)


def _resolve(url, md5sum, root_dir=None):
    fname = os.path.basename(str(url).split("?")[0])
    path = os.path.join(root_dir or _weights_dir(), fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"weights '{fname}' not found at {path}. Nothing is "
            "downloaded; place the file there (or set "
            f"${PRETRAINED_DIR_ENV} to the directory holding it).")
    if md5sum is not None:
        from ..dataset.common import md5file
        got = md5file(path)
        if got != md5sum:
            raise ValueError(
                f"md5 mismatch for {path}: expected {md5sum}, got {got}")
    return path


def get_weights_path_from_url(url, md5sum=None):
    """The local path a weights URL maps to (its basename inside the
    weights directory); raises FileNotFoundError when absent."""
    return _resolve(url, md5sum)


def get_path_from_url(url, root_dir=None, md5sum=None, check_exist=True):
    """The reference's signature: `root_dir` overrides the directory."""
    return _resolve(url, md5sum, root_dir=root_dir)
