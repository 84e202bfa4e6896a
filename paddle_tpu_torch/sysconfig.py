"""paddle.sysconfig of the port (Paddle's python/paddle/sysconfig.py): the
directories a native extension compiles and links against — the
sources under `csrc/` (headers and sources of the CUDA kernels and the
native runtime) and the build directory the kernels are compiled into
at first use (`_build/`)."""
from __future__ import annotations

import os

__all__ = ["get_include", "get_lib"]

_PKG = os.path.dirname(os.path.abspath(__file__))


def get_include():
    return os.path.join(_PKG, "csrc")


def get_lib():
    return os.path.join(_PKG, "_build")
