"""Dtypes: the port of `paddle_tpu/core/dtype.py` onto torch dtypes.

The names (`float32`, `bfloat16`, `int64`, ...) are torch dtypes, and
`convert_dtype` takes any spec the reference takes — a name or alias
("fp16", "bf16", "float", "long", ...), a numpy dtype, a torch dtype, or
None for the default dtype (`set_default_dtype` / `get_default_dtype`,
"float32" at start).

One decided difference: the reference canonicalizes the 64-bit types to
32 bits (a TPU has no 64-bit compute and JAX runs with x64 off); the
port keeps `int64`, `float64` and `complex128` as they are, as Paddle
does on a GPU, and torch's index ops want int64. Values agree; only the
width of such results differs.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "bool": torch.bool,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

_ALIASES = {
    "fp16": "float16",
    "bf16": "bfloat16",
    "fp32": "float32",
    "fp64": "float64",
    "half": "float16",
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
    "bool_": "bool",
}

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_OF = {v: k for k, v in _DTYPES.items()}
_default_dtype = "float32"


def set_default_dtype(d):
    global _default_dtype
    _default_dtype = dtype_name(d)


def get_default_dtype():
    return _default_dtype


def convert_dtype(dtype) -> torch.dtype:
    """Any dtype spec (name, alias, numpy or torch dtype, None) as a torch
    dtype; None is the default dtype."""
    if dtype is None:
        return _DTYPES[_default_dtype]
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[dtype_name(dtype)]


def dtype_name(dtype) -> str:
    """The canonical name of a dtype spec ("float32", "int64", ...)."""
    if dtype is None:
        return _default_dtype
    if isinstance(dtype, torch.dtype):
        return _NAME_OF[dtype]
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
        if name in _DTYPES:
            return name
        raise ValueError(f"unsupported dtype {dtype!r}")
    name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return name


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not d.is_floating_point and not d.is_complex and d != torch.bool


__all__ = ["float16", "bfloat16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "bool_", "complex64", "complex128",
           "set_default_dtype", "get_default_dtype", "convert_dtype",
           "dtype_name", "is_floating", "is_integer"]
