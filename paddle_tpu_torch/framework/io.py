"""paddle.save / paddle.load: the port of `paddle_tpu/framework/io.py`.

The format is the reference's: a pickle of nested dicts, lists and
tuples whose tensors are `_TensorPayload(array, dtype)` — the values as
a numpy array and the dtype's name. Everything that is not a tensor
(numbers, strings, numpy arrays) is pickled as it is.

Reading: `load` reads the port's files and the reference's. The
reference's payload class (`paddle_tpu.framework.io._TensorPayload`) is
mapped to this module's by name, so nothing of the JAX package is
imported. The reference pickles a bfloat16 array as an `ml_dtypes`
array; this module maps `ml_dtypes.bfloat16` to numpy's uint16 while it
reads (the same two bytes an element), so such a file loads where
`ml_dtypes` is not installed. Tensors land on `get_device()` (the card
unless `set_device("cpu")`), or as numpy arrays under
`return_numpy=True` — a bfloat16 tensor then comes back as float32 (the
exact widening; numpy has no bfloat16).

Writing: a bfloat16 tensor is written as its uint16 bits with the dtype
name "bfloat16", which any numpy reads. The reference cannot read the
port's files: their payloads are this module's class, and the reference
reads only its own (ROADMAP §C 36).

`async_save` / `wait_save`: the host copy is taken at the call; a
background thread writes the file to `path.tmp` and renames it into
place, so a crash mid-write leaves the previous file whole.
"""
from __future__ import annotations

import os
import pickle
import threading

import numpy as np
import torch



class _TensorPayload:
    __slots__ = ("array", "dtype")

    def __init__(self, array, dtype):
        self.array = array
        self.dtype = dtype


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _to_saveable(obj):
    if torch.is_tensor(obj):
        # a copy: the payload must not change with the tensor after the
        # call (async_save writes it later)
        t = obj.detach().to("cpu", copy=True).contiguous()
        name = _dtype_name(t)
        if t.dtype == torch.bfloat16:
            return _TensorPayload(t.view(torch.int16).numpy().view(np.uint16),
                                  name)
        return _TensorPayload(t.numpy(), name)
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _payload_tensor(p, device):
    arr = np.ascontiguousarray(p.array)
    if p.dtype == "bfloat16":  # its uint16 bits (module docstring)
        bits = torch.from_numpy(arr.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _from_saveable(obj, return_numpy, device):
    if isinstance(obj, _TensorPayload):
        t = _payload_tensor(obj, "cpu" if return_numpy else device)
        if return_numpy:
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return t
    if isinstance(obj, dict):
        return {k: _from_saveable(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v, return_numpy, device)
                         for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    """Maps the reference's payload class and ml_dtypes' bfloat16 (module
    docstring) without importing either package."""

    def find_class(self, module, name):
        if name == "_TensorPayload" and module.endswith("framework.io"):
            return _TensorPayload
        if module.split(".")[0] == "ml_dtypes":
            if name == "bfloat16":
                return np.uint16
            raise pickle.UnpicklingError(f"ml_dtypes.{name} is not readable")
        return super().find_class(module, name)


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    from ..device import resolve_device

    device = None if return_numpy else resolve_device(None)
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _from_saveable(obj, return_numpy, device)


class AsyncSaver:
    """Snapshot to host memory at the call, write on a background thread,
    rename into place (module docstring)."""

    def __init__(self):
        self._thread = None
        self._lock = threading.Lock()

    def save(self, obj, path):
        payload = _to_saveable(obj)  # the device -> host copy, here
        self.wait()

        def _write():
            tmp = path + ".tmp"
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "wb") as f:
                pickle.dump(payload, f, protocol=4)
            os.replace(tmp, path)

        with self._lock:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        with self._lock:
            t = self._thread
        if t is not None:
            t.join()


_async_saver = AsyncSaver()


def async_save(obj, path):
    """paddle.framework.io.async_save: a checkpoint write that does not
    block (module docstring)."""
    _async_saver.save(obj, path)


def wait_save():
    _async_saver.wait()


__all__ = ["save", "load", "async_save", "wait_save", "AsyncSaver"]
