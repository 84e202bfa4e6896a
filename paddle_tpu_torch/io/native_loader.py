"""The Python binding of the native runtime (`csrc/native_runtime.cpp`, a
copy of the reference's host C++ byte queue and staging arena).

g++ builds the shared library at first use into
`paddle_tpu_torch/_build/native/<hash of the source>/` (never beside the
source; the build is written under a temporary name and renamed into
place, so processes that build at once do not read a half-written
file). ctypes releases the GIL around every call into it, so pushes,
pops and blocking waits overlap Python work.

  * `NativePrefetcher` — iterate a batch source on a background thread;
    batches cross the bounded byte queue as raw bytes.
  * `HostArena` — a size-bucketed host staging allocator.
  * `parse_multislot` — a MultiSlot text buffer parsed natively
    (`ms_scan`, `ms_fill`) into padded per-slot numpy arrays.
  * `_serialize_batch` / `_deserialize_batch` — one batch as one byte
    string: a pickled header (the batch's structure, each array's dtype
    and shape) and the arrays' raw bytes. torch tensors cross as numpy
    and come back as CPU tensors; the consumer moves them to its device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import subprocess
import tempfile
import threading

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "native_runtime.cpp")
_BUILD = os.path.join(_PKG, "_build", "native")
_LIB_NAME = "libpaddle_tpu_torch_native.so"

_lib = None
_lib_lock = threading.Lock()


def _library_path():
    """Where the library for the current source lives (built or not)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, digest, _LIB_NAME)


def build():
    """Compile the runtime with g++ ($CXX) unless this source's library
    is there; returns its path."""
    so = _library_path()
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        cmd = [os.environ.get("CXX", "g++"), "-O3", "-shared", "-fPIC",
               "-std=c++17", _SRC, "-o", tmp, "-pthread"]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC}:\n{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def get_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        vp, sz, i64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64
        for name, res, args in (
                ("ptq_create", vp, [sz, sz]),
                ("ptq_push", ctypes.c_int, [vp, u8p, sz]),
                ("ptq_peek_size", i64, [vp]),
                ("ptq_pop", i64, [vp, u8p, sz]),
                ("ptq_pop_timed", i64, [vp, u8p, sz, i64]),
                ("ptq_push_tagged", ctypes.c_int, [vp, ctypes.c_uint8, u8p,
                                                   sz]),
                ("ptq_size", i64, [vp]),
                ("ptq_close", None, [vp]),
                ("ptq_destroy", None, [vp]),
                ("arena_create", vp, [sz]),
                ("arena_alloc", vp, [vp, sz]),
                ("arena_free", None, [vp, vp]),
                ("arena_reserved_bytes", i64, [vp]),
                ("arena_destroy", None, [vp]),
                ("ms_scan", ctypes.c_longlong,
                 [ctypes.POINTER(ctypes.c_char), ctypes.c_longlong,
                  ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]),
                ("ms_fill", ctypes.c_int,
                 [ctypes.POINTER(ctypes.c_char), ctypes.c_longlong,
                  ctypes.c_int, u8p, ctypes.POINTER(ctypes.c_longlong),
                  ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong])):
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def parse_multislot(data, slot_meta):
    """Parse a MultiSlot text buffer natively into padded per-slot arrays
    (the reference's `io/native_loader.py:93`).

    data: bytes (a bytearray is terminated in place, not copied) of
    slot-formatted lines. slot_meta: [(name, np_dtype, fixed_width or
    None), ...]. Returns {name: [n_samples, width] ndarray} (float32 for
    float32 slots, int64 otherwise); raises ValueError on malformed
    input."""
    lib = get_lib()
    n_slots = len(slot_meta)
    if n_slots == 0:
        raise ValueError("no slots configured (set_use_var first)")
    if isinstance(data, bytearray):
        if not data.endswith(b"\0"):
            data.append(0)
    else:
        data = bytearray(data) + b"\0"
    length = len(data) - 1
    cbuf = (ctypes.c_char * len(data)).from_buffer(data)
    widths = (ctypes.c_longlong * n_slots)()
    n = lib.ms_scan(cbuf, length, n_slots, widths)
    if n < 0:
        raise ValueError("malformed MultiSlot data (token/slot mismatch)")
    out = {}
    ptrs = (ctypes.c_void_p * n_slots)()
    is_float = (ctypes.c_uint8 * n_slots)()
    final_w = (ctypes.c_longlong * n_slots)()
    for s, (name, dtype, fixed) in enumerate(slot_meta):
        w = int(widths[s])
        if fixed:
            w = max(w, int(fixed))  # the buffer must hold every token
        is_float[s] = 1 if np.dtype(dtype) == np.float32 else 0
        arr = np.zeros((int(n), w), np.float32 if is_float[s] else np.int64)
        out[name] = arr
        final_w[s] = w
        ptrs[s] = arr.ctypes.data_as(ctypes.c_void_p)
    if n and lib.ms_fill(cbuf, length, n_slots, is_float, final_w, ptrs,
                         n) != 0:
        raise ValueError("malformed MultiSlot data (value parse failed)")
    for name, dtype, fixed in slot_meta:
        if fixed and out[name].shape[1] != int(fixed):
            out[name] = out[name][:, : int(fixed)]
    return out


def _serialize_batch(batch):
    """(header length, header, raw bytes) of a batch: tensors and arrays
    travel as raw buffers, everything else inside the pickled header."""
    arrays = []

    def strip(obj):
        if torch.is_tensor(obj) or isinstance(obj, np.ndarray):
            is_tensor = torch.is_tensor(obj)
            a = np.ascontiguousarray(obj.detach().cpu().numpy()
                                     if is_tensor else obj)
            arrays.append(a)
            return ("__arr__", len(arrays) - 1, a.dtype.str, a.shape,
                    is_tensor)
        if isinstance(obj, (list, tuple)):
            return type(obj)(strip(o) for o in obj)
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items()}
        return obj

    meta = strip(batch)
    payload = b"".join(a.tobytes() for a in arrays)
    header = pickle.dumps((meta, [a.nbytes for a in arrays]))
    return len(header).to_bytes(8, "little") + header + payload


def _deserialize_batch(buf):
    hlen = int.from_bytes(buf[:8], "little")
    meta, sizes = pickle.loads(bytes(buf[8:8 + hlen]))
    offset = 8 + hlen
    arrays = []
    for n in sizes:
        arrays.append(bytearray(buf[offset:offset + n]))  # writable
        offset += n

    def rebuild(obj):
        if isinstance(obj, tuple) and len(obj) == 5 and obj[0] == "__arr__":
            _, idx, dtype, shape, is_tensor = obj
            a = np.frombuffer(arrays[idx], dtype=np.dtype(dtype)) \
                .reshape(shape)
            return torch.from_numpy(a) if is_tensor else a
        if isinstance(obj, tuple):
            return tuple(rebuild(o) for o in obj)
        if isinstance(obj, list):
            return [rebuild(o) for o in obj]
        if isinstance(obj, dict):
            return {k: rebuild(v) for k, v in obj.items()}
        return obj

    return rebuild(meta)


class NativePrefetcher:
    """Iterate `source_iter` on a background thread; batches flow through
    the C++ bounded queue as raw bytes."""

    def __init__(self, source_iter, depth=4, capacity_mb=512):
        self._lib = get_lib()
        self._q = self._lib.ptq_create(depth, capacity_mb << 20)
        self._exc = None
        self._thread = threading.Thread(target=self._producer,
                                        args=(source_iter,), daemon=True)
        self._thread.start()

    def _producer(self, source_iter):
        try:
            for batch in source_iter:
                data = _serialize_batch(batch)
                buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
                if self._lib.ptq_push(self._q, buf, len(data)) != 0:
                    return
        except Exception as e:  # raised again on the consumer's side
            self._exc = e
        finally:
            self._lib.ptq_close(self._q)

    def __iter__(self):
        try:
            while True:
                n = self._lib.ptq_peek_size(self._q)
                if n < 0:
                    break
                out = (ctypes.c_uint8 * n)()
                if self._lib.ptq_pop(self._q, out, n) < 0:
                    break
                yield _deserialize_batch(memoryview(out))
            if self._exc is not None:
                raise self._exc
        finally:
            # a consumer that stops early: closing wakes a producer
            # blocked on the full queue before the queue is freed
            self._lib.ptq_close(self._q)
            self._thread.join()
            self._lib.ptq_destroy(self._q)
            self._q = None


class HostArena:
    """Size-bucketed host staging allocator."""

    def __init__(self, limit_bytes=4 << 30):
        self._lib = get_lib()
        self._a = self._lib.arena_create(limit_bytes)

    def alloc(self, nbytes) -> int:
        p = self._lib.arena_alloc(self._a, nbytes)
        if not p:
            raise MemoryError(f"arena alloc of {nbytes} failed")
        return p

    def free(self, ptr: int):
        self._lib.arena_free(self._a, ptr)

    def buffer(self, nbytes):
        """(numpy view over an arena block, its pointer); free the
        pointer when done."""
        ptr = self.alloc(nbytes)
        return np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), (nbytes,)), ptr

    @property
    def reserved_bytes(self):
        return self._lib.arena_reserved_bytes(self._a)

    def __del__(self):
        try:
            self._lib.arena_destroy(self._a)
        except Exception:
            pass


__all__ = ["build", "get_lib", "NativePrefetcher", "HostArena",
           "parse_multislot"]
