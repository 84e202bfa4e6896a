"""Build, bind and launch the port's CUDA kernels.

The sources in `paddle_tpu_torch/csrc/` are compiled at first use with
`nvcc` into a shared library with a plain C interface and loaded with
`ctypes` — no PyTorch headers, so the build takes seconds. The library
lands in `paddle_tpu_torch/_build/<hash of the sources>/`, so a changed
source rebuilds and a fresh checkout builds on its first call.

Each kernel has a wrapper here (`ragged_stream`, `paged_decode`) that
checks device, dtype, shape and contiguity, raises on anything the
kernel does not take, launches on PyTorch's current stream, raises on a
launch error, and counts its launches in a plain integer
(`Kernel.launches`). The dense and int8 variants of each kernel are
counted apart. The plain PyTorch versions and the CPU/CUDA dispatch live
in `ops/attention.py`; nothing here falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("unified_attention.cu", "kv_load.cuh")
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
DH_SUPPORTED = (32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class Kernel:
    """A launch counter for one kernel variant (a plain integer the
    wrapper bumps once per launch, and nowhere else)."""

    def __init__(self, name):
        self.name = name
        self.launches = 0


RAGGED_STREAM = {False: Kernel("ragged_stream_dense"),
                 True: Kernel("ragged_stream_int8")}
PAGED_DECODE = {False: Kernel("paged_decode_dense"),
                True: Kernel("paged_decode_int8")}
KERNELS = (RAGGED_STREAM[False], RAGGED_STREAM[True], PAGED_DECODE[False],
           PAGED_DECODE[True])


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts():
    return {k.name: k.launches for k in KERNELS}


_lib = None
_lib_lock = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): "
                       "the port's CUDA kernels are built at first use")


def source_hash():
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build():
    """Compile the kernel library if this source hash has none yet;
    returns its path. Writes to a temporary name and renames, so a
    concurrent or interrupted build never leaves a partial library."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libpt_attention.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libpt_attention.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / "unified_attention.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.pt_ragged_stream_attention.argtypes = (
                [vp] * 9 + [i32] * 7 + [f32, i32, i32, vp])
            lib.pt_ragged_stream_attention.restype = i32
            lib.pt_paged_decode_attention.argtypes = (
                [vp] * 8 + [i32] * 6 + [f32, i32, i32, vp])
            lib.pt_paged_decode_attention.restype = i32
            _lib = lib
    return _lib


def _check_pools(q, k_blocks, v_blocks, tables):
    """Validate the query and one layer's pools for a kernel launch;
    returns (quant, k data, v data, k scales, v scales, N, BS)."""
    dev = q.device
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16 queries, got "
                        f"{q.dtype}")
    quant = hasattr(k_blocks, "codes")
    if quant != hasattr(v_blocks, "codes"):
        raise TypeError("k and v pools must both be dense or both int8")
    kd = k_blocks.codes if quant else k_blocks
    vd = v_blocks.codes if quant else v_blocks
    ks = k_blocks.scales if quant else None
    vs = v_blocks.scales if quant else None
    H, Dh = q.shape[-2], q.shape[-1]
    if Dh not in DH_SUPPORTED:
        raise ValueError(f"head_dim {Dh} not supported by the kernel "
                         f"(supported: {DH_SUPPORTED})")
    want = torch.int8 if quant else q.dtype
    for name, t in (("k", kd), ("v", vd)):
        if t.dtype != want or t.dim() != 4 or t.shape[2:] != (H, Dh) \
                or t.shape != kd.shape:
            raise ValueError(f"{name} pool {tuple(t.shape)} {t.dtype} does "
                             f"not match q (H={H}, Dh={Dh}, {want})")
    if quant:
        for name, t in (("k scales", ks), ("v scales", vs)):
            if t.dtype != q.dtype or t.shape != kd.shape[:3]:
                raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: "
                                 f"expected {tuple(kd.shape[:3])} {q.dtype}")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[1] < 1:
        raise ValueError(f"tables must be int32 [B, M>=1], got "
                         f"{tuple(tables.shape)} {tables.dtype}")
    for name, t in (("q", q), ("k", kd), ("v", vd), ("tables", tables),
                    ("k scales", ks), ("v scales", vs)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("q", "k", "v") and t.data_ptr() % 16:
            # the kernels read q/k/v with 4-lane vector loads
            raise ValueError(f"{name} is not 16-byte aligned")
    return quant, kd, vd, ks, vs, kd.shape[0], kd.shape[1]


def _ptr(t):
    return None if t is None else t.data_ptr()


def ragged_stream(q, k_blocks, v_blocks, tables, seg, pos, scale):
    """K1 on the card: segment-causal attention of the packed stream q
    [T, H, Dh] (row t: table row seg[t], positions 0..pos[t]; pos < 0
    is a pad row and comes out as zeros) against one layer's pool.
    Returns [T, H, Dh] in q's dtype."""
    if not q.is_cuda:
        raise ValueError("ragged_stream launches a CUDA kernel: q is on "
                         f"{q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be [T, H, Dh], got {tuple(q.shape)}")
    quant, kd, vd, ks, vs, N, BS = _check_pools(q, k_blocks, v_blocks,
                                                tables)
    T, H, Dh = q.shape
    for name, t in (("seg", seg), ("pos", pos)):
        if t.dtype != torch.int32 or t.shape != (T,) or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [{T}] on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype}")
    B, M = tables.shape
    out = torch.empty_like(q)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_ragged_stream_attention(
            _ptr(out), _ptr(q), _ptr(kd), _ptr(vd), _ptr(ks), _ptr(vs),
            _ptr(tables), _ptr(seg), _ptr(pos), T, H, Dh, N, BS, B, M,
            float(scale), DTYPE_CODES[q.dtype], int(quant), stream)
    if err != 0:
        raise RuntimeError(f"ragged_stream kernel launch failed "
                           f"(error {err}) at q {tuple(q.shape)} "
                           f"{q.dtype}, pool {tuple(kd.shape)}")
    RAGGED_STREAM[quant].launches += 1
    return out


def paged_decode(q, k_blocks, v_blocks, tables, ctx_lens, scale):
    """K2 on the card: one query per sequence, q [B, H, Dh], over table
    row b, positions 0..ctx_lens[b]-1. Returns [B, H, Dh] in q's
    dtype."""
    if not q.is_cuda:
        raise ValueError("paged_decode launches a CUDA kernel: q is on "
                         f"{q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, Dh], got {tuple(q.shape)}")
    quant, kd, vd, ks, vs, N, BS = _check_pools(q, k_blocks, v_blocks,
                                                tables)
    B, H, Dh = q.shape
    if tables.shape[0] != B:
        raise ValueError(f"tables rows {tables.shape[0]} != batch {B}")
    if ctx_lens.dtype != torch.int32 or ctx_lens.shape != (B,) \
            or ctx_lens.device != q.device or not ctx_lens.is_contiguous():
        raise ValueError(f"ctx_lens must be contiguous int32 [{B}] on "
                         f"{q.device}, got {tuple(ctx_lens.shape)} "
                         f"{ctx_lens.dtype}")
    M = tables.shape[1]
    out = torch.empty_like(q)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_paged_decode_attention(
            _ptr(out), _ptr(q), _ptr(kd), _ptr(vd), _ptr(ks), _ptr(vs),
            _ptr(tables), _ptr(ctx_lens), B, H, Dh, N, BS, M, float(scale),
            DTYPE_CODES[q.dtype], int(quant), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed "
                           f"(error {err}) at q {tuple(q.shape)} "
                           f"{q.dtype}, pool {tuple(kd.shape)}")
    PAGED_DECODE[quant].launches += 1
    return out


__all__ = ["build", "library", "ragged_stream", "paged_decode",
           "reset_launch_counts", "launch_counts", "KERNELS",
           "RAGGED_STREAM", "PAGED_DECODE"]
