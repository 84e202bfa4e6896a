"""Build, bind and launch the port's CUDA kernels.

The sources in `paddle_tpu_torch/csrc/` are compiled at first use with
`nvcc` (one process per `.cu`, all started together, then one link) into
a shared library with a plain C interface and loaded with `ctypes` — no
PyTorch headers, so the build takes seconds. The library lands in
`paddle_tpu_torch/_build/<hash of the sources>/`, so a changed source
rebuilds and a fresh checkout builds on its first call.

Each kernel has a wrapper here (`ragged_stream`, `paged_decode` of the
serving path; `flash_fwd`, `flash_delta`, `flash_bwd` of the training
path, the two-pass backward `flash_bwd_dq`, `flash_bwd_dkv`, and the
per-key-bias variants `flash_fwd_bias`, `flash_bwd_bias`,
`flash_bwd_dq_bias`, `flash_bwd_dkv_bias`) that checks device, dtype,
shape and contiguity, raises on anything the kernel does not take,
launches on PyTorch's current stream, raises on a launch error, and
counts its launches in a plain integer (`Kernel.launches`; a replayed
CUDA graph adds the launches its capture counted, `add_launches`). The
dense and int8 variants of each paged kernel, the biased and unbiased
flash kernels, and the float16 instances of the flash kernels (`F16`:
`flash_fwd_f16`, ...) are counted apart. The flash kernels take
float32, bfloat16 and float16 (`DTYPE_CODES`); the paged ones float32
and bfloat16 (`POOL_DTYPE_CODES`), as the reference's serving names no
float16. The plain PyTorch versions and the CPU/CUDA
dispatch live in `ops/attention.py` and `ops/flash_attention.py`;
nothing here falls back.
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
UNITS = ("unified_attention.cu", "flash_attention.cu",  # one object each
         "flash_bwd_two_pass.cu", "flash_fwd_sm90.cu", "flash_bwd_sm90.cu",
         "flash_bwd_dq_sm90.cu", "paged_decode_sm90.cu",
         "ragged_stream_sm90.cu")
SOURCES = UNITS + ("kv_load.cuh", "elem.cuh", "flash_common.cuh",
                   "sm90_tile.cuh", "flash_sm90.cuh")
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
DH_SUPPORTED = (32, 64, 128)
# the dtype codes of the C entry points (csrc/flash_common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
POOL_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K2's split plan (csrc/paged_decode_sm90.cu): heads per CTA, the key
# alignment of a split (a multiple of every stage of the kernel), and the
# CTAs the plan aims at: four a streaming multiprocessor of an H100
SPLIT_HEADS = 4
SPLIT_ALIGN = 64
SPLIT_TARGET_CTAS = 4 * 132
# the bf16 K1's geometry (csrc/ragged_stream_sm90.cu): query rows of a tile
# (one head; a key pass per distinct segment in it) and keys of a stage
STREAM_ROWS = 64
STREAM_KEYS = 64


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
FLASH_FWD = Kernel("flash_fwd")
FLASH_DELTA = Kernel("flash_delta")
FLASH_BWD = Kernel("flash_bwd")
FLASH_FWD_BIAS = Kernel("flash_fwd_bias")
FLASH_BWD_BIAS = Kernel("flash_bwd_bias")
FLASH_BWD_DQ = Kernel("flash_bwd_dq")
FLASH_BWD_DKV = Kernel("flash_bwd_dkv")
FLASH_BWD_DQ_BIAS = Kernel("flash_bwd_dq_bias")
FLASH_BWD_DKV_BIAS = Kernel("flash_bwd_dkv_bias")
_FLASH = (FLASH_FWD, FLASH_DELTA, FLASH_BWD, FLASH_FWD_BIAS, FLASH_BWD_BIAS,
          FLASH_BWD_DQ, FLASH_BWD_DKV, FLASH_BWD_DQ_BIAS, FLASH_BWD_DKV_BIAS)
# the float16 instance of each flash kernel, counted apart
F16 = {k: Kernel(k.name + "_f16") for k in _FLASH}
KERNELS = (RAGGED_STREAM[False], RAGGED_STREAM[True], PAGED_DECODE[False],
           PAGED_DECODE[True], *_FLASH, *F16.values())


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts():
    return {k.name: k.launches for k in KERNELS}


def add_launches(counts):
    """Add {kernel name: n} to the launch counts. A CUDA graph's replay
    runs no wrapper, so the graph adds what its wrappers counted while it
    was captured (`nn.decode_graph`)."""
    for k in KERNELS:
        k.launches += counts.get(k.name, 0)


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


def _spawn(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _run(procs):
    """Wait for every (command, Popen) pair; raise on the first failure."""
    failed = None
    for cmd, proc in procs:
        _out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, err)
    if failed:
        cmd, rc, err = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n"
                           f"{err[-4000:]}")


def build():
    """Compile the kernel library if this source hash has none yet;
    returns its path. Every source compiles in its own `nvcc` process,
    all started together, then one link. Writes to temporary names and
    renames, so a concurrent or interrupted build never leaves a partial
    library."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libpt_attention.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs, procs = [], []
    for unit in UNITS:
        obj = out_dir / f"{Path(unit).stem}.{tag}.o"
        procs.append(_spawn([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                             str(CSRC / unit)]))
        objs.append(obj)
    _run(procs)
    tmp = out_dir / f"libpt_attention.{tag}.tmp.so"
    _run([_spawn([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                  *map(str, objs)])])
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink()
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
                [vp] * 9 + [i32] * 8 + [f32, i32, i32, vp])
            lib.pt_paged_decode_attention.restype = i32
            lib.pt_flash_fwd.argtypes = [vp] * 6 + [i32] * 6 + [f32, i32,
                                                                i32, vp]
            lib.pt_flash_fwd.restype = i32
            lib.pt_flash_delta.argtypes = [vp] * 3 + [ctypes.c_longlong,
                                                      i32, i32, vp]
            lib.pt_flash_delta.restype = i32
            lib.pt_flash_bwd.argtypes = [vp] * 12 + [i32] * 6 + [f32, i32,
                                                                 i32, vp]
            lib.pt_flash_bwd.restype = i32
            lib.pt_flash_bwd_dq.argtypes = [vp] * 8 + [i32] * 6 + [f32, i32,
                                                                   i32, vp]
            lib.pt_flash_bwd_dq.restype = i32
            lib.pt_flash_bwd_dkv.argtypes = [vp] * 10 + [i32] * 6 + [
                f32, i32, i32, vp]
            lib.pt_flash_bwd_dkv.restype = i32
            _lib = lib
    return _lib


def _check_pools(q, k_blocks, v_blocks, tables):
    """Validate the query and one layer's pools for a kernel launch;
    returns (quant, k data, v data, k scales, v scales, N, BS)."""
    dev = q.device
    if q.dtype not in POOL_DTYPE_CODES:
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
    Returns [T, H, Dh] in q's dtype. bfloat16 runs the tensor-core kernel
    of csrc/ragged_stream_sm90.cu (tiles of STREAM_ROWS rows of one head,
    one key pass per distinct segment of a tile, stages of STREAM_KEYS
    keys by TMA through the block table; int8 pools dequantized into bf16
    in shared memory), float32 the SIMT one of csrc/unified_attention.cu.
    Reads nothing of seg, pos or tables on the host, and is bitwise
    reproducible."""
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
            float(scale), POOL_DTYPE_CODES[q.dtype], int(quant), stream)
    if err != 0:
        raise RuntimeError(f"ragged_stream kernel launch failed "
                           f"(error {err}) at q {tuple(q.shape)} "
                           f"{q.dtype}, pool {tuple(kd.shape)}")
    RAGGED_STREAM[quant].launches += 1
    return out


def decode_split_plan(B, H, M, BS):
    """K2's split-KV plan from shapes the host knows (never ctx_lens,
    which lives on the card: reading it would synchronise the serving
    loop). Returns (splits, chunk): split s covers the cache positions
    [s * chunk, min((s + 1) * chunk, M * BS)), chunk is a multiple of
    SPLIT_ALIGN, and every split is nonempty. The grid (splits, head
    groups of SPLIT_HEADS, B) aims at SPLIT_TARGET_CTAS CTAs; rows whose
    context ends early leave their later splits empty."""
    keys = M * BS
    groups = -(-H // min(H, SPLIT_HEADS))
    want = -(-SPLIT_TARGET_CTAS // (B * groups))
    splits = max(1, min(want, -(-keys // SPLIT_ALIGN)))
    chunk = -(-keys // splits)
    chunk = -(-chunk // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-keys // chunk), chunk


def paged_decode(q, k_blocks, v_blocks, tables, ctx_lens, scale):
    """K2 on the card: one query per sequence, q [B, H, Dh], over table
    row b, positions 0..min(ctx_lens[b], M * BS)-1 (a row with ctx 0 gives
    zeros). Returns [B, H, Dh] in q's dtype. Runs the split kernel of
    csrc/paged_decode_sm90.cu over `decode_split_plan`'s splits and, with
    more than one split, its combine kernel (one launch count a call).
    Reads nothing of ctx_lens on the host, and is bitwise reproducible."""
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
    splits, chunk = decode_split_plan(B, H, M, BS)
    out = torch.empty_like(q)
    ws = None
    if splits > 1:  # float32 partials: acc [B*H*splits, Dh], then (m, l)
        ws = torch.empty(B * H * splits * (Dh + 2), dtype=torch.float32,
                         device=q.device)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_paged_decode_attention(
            _ptr(out), _ptr(ws), _ptr(q), _ptr(kd), _ptr(vd), _ptr(ks),
            _ptr(vs), _ptr(tables), _ptr(ctx_lens), B, H, Dh, N, BS, M,
            splits, chunk, float(scale), POOL_DTYPE_CODES[q.dtype],
            int(quant), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed "
                           f"(error {err}) at q {tuple(q.shape)} "
                           f"{q.dtype}, pool {tuple(kd.shape)}, "
                           f"{splits} splits of {chunk} keys")
    PAGED_DECODE[quant].launches += 1
    return out


def _check_flash(name, tensors, dtype=None):
    """The operand checks of the flash kernels: every tensor on one CUDA
    device, contiguous and 16-byte aligned, of the given dtype. Entries
    are (name, tensor) or (name, tensor, its own dtype)."""
    dev = None
    for entry in tensors:
        tname, t = entry[0], entry[1]
        want = entry[2] if len(entry) > 2 else dtype
        if not t.is_cuda:
            raise ValueError(f"{name} launches a CUDA kernel: {tname} is on "
                             f"{t.device}")
        dev = dev or t.device
        if t.device != dev:
            raise ValueError(f"{name}: {tname} is on {t.device}, the "
                             f"other operands on {dev}")
        if t.dtype != want:
            raise TypeError(f"{name}: {tname} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            # the kernels read rows with 4-lane vector loads
            raise ValueError(f"{name}: {tname} is not 16-byte aligned")
    return dev


def _qkv_shapes(name, q, k, v):
    """(BH, Sq, Sk, D) of q [B, H, Sq, D] and k/v [B, H, Sk, D]."""
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32, bfloat16 or float16, got "
                        f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B, H, S, D] with "
                         f"one B, H and D")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if D not in DH_SUPPORTED:
        raise ValueError(f"head_dim {D} not supported by the kernel "
                         f"(supported: {DH_SUPPORTED})")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"{name}: empty sequence (Sq {Sq}, Sk {Sk})")
    return B * H, Sq, Sk, D


def _check_bias(name, bias, B, Sk, dev):
    """A per-key bias [B or 1, Sk] float32, contiguous, on dev; returns
    its batch stride (0 broadcasts one row)."""
    if bias.dtype != torch.float32 or bias.dim() != 2 \
            or bias.shape[0] not in (1, B) or bias.shape[1] != Sk:
        raise ValueError(f"{name}: bias {tuple(bias.shape)} {bias.dtype}, "
                         f"expected float32 [{B} or 1, {Sk}]")
    if bias.device != dev:
        raise ValueError(f"{name}: bias is on {bias.device}, q on {dev}")
    if not bias.is_contiguous():
        raise ValueError(f"{name}: bias must be contiguous")
    return 0 if bias.shape[0] == 1 else Sk


def _count(counter, dtype):
    (F16[counter] if dtype == torch.float16 else counter).launches += 1


def _launched(name, counter, err, q, k):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (error {err}) "
                           f"at q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"{q.dtype}")
    _count(counter, q.dtype)


def _flash_fwd(name, counter, q, k, v, bias, scale, causal):
    BH, Sq, Sk, D = _qkv_shapes(name, q, k, v)
    _check_flash(name, (("q", q), ("k", k), ("v", v)), q.dtype)
    bstride = 0 if bias is None else _check_bias(name, bias, q.shape[0], Sk,
                                                 q.device)
    out = torch.empty_like(q)
    lse = torch.empty(BH, Sq, dtype=torch.float32, device=q.device)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_fwd(_ptr(out), _ptr(lse), _ptr(q), _ptr(k),
                               _ptr(v), _ptr(bias), BH, q.shape[1], Sq, Sk,
                               D, bstride, float(scale), int(bool(causal)),
                               DTYPE_CODES[q.dtype], stream)
    _launched(name, counter, err, q, k)
    return out, lse


def flash_fwd(q, k, v, scale, causal):
    """K4 on the card: attention of q [B, H, Sq, D] over k/v
    [B, H, Sk, D] (causal: bottom-right aligned). Returns (out
    [B, H, Sq, D] in q's dtype, lse [B*H, Sq] float32). bfloat16 and
    float16 run the tensor-core kernel of csrc/flash_fwd_sm90.cu, float32
    the SIMT one of csrc/flash_attention.cu."""
    return _flash_fwd("flash_fwd", FLASH_FWD, q, k, v, None, scale, causal)


def flash_fwd_bias(q, k, v, bias, scale, causal):
    """K4 bias on the card: K4 with the per-key bias [B or 1, Sk] float32
    added to every score row of its batch entry (one row broadcasts over
    the batch). Returns (out, lse) as `flash_fwd`."""
    return _flash_fwd("flash_fwd_bias", FLASH_FWD_BIAS, q, k, v, bias,
                      scale, causal)


def flash_delta(o, do):
    """K6 on the card: delta = rowsum(dO * O) in float32, for o and do
    [B, H, S, D]. Returns [B*H, S] float32."""
    if o.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_delta takes float32, bfloat16 or float16, "
                        f"got {o.dtype}")
    if o.dim() != 4 or do.shape != o.shape:
        raise ValueError(f"flash_delta: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be one [B, H, S, D]")
    B, H, S, D = o.shape
    if D not in DH_SUPPORTED:
        raise ValueError(f"head_dim {D} not supported by the kernel "
                         f"(supported: {DH_SUPPORTED})")
    _check_flash("flash_delta", (("o", o), ("do", do)), o.dtype)
    delta = torch.empty(B * H, S, dtype=torch.float32, device=o.device)
    lib = library()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = lib.pt_flash_delta(_ptr(delta), _ptr(o), _ptr(do), B * H * S,
                                 D, DTYPE_CODES[o.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_delta kernel launch failed (error "
                           f"{err}) at o {tuple(o.shape)} {o.dtype}")
    _count(FLASH_DELTA, o.dtype)
    return delta


def _bwd_operands(name, q, k, v, do, lse, delta, bias):
    """The checks every backward kernel makes; returns (BH, Sq, Sk, D,
    the bias's batch stride or 0)."""
    BH, Sq, Sk, D = _qkv_shapes(name, q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"{name}: do {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    for tname, t in (("lse", lse), ("delta", delta)):
        if t.shape != (BH, Sq):
            raise ValueError(f"{name}: {tname} {tuple(t.shape)}, "
                             f"expected ({BH}, {Sq})")
    _check_flash(name, (("q", q), ("k", k), ("v", v), ("do", do),
                        ("lse", lse, torch.float32),
                        ("delta", delta, torch.float32)), q.dtype)
    bstride = 0
    if bias is not None:
        bstride = _check_bias(name, bias, q.shape[0], Sk, q.device)
    return BH, Sq, Sk, D, bstride


def _flash_bwd(name, counter, q, k, v, do, lse, delta, bias, scale,
               causal):
    BH, Sq, Sk, D, bstride = _bwd_operands(name, q, k, v, do, lse, delta,
                                           bias)
    dbias = None
    if bias is not None:
        dbias = torch.empty(BH, Sk, dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dq_ws = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_bwd(_ptr(dq), _ptr(dk), _ptr(dv), _ptr(dq_ws),
                               _ptr(dbias), _ptr(q), _ptr(k), _ptr(v),
                               _ptr(do), _ptr(lse), _ptr(delta), _ptr(bias),
                               BH, q.shape[1], Sq, Sk, D, bstride,
                               float(scale), int(bool(causal)),
                               DTYPE_CODES[q.dtype], stream)
    _launched(name, counter, err, q, k)
    return dq, dk, dv, dbias


def flash_bwd(q, k, v, do, lse, delta, scale, causal):
    """K9 on the card: the fused backward of K4 given its lse and K6's
    delta (both [B*H, Sq] float32) and the output cotangent do
    [B, H, Sq, D]. Returns (dq, dk, dv) in q's dtype. bfloat16 and
    float16 run the tensor-core kernel of csrc/flash_bwd_sm90.cu, float32
    the SIMT one of csrc/flash_attention.cu. dq is summed across key tiles
    (bulk reductions in 16 bits, atomics in float32), so its last bits
    vary from run to run; dk and dv are bitwise reproducible."""
    return _flash_bwd("flash_bwd", FLASH_BWD, q, k, v, do, lse, delta, None,
                      scale, causal)[:3]


def flash_bwd_bias(q, k, v, do, lse, delta, bias, scale, causal):
    """K9 bias on the card: K9 with K4 bias's per-key bias [B or 1, Sk]
    float32. Returns (dq, dk, dv, dbias) with dbias [B*H, Sk] float32, the
    column sums of ds per (batch, head) row (the caller sums over heads,
    and over the batch when the bias broadcasts)."""
    return _flash_bwd("flash_bwd_bias", FLASH_BWD_BIAS, q, k, v, do, lse,
                      delta, bias, scale, causal)


def _flash_bwd_dq(name, counter, q, k, v, do, lse, delta, bias, scale,
                  causal):
    BH, Sq, Sk, D, bstride = _bwd_operands(name, q, k, v, do, lse, delta,
                                           bias)
    dq = torch.empty_like(q)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_bwd_dq(_ptr(dq), _ptr(q), _ptr(k), _ptr(v),
                                  _ptr(do), _ptr(lse), _ptr(delta),
                                  _ptr(bias), BH, q.shape[1], Sq, Sk, D,
                                  bstride, float(scale), int(bool(causal)),
                                  DTYPE_CODES[q.dtype], stream)
    _launched(name, counter, err, q, k)
    return dq


def _flash_bwd_dkv(name, counter, q, k, v, do, lse, delta, bias, scale,
                   causal):
    BH, Sq, Sk, D, bstride = _bwd_operands(name, q, k, v, do, lse, delta,
                                           bias)
    dbias = None
    if bias is not None:
        dbias = torch.empty(BH, Sk, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_bwd_dkv(_ptr(dk), _ptr(dv), _ptr(dbias), _ptr(q),
                                   _ptr(k), _ptr(v), _ptr(do), _ptr(lse),
                                   _ptr(delta), _ptr(bias), BH, q.shape[1],
                                   Sq, Sk, D, bstride, float(scale),
                                   int(bool(causal)), DTYPE_CODES[q.dtype],
                                   stream)
    _launched(name, counter, err, q, k)
    return dk, dv, dbias


def flash_bwd_dq(q, k, v, do, lse, delta, scale, causal):
    """K7 on the card: dq of the two-pass backward, given the forward's
    lse and K6's delta ([B*H, Sq] float32, which may be those of a larger
    attention: p is exp(s * scale - lse) over these keys, never
    renormalised) and the cotangent do [B, H, Sq, D]. Returns dq in q's
    dtype, bitwise reproducible (no atomics). bfloat16 and float16 run the
    tensor-core kernel of csrc/flash_bwd_dq_sm90.cu (K4's wgmma/TMA loop
    with dS.K in place of P.V; its rounded dS is formed as K9's),
    float32 the SIMT one of csrc/flash_bwd_two_pass.cu."""
    return _flash_bwd_dq("flash_bwd_dq", FLASH_BWD_DQ, q, k, v, do, lse,
                         delta, None, scale, causal)


def flash_bwd_dq_bias(q, k, v, do, lse, delta, bias, scale, causal):
    """K7 bias on the card: K7 with K4 bias's per-key bias [B or 1, Sk]
    float32, on the same two routes. Returns dq."""
    return _flash_bwd_dq("flash_bwd_dq_bias", FLASH_BWD_DQ_BIAS, q, k, v,
                         do, lse, delta, bias, scale, causal)


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal):
    """K8 on the card: dk and dv of the two-pass backward (arguments as
    `flash_bwd_dq`). Returns (dk, dv) in k's dtype, bitwise reproducible.
    bfloat16 and float16 run the tensor-core kernel of
    csrc/flash_bwd_sm90.cu (K9's body without its dq, so dk and dv equal
    K9's bit for bit),
    float32 the SIMT one of csrc/flash_bwd_two_pass.cu."""
    return _flash_bwd_dkv("flash_bwd_dkv", FLASH_BWD_DKV, q, k, v, do, lse,
                          delta, None, scale, causal)[:2]


def flash_bwd_dkv_bias(q, k, v, do, lse, delta, bias, scale, causal):
    """K8 bias on the card: K8 with the per-key bias [B or 1, Sk] float32,
    on the same two routes. Returns (dk, dv, dbias) with dbias [B*H, Sk]
    float32, the column sums of ds per (batch, head) row (the caller sums
    over heads, and over the batch when the bias broadcasts)."""
    return _flash_bwd_dkv("flash_bwd_dkv_bias", FLASH_BWD_DKV_BIAS, q, k, v,
                          do, lse, delta, bias, scale, causal)


__all__ = ["build", "library", "ragged_stream", "paged_decode",
           "decode_split_plan", "add_launches",
           "flash_fwd", "flash_delta", "flash_bwd", "flash_fwd_bias",
           "flash_bwd_bias", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_bwd_dq_bias", "flash_bwd_dkv_bias", "reset_launch_counts",
           "launch_counts", "KERNELS", "RAGGED_STREAM", "PAGED_DECODE",
           "FLASH_FWD", "FLASH_DELTA", "FLASH_BWD", "FLASH_FWD_BIAS",
           "FLASH_BWD_BIAS", "FLASH_BWD_DQ", "FLASH_BWD_DKV",
           "FLASH_BWD_DQ_BIAS", "FLASH_BWD_DKV_BIAS", "F16", "DTYPE_CODES",
           "POOL_DTYPE_CODES"]
