"""KV-payload wire format for planned session migration: the port's
copy of `paddle_tpu.fleet.migration` (host numpy, the same bytes).

`PagedKVCache.export_prefix` hands back a host-side payload (numpy
block contents — int8 codes + scales ride together under a quantized
pool — plus fills and the pool layout); this module is the WIRE half:
a self-describing bytes encoding (`serialize_kv_payload` /
`deserialize_kv_payload`) so a session's published K/V can cross a
process or host boundary and be re-published on the target pool via
`PagedKVCache.import_prefix`. In-process fleets round-trip through it
too — the router migrates through bytes on purpose, so the format
stays exercised.

Encoding: one uncompressed .npz (numpy's own container) holding a
JSON header under `__meta__` and each block leaf under a positional
key (`k{i}` / `v{i}` for a dense pool, `k{i}_codes` / `k{i}_scales`
etc. for int8 — the leaf structure is implied by kv_dtype, so no
pickling and no treedef on the wire).

Wire compression: a DENSE pool's blocks used to cross the wire at
full compute-dtype width — the one KV byte stream the int8 pool
didn't cover. `serialize_kv_payload` now quantizes dense block
contents to int8 codes + per-vector f32 scales (the exact
`inference/kv_quant` scheme: symmetric absmax per (layer, row, head)
vector, |x - deq| <= absmax/254 per element) and
`deserialize_kv_payload` decompresses back to the pool dtype, so
`import_prefix` and everything behind it see a dense payload again.
The round trip is TOLERANCE-GATED at the sender: if any vector fails
the absmax/254 bound (non-finite values are the only way) the payload
ships raw, flagged by the absence of `wire_dtype` in the header — the
receiver never guesses. int8 pools already ship codes+scales
bit-exactly and are untouched, as is the dead-source journal-replay
fallback (no payload, b""). Wire bytes are counted by
`fleet_migration_bytes_total{direction}` at both ends.
"""
from __future__ import annotations

import io
import json

import numpy as np

from ..observability import metrics as _metrics

_META = "__meta__"
_FIELDS = ("tokens", "block_size", "kv_dtype", "num_layers",
           "num_heads", "head_dim", "fills")

# per-element round-trip bound of the symmetric int8 scheme, as a
# fraction of each vector's absmax (see inference/kv_quant.py)
_WIRE_BOUND = 1.0 / 254.0

_m_migration_bytes = _metrics.counter(
    "fleet_migration_bytes_total",
    "KV migration payload bytes crossing the wire, by direction "
    "(export = serialized at the source, import = deserialized at "
    "the target)",
    labelnames=("direction",))


def _leaves(kv_dtype, arr):
    """Positional leaf list of one block's K or V content."""
    if kv_dtype == "int8":
        return [("codes", np.asarray(arr.codes)),
                ("scales", np.asarray(arr.scales))]
    return [("", np.asarray(arr))]


def _unleaves(kv_dtype, parts):
    if kv_dtype == "int8":
        from ..inference.kv_quant import QuantizedKV

        return QuantizedKV(parts["codes"], parts["scales"])
    return parts[""]


def _encode_wire(arr):
    """Quantize one dense block [L, BS, H, Dh] to (int8 codes, f32
    per-vector scales) for the wire. Returns None when the block
    fails the tolerance gate (non-finite content) — the caller ships
    raw."""
    x = np.asarray(arr, dtype=np.float32)
    if not np.isfinite(x).all():
        return None
    amax = np.max(np.abs(x), axis=-1)
    sc = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    codes = np.clip(np.rint(x / sc[..., None]), -127,
                    127).astype(np.int8)
    # tolerance gate: the symmetric scheme guarantees
    # |x - deq| <= absmax/254 per element in exact arithmetic — verify
    # (with a one-ulp f32 allowance on the divide/multiply round trip)
    # rather than assume, so a numerics regression ships raw instead
    # of corrupt
    err = np.abs(x - codes.astype(np.float32) * sc[..., None])
    bound = amax[..., None] * (_WIRE_BOUND * (1.0 + 1e-4) + 1e-6)
    if not (err <= bound + 1e-12).all():
        return None
    return codes, sc


def _decode_wire(codes, scales, dtype_str):
    x = codes.astype(np.float32) * scales[..., None]
    try:
        return x.astype(np.dtype(dtype_str))
    except TypeError:  # unknown dtype string (no ml_dtypes): the pool
        return x       # write casts on set



def serialize_kv_payload(payload, wire_compress=True):
    """`export_prefix` payload -> bytes (None passes through as b"" —
    a session with nothing cached migrates by journal replay).

    Dense payloads compress to int8 codes + per-vector scales on the
    wire by default (`wire_compress=False` pins the raw pre-round
    format); int8-pool payloads already ARE codes+scales and ship
    bit-exactly either way."""
    if payload is None:
        return b""
    meta = {f: payload[f] for f in _FIELDS}
    compress = bool(wire_compress) and payload["kv_dtype"] is None
    arrays = {}
    encoded = {}
    if compress:
        for side in ("k", "v"):
            for i, block in enumerate(payload[side]):
                enc = _encode_wire(block)
                if enc is None:       # tolerance gate: ship raw
                    compress = False
                    encoded.clear()
                    break
                encoded[(side, i)] = enc
            if not compress:
                break
    if compress:
        meta["wire_dtype"] = "int8"
        meta["dtype"] = str(np.asarray(payload["k"][0]).dtype)
        for (side, i), (codes, sc) in encoded.items():
            arrays[f"{side}{i}_codes"] = codes
            arrays[f"{side}{i}_scales"] = sc
    else:
        for side in ("k", "v"):
            for i, block in enumerate(payload[side]):
                for suffix, arr in _leaves(payload["kv_dtype"], block):
                    key = f"{side}{i}" + (f"_{suffix}" if suffix
                                          else "")
                    arrays[key] = arr
    buf = io.BytesIO()
    np.savez(buf, **arrays,
             **{_META: np.frombuffer(
                 json.dumps(meta).encode("utf-8"), np.uint8)})
    data = buf.getvalue()
    if _metrics.enabled():
        _m_migration_bytes.labels(direction="export").inc(len(data))
    return data


def deserialize_kv_payload(data):
    """bytes -> `import_prefix` payload (b"" -> None). Wire-compressed
    dense payloads decompress back to the pool dtype here, so the
    import path is format-agnostic."""
    if not data:
        return None
    if _metrics.enabled():
        _m_migration_bytes.labels(direction="import").inc(len(data))
    with np.load(io.BytesIO(data)) as z:
        meta = json.loads(bytes(z[_META]).decode("utf-8"))
        kv_dtype = meta["kv_dtype"]
        wire_dtype = meta.pop("wire_dtype", None)
        dtype_str = meta.pop("dtype", None)
        n = len(meta["fills"])
        out = dict(meta)
        for side in ("k", "v"):
            blocks = []
            for i in range(n):
                if wire_dtype == "int8":
                    blocks.append(_decode_wire(z[f"{side}{i}_codes"],
                                               z[f"{side}{i}_scales"],
                                               dtype_str))
                elif kv_dtype == "int8":
                    blocks.append(_unleaves(kv_dtype, {
                        "codes": z[f"{side}{i}_codes"],
                        "scales": z[f"{side}{i}_scales"]}))
                else:
                    blocks.append(_unleaves(kv_dtype,
                                            {"": z[f"{side}{i}"]}))
            out[side] = blocks
    return out
