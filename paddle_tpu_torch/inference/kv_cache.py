"""Paged KV cache — the block pool of the continuous-batching server.

K/V live in a pool of fixed-size blocks:

    k_blocks, v_blocks: [L, num_blocks, block_size, H, Dh]

Each sequence owns an ordered block table (a list of block ids); token
`t` of a sequence lives at (table[t // block_size], t % block_size).
Attention reads keys through the block table, masked by the sequence's
true length — never by token value.

Block 0 is the reserved trash block: it is never handed out, writers
route masked lanes (packing pads, idle decode slots) into it, and block
tables are padded with 0.

The pool is host-side bookkeeping on Python ints; the device tensors
are updated in place by the decoder programs (`nn.decode`), so there is
no `swap_arrays` step as in the reference. With
`kv_dtype="int8"` the pool holds int8 codes plus a per-vector scale
buffer (`kv_quant.QuantizedKV`) under the same block indices.

This is the core of `paddle_tpu.inference.kv_cache.PagedKVCache`:
allocation, growth, free and truncation. The prefix index, refcounted
sharing, copy-on-write, LRU retention and the host tier come with the
prefix-cache slice of the port.

Invariant: the free list and the union of live block tables PARTITION
the usable pool (blocks 1..num_blocks-1); block 0 is in neither.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .kv_quant import QuantizedKV


class BlockPoolExhausted(RuntimeError):
    """Raised when an allocation needs more free blocks than the pool
    has. `needed` blocks were requested, `available` could be had."""

    def __init__(self, msg, *, needed=-1, available=-1):
        super().__init__(msg)
        self.needed = int(needed)
        self.available = int(available)


def blocks_for(num_tokens: int, block_size: int) -> int:
    """Blocks needed to hold `num_tokens` tokens."""
    return max(0, -(-int(num_tokens) // int(block_size)))


class PagedKVCache:
    """Block-pool KV cache: fixed-size blocks, per-sequence block tables.

    num_layers/num_heads/head_dim: transformer shape (GPT-2 layout).
    block_size: tokens per block.
    num_blocks: pool size INCLUDING the reserved trash block 0, so the
        usable capacity is (num_blocks - 1) * block_size tokens.
    dtype: element dtype of a dense pool (float32 default), and of the
        scales of an int8 pool.
    kv_dtype: None (dense) or "int8" (codes + per-vector scales); pair
        it with `PagedDecoder(kv_dtype=...)`.
    device: None -> CUDA (raises when absent); "cpu" for the plain path.
    """

    def __init__(self, num_layers, num_heads, head_dim, *, block_size=128,
                 num_blocks=64, dtype=None, kv_dtype=None, device=None):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved trash block)")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                             "(supported: None, 'int8')")
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.kv_dtype = kv_dtype
        self.device = resolve_device(device)
        self.dtype = torch.float32 if dtype is None else dtype
        shape = (self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)

        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=self.device)

        if kv_dtype == "int8":
            self.k_blocks = QuantizedKV(zeros(shape, torch.int8),
                                        zeros(shape[:-1], self.dtype))
            self.v_blocks = QuantizedKV(zeros(shape, torch.int8),
                                        zeros(shape[:-1], self.dtype))
        else:
            self.k_blocks = zeros(shape, self.dtype)
            self.v_blocks = zeros(shape, self.dtype)
        # block 0 reserved: free list starts at 1 (popped from the end)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._tables: dict[object, list[int]] = {}
        self._lens: dict[object, int] = {}
        self._peak_blocks = 0

    # ---- pool bookkeeping (host-side) ---------------------------------
    @property
    def free_block_count(self):
        return len(self._free)

    @property
    def available_block_count(self):
        """Blocks an allocation can obtain (the free list: this core has
        no retained prefix blocks to reclaim)."""
        return len(self._free)

    @property
    def capacity_tokens(self):
        return (self.num_blocks - 1) * self.block_size

    @property
    def pool_bytes_total(self):
        """Device bytes held by the K/V pool tensors (codes + scales for
        an int8 pool)."""
        leaves = []
        for kv in (self.k_blocks, self.v_blocks):
            leaves.extend(kv if isinstance(kv, QuantizedKV) else (kv,))
        return sum(t.numel() * t.element_size() for t in leaves)

    def _get_table(self, seq_id, op):
        try:
            return self._tables[seq_id]
        except KeyError:
            raise KeyError(
                f"unknown sequence {seq_id!r} in {op}(): not allocated "
                f"in this cache (live sequences: {len(self._tables)})"
            ) from None

    def _take_blocks(self, n):
        taken = [self._free.pop() for _ in range(n)]
        used = self.num_blocks - 1 - len(self._free)
        self._peak_blocks = max(self._peak_blocks, used)
        return taken

    def allocate(self, seq_id, num_tokens):
        """Start a new sequence holding `num_tokens` tokens; returns its
        block table. Raises BlockPoolExhausted without side effects."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        self.ensure_many([(seq_id, num_tokens)])
        return list(self._tables[seq_id])

    def ensure(self, seq_id, num_tokens):
        """Grow `seq_id` so positions [0, num_tokens) have backing blocks
        (its length advances to num_tokens if that is longer)."""
        self._get_table(seq_id, "ensure")
        self.ensure_many([(seq_id, num_tokens)])
        return list(self._tables[seq_id])

    def ensure_many(self, updates):
        """Atomically create-or-grow several sequences so each covers its
        requested token count. `updates`: iterable of (seq_id,
        num_tokens). Either every sequence ends up covered, or — when
        the pool cannot hold the TOTAL demand — BlockPoolExhausted is
        raised with NO side effects."""
        updates = [(s, int(n)) for s, n in updates]
        need = []
        for seq_id, n in updates:
            grow = blocks_for(n, self.block_size) \
                - len(self._tables.get(seq_id, ()))
            need.append(max(0, grow))
        total = sum(need)
        if total > len(self._free):
            raise BlockPoolExhausted(
                f"need {total} blocks across {len(updates)} sequences, "
                f"only {len(self._free)} free (pool {self.num_blocks - 1})",
                needed=total, available=len(self._free))
        for (seq_id, n), grow in zip(updates, need):
            table = self._tables.setdefault(seq_id, [])
            if grow:
                table.extend(self._take_blocks(grow))
            self._lens[seq_id] = max(self._lens.get(seq_id, 0), n)

    def append(self, seq_id, n=1):
        """Reserve room for `n` more tokens; returns the (possibly grown)
        block table."""
        return self.ensure(seq_id, self.seq_len(seq_id) + int(n))

    def free(self, seq_id):
        """Release a sequence's blocks to the free list; returns how many
        table entries were released."""
        table = self._get_table(seq_id, "free")
        del self._tables[seq_id]
        del self._lens[seq_id]
        self._free.extend(reversed(table))
        return len(table)

    def truncate_seq(self, seq_id, new_len):
        """Roll a sequence back to `new_len` live tokens, releasing the
        tail blocks that no longer cover a live position. Rows >= new_len
        in the kept tail block become dead (masking is by length, and
        later writes overwrite them). Returns the entries released."""
        table = self._get_table(seq_id, "truncate_seq")
        new_len = int(new_len)
        cur = self._lens[seq_id]
        if new_len < 0 or new_len > cur:
            raise ValueError(
                f"cannot truncate sequence {seq_id!r} to {new_len}: "
                f"live length is {cur} (truncate_seq only rolls back)")
        keep = blocks_for(new_len, self.block_size)
        dropped = table[keep:]
        del table[keep:]
        self._lens[seq_id] = new_len
        self._free.extend(reversed(dropped))
        return len(dropped)

    def seq_len(self, seq_id):
        try:
            return self._lens[seq_id]
        except KeyError:
            raise KeyError(
                f"unknown sequence {seq_id!r} in seq_len(): not "
                f"allocated in this cache") from None

    def block_table(self, seq_id):
        return list(self._get_table(seq_id, "block_table"))

    def blocks_held(self, seq_id):
        """Blocks currently backing seq_id (0 if not yet allocated)."""
        return len(self._tables.get(seq_id, ()))

    def has_seq(self, seq_id):
        return seq_id in self._tables

    def table_array(self, seq_ids, width=None):
        """Dense int32 [len(seq_ids), width] block-table matrix (numpy);
        unused entries point at trash block 0, and a seq_id of None
        yields an all-trash row (an idle server slot)."""
        rows = [self._tables.get(s, []) if s is not None else []
                for s in seq_ids]
        if width is None:
            width = max((len(r) for r in rows), default=1) or 1
        out = np.zeros((len(rows), int(width)), np.int32)
        for i, r in enumerate(rows):
            if len(r) > width:
                raise ValueError(f"block table of {seq_ids[i]!r} "
                                 f"({len(r)}) exceeds width {width}")
            out[i, :len(r)] = r
        return out

    def block_fill(self):
        """Live tokens / allocated block capacity."""
        used = self.num_blocks - 1 - len(self._free)
        return sum(self._lens.values()) / ((used * self.block_size) or 1)

    def stats(self):
        used = self.num_blocks - 1 - len(self._free)
        held = sum(self._lens.values())
        return {
            "block_size": self.block_size,
            "num_blocks": self.num_blocks - 1,  # usable (trash excluded)
            "kv_dtype": self.kv_dtype or str(self.dtype).replace(
                "torch.", ""),
            "pool_bytes_total": self.pool_bytes_total,
            "used_blocks": used,
            "free_blocks": len(self._free),
            "peak_used_blocks": self._peak_blocks,
            "sequences": len(self._tables),
            "held_tokens": held,
            "utilization": held / (self.capacity_tokens or 1),
            "block_fill": held / ((used * self.block_size) or 1),
        }


__all__ = ["PagedKVCache", "BlockPoolExhausted", "blocks_for"]
