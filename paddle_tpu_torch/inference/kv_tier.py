"""Host-RAM KV tier — the capacity layer below the device block pool.

The port of `paddle_tpu.inference.kv_tier`. `PagedKVCache` retention
parks cold published prefix blocks in the pool: they cost device memory
until pool pressure reclaims them, and a reclaim drops the cached
content. `HostKVTier` gives them a second chance: instead of dropping a
cold retained block's index entries, the cache DEMOTES the block to
host memory (this module) and frees the device slot; a later
`attach_prefix`/`match_prefix_len` whose chain continues into the tier
PROMOTES the blocks back into the pool before the attach claims them.

Tier format — int8 codes + per-vector scales (`kv_quant`):

  * int8 pools demote/promote their own codes and scales bit for bit
    (a round trip through the tier is the identity);
  * dense pools are encoded on the device on demote (`kv_encode`:
    per-vector absmax int8, |x - deq| <= absmax/254) and decoded on
    promote (`kv_decode`).

Payloads are `QuantizedKV` pairs of CPU tensors — page-locked when the
pool lives on a card, so a promotion's host-to-device copy runs
asynchronously on the current stream (the pool keeps each source alive
until the stream has passed its copy).

The tier is indexed storage: one entry per prefix-chain hash
(`kv_cache.prefix_block_hash`) with the entry's fill, parent hash and
the encoded K/V rows. The device cache drives every policy decision
(watermark demotion, promotion walks, disjointness of the device and
tier indexes); `capacity_blocks` bounds host memory with its own LRU —
a tier eviction is the end of the content.

Ownership invariant: a chain hash lives in EITHER the device index or
the tier index, never both, and tier entries never name device blocks.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


class HostKVTier:
    """Host-memory tier below one `PagedKVCache`.

    capacity_blocks: max resident tier entries (each holds <= one
        block's rows); the tier LRU-evicts past it.
    watermark: demotion trigger — whenever the device pool's free-list
        fraction drops below it, the cache demotes LRU retained blocks
        into the tier until the free fraction recovers (or no retained
        blocks remain). 0 disables pressure-driven demotion (an
        allocation's reclaim still demotes instead of dropping).
    """

    def __init__(self, capacity_blocks=256, watermark=0.25):
        self.capacity_blocks = int(capacity_blocks)
        if self.capacity_blocks < 1:
            raise ValueError(
                f"capacity_blocks must be >= 1, got {capacity_blocks}")
        self.watermark = float(watermark)
        if not 0.0 <= self.watermark < 1.0:
            raise ValueError(
                f"watermark must be in [0, 1), got {watermark}")
        # hash -> (fill, parent, k_payload, v_payload); insertion order
        # is the LRU (move_to_end on touch)
        self._entries: OrderedDict[int, tuple] = OrderedDict()
        # parent hash -> {fill: count}: the device index's candidate
        # fills walk, so a chain walk continues from device into tier
        self._child_fills: dict[int, dict[int, int]] = {}
        self.evictions = 0

    def __len__(self):
        return len(self._entries)

    def has(self, h):
        return h in self._entries

    def child_fills(self, parent):
        """Candidate fills published under `parent`."""
        return self._child_fills.get(parent)

    def put(self, h, fill, parent, k_payload, v_payload):
        """Store one demoted entry; first publisher wins (a duplicate
        hash keeps the resident copy and refreshes its LRU position).
        Returns the hashes the capacity LRU evicted."""
        if h in self._entries:
            self._entries.move_to_end(h)
            return []
        self._entries[h] = (int(fill), int(parent), k_payload, v_payload)
        fills = self._child_fills.setdefault(int(parent), {})
        fills[int(fill)] = fills.get(int(fill), 0) + 1
        evicted = []
        while len(self._entries) > self.capacity_blocks:
            old, ent = self._entries.popitem(last=False)
            self._unlink_fills(ent[0], ent[1])
            self.evictions += 1
            evicted.append(old)
        return evicted

    def _unlink_fills(self, fill, parent):
        fills = self._child_fills.get(parent)
        if fills is None:
            return
        left = fills.get(fill, 1) - 1
        if left > 0:
            fills[fill] = left
        else:
            fills.pop(fill, None)
            if not fills:
                del self._child_fills[parent]

    def get(self, h):
        """(fill, parent, k_payload, v_payload) or None; touches LRU."""
        ent = self._entries.get(h)
        if ent is not None:
            self._entries.move_to_end(h)
        return ent

    def pop(self, h):
        """Remove and return an entry (promotion takes ownership)."""
        ent = self._entries.pop(h, None)
        if ent is not None:
            self._unlink_fills(ent[0], ent[1])
        return ent

    def drop(self, h):
        """Discard a stale entry (the device re-published the hash)."""
        self.pop(h)

    def tokens_resident(self):
        return sum(ent[0] for ent in self._entries.values())

    def bytes_resident(self):
        return sum(payload_nbytes((kp, vp))
                   for _f, _p, kp, vp in self._entries.values())

    def stats(self):
        return {
            "capacity_blocks": self.capacity_blocks,
            "watermark": self.watermark,
            "tiered_blocks": len(self._entries),
            "tiered_tokens": self.tokens_resident(),
            "bytes_resident": self.bytes_resident(),
            "evictions": self.evictions,
        }


def _leaves(payload):
    """Flatten a payload: one array, a (codes, scales) `QuantizedKV`
    pair, or nested tuples/lists of them."""
    if hasattr(payload, "codes"):
        return (payload.codes, payload.scales)
    if isinstance(payload, (tuple, list)):
        out = []
        for p in payload:
            out.extend(_leaves(p))
        return out
    return (payload,)


def _nbytes(a):
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def payload_nbytes(payload):
    """Total bytes of one K/V payload tree (torch tensors or numpy
    arrays; plain, nested, or QuantizedKV codes + scales)."""
    return sum(_nbytes(a) for a in _leaves(payload))


def normalize_kv_tier(kv_tier):
    """The server's `kv_tier=` value: None/False stays off, True builds
    the default tier, an instance passes through."""
    if kv_tier is None or kv_tier is False:
        return None
    if kv_tier is True:
        return HostKVTier()
    if not isinstance(kv_tier, HostKVTier):
        raise TypeError(f"kv_tier must be a HostKVTier, True or None, "
                        f"got {type(kv_tier).__name__}")
    return kv_tier


def disabled_tier_stats():
    """The zeroed `stats()["tier"]` block of a pool without a tier (the
    same keys as with one)."""
    return {
        "enabled": False,
        "capacity_blocks": 0,
        "tiered_blocks": 0,
        "tiered_tokens": 0,
        "bytes_resident": 0,
        "demotions": 0,
        "promotions": 0,
        "evictions": 0,
        "bytes_out": 0,
        "bytes_in": 0,
        "hit_tokens": 0,
    }


__all__ = ["HostKVTier", "normalize_kv_tier", "disabled_tier_stats",
           "payload_nbytes"]
