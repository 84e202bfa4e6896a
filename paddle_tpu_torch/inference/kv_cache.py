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
are updated in place by the decoder programs (`nn.decode`) and by the
pool's own block copies, so there is no `swap_arrays` step as in the
reference. With `kv_dtype="int8"` the pool holds int8 codes plus a
per-vector scale buffer (`kv_quant.QuantizedKV`) under the same block
indices, so every block operation below moves scales with their codes.

The port of `paddle_tpu.inference.kv_cache.PagedKVCache`, prefix cache
and host tier included:

  * Content addressing. A full block holding tokens B_i of a sequence
    whose earlier blocks hash to h_i-1 gets the rolling hash
    h_i = H(h_i-1, B_i) (`prefix_block_hash`, blake2b: the reference's
    integers). An index maps hash -> (block, fill, parent); blocks carry
    REFCOUNTS (the number of block tables holding them).
    `publish_prefix` indexes a prompt's blocks, its partial tail block
    with its fill; `attach_prefix` starts a new sequence on the longest
    cached chain by copying table entries.
  * Copy-on-write. Writing into a shared or index-claimed block goes
    through `prepare_write`, which copies the block on the device
    (`pool[:, new].copy_(pool[:, old])` on every leaf, in place and on
    the current stream: no host read) and swaps the table entry.
  * LRU retention. Freed blocks that still hold indexed content park in
    an LRU list and are reclaimed (entries dropped) only when an
    allocation would otherwise exhaust the pool.
  * Host tier. With a `kv_tier.HostKVTier` attached, pool pressure
    DEMOTES the LRU retained block instead: its entries move to the
    tier's host index (int8 codes + scales: an int8 pool's own bits, a
    dense pool's `kv_encode`) and the device slot frees. A later match
    whose chain continues into the tier PROMOTES those entries back
    (an asynchronous host-to-device write on the current stream, read
    by the next dispatch on the same stream). A demotion reads the
    device, so it runs only on release and reclaim paths, between
    dispatches.
  * `export_prefix`/`import_prefix` move a cached chain between pools
    in the reference's wire format (numpy arrays; a bf16 pool's rows
    travel as float32, which holds them exactly).

Telemetry: the reference's pool gauges and counters under its names
(`kv_pool_*`, `kv_prefix_cache_*`, `kv_tier_*`), one series per pool
(`pool` label, `name=` or "poolN"), pushed after every table change
while the metrics registry is enabled (one bool check otherwise). On a
sharded pool (`serving_dist`) the byte gauges also carry one series a
shard (`set_shard_count`).

Sharded pools. `local_heads`/`head_offset` make the device tensors hold
one tensor-parallel rank's heads [head_offset, head_offset +
local_heads); `groups` > 1 splits the block axis into `groups`
contiguous ranges of num_blocks / groups blocks (block g * num_blocks /
groups is group g's trash block, never handed out) and the tensors hold
only group `group`'s range. The host bookkeeping stays global (block ids
mean the same on every rank); a sequence allocates in the group
`set_seq_group` names, a prefix match stops at a block of another group,
and the device-side operations (copy-on-write, the tier's demote and
promote, import and export) act on this rank's slice only. `mirror`
(None here) is the hook through which the rank that plans replays each
device-side operation on the other ranks' slices (`serving_dist.engine.
PoolMirror`).

Attribution: with a `observability.attribution.ResourceLedger` on
`ledger` (the engine attaches it before the first allocation), every
non-free block has exactly one (tenant, rid) owner, assigned when
`_take_blocks` pulls it off the free list (`set_seq_owner` names who
pays for a sequence's growth) and closed when it returns there; a
demoted entry's host bytes stay its block owner's. Per-tenant block
counts then sum to the pool's occupancy whatever the sharing.

Invariants (fuzz-tested in tests/test_torch_prefix_cache.py, against
the reference pool step for step):
  * free list, retention list and the union of live block tables
    PARTITION the usable pool (blocks 1..num_blocks-1);
  * `_ref[b]` equals the number of live tables containing `b`;
  * an index entry only describes rows [0, fill) of its block, and
    those rows are immutable while the entry exists;
  * a chain hash lives in EITHER the device index or the tier index.
"""
from __future__ import annotations

import hashlib
import itertools
import time
from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device
from ..observability import metrics as _metrics
from .kv_quant import QuantizedKV, kv_decode, kv_encode
from .kv_tier import disabled_tier_stats, normalize_kv_tier, payload_nbytes

_POOL_LABEL = ("pool",)
# Block-count gauges carry a `tier` label: tier="device" is the in-pool
# series; tier="host" reports the HostKVTier (used is always 0 there,
# retained is its promotable entries, free its remaining capacity).
_POOL_TIER_LABELS = ("pool", "tier")
_m_used_blocks = _metrics.gauge(
    "kv_pool_used_blocks", "allocated blocks (trash block excluded); "
    "tier='device' in-pool, tier='host' always 0",
    labelnames=_POOL_TIER_LABELS)
_m_free_blocks = _metrics.gauge(
    "kv_pool_free_blocks", "blocks available for allocation "
    "(tier='host': remaining HostKVTier entry capacity)",
    labelnames=_POOL_TIER_LABELS)
_m_retained_blocks = _metrics.gauge(
    "kv_pool_retained_blocks", "freed-but-indexed blocks parked in the "
    "prefix-cache LRU retention list (reclaimed under pool pressure); "
    "tier='host': promotable entries resident in the HostKVTier",
    labelnames=_POOL_TIER_LABELS)
_m_utilization = _metrics.gauge(
    "kv_pool_utilization", "live tokens / usable pool tokens",
    labelnames=_POOL_LABEL)
_m_block_fill = _metrics.gauge(
    "kv_pool_block_fill", "live tokens / allocated block capacity "
    "(1.0 = no internal fragmentation; can exceed 1.0 when prefix "
    "blocks are shared)", labelnames=_POOL_LABEL)
_m_sequences = _metrics.gauge(
    "kv_pool_sequences", "sequences holding blocks",
    labelnames=_POOL_LABEL)
_m_alloc_failures = _metrics.counter(
    "kv_pool_alloc_failures_total",
    "allocations refused because the pool was exhausted",
    labelnames=_POOL_LABEL)
_POOL_SHARD_LABELS = ("pool", "shard")
_m_pool_bytes = _metrics.gauge(
    "kv_pool_bytes_total", "device bytes held by the K/V block pool "
    "(codes + scale buffers when kv_dtype='int8'); shard='all' = the "
    "pool total", labelnames=_POOL_SHARD_LABELS)
_m_bytes_per_token = _metrics.gauge(
    "kv_pool_bytes_per_token", "pool bytes per usable token slot "
    "(bytes_total / capacity_tokens — ~half under int8 KV)",
    labelnames=_POOL_SHARD_LABELS)
_m_prefix_lookups = _metrics.counter(
    "kv_prefix_cache_lookups_total",
    "attach_prefix calls (one per admitted request when caching is on)",
    labelnames=_POOL_LABEL)
_m_prefix_hits = _metrics.counter(
    "kv_prefix_cache_hits_total",
    "attach_prefix calls that matched at least one cached token",
    labelnames=_POOL_LABEL)
_m_prefix_hit_tokens = _metrics.counter(
    "kv_prefix_cache_hit_tokens_total",
    "prompt tokens served from cached blocks instead of prefill",
    labelnames=_POOL_LABEL)
_m_prefix_lookup_tokens = _metrics.counter(
    "kv_prefix_cache_lookup_tokens_total",
    "prompt tokens eligible for matching (prompt length - 1: the last "
    "token is always recomputed to sample token 0)",
    labelnames=_POOL_LABEL)
_m_prefix_evictions = _metrics.counter(
    "kv_prefix_cache_evictions_total",
    "retained blocks reclaimed (index entries dropped) under pool "
    "pressure", labelnames=_POOL_LABEL)
_m_prefix_cow = _metrics.counter(
    "kv_prefix_cache_cow_copies_total",
    "copy-on-write block copies (a write landed in a shared or "
    "index-claimed block)", labelnames=_POOL_LABEL)
_m_tier_demotions = _metrics.counter(
    "kv_tier_demotions_total",
    "retained blocks demoted from the device pool into the host tier",
    labelnames=_POOL_LABEL)
_m_tier_promotions = _metrics.counter(
    "kv_tier_promotions_total",
    "tier entries promoted back into device blocks ahead of a prefix "
    "match", labelnames=_POOL_LABEL)
_m_tier_bytes = _metrics.counter(
    "kv_tier_bytes_total",
    "host tier traffic in encoded (int8 codes+scales) bytes; "
    "direction='out' = device->host demotion, 'in' = host->device "
    "promotion", labelnames=("pool", "direction"))
_m_tier_hit_tokens = _metrics.counter(
    "kv_tier_hit_tokens_total",
    "prompt tokens served from promoted tier blocks instead of prefill "
    "recompute (counted once, at promotion)", labelnames=_POOL_LABEL)

_pool_ids = itertools.count()

#: parent hash of a sequence's first block (nothing hashes to 0).
ROOT_HASH = 0


class BlockPoolExhausted(RuntimeError):
    """Raised when an allocation needs more blocks than the pool can
    give after reclaiming every LRU-retained prefix block. `needed`
    blocks were requested, `available` could be had."""

    def __init__(self, msg, *, needed=-1, available=-1):
        super().__init__(msg)
        self.needed = int(needed)
        self.available = int(available)


def blocks_for(num_tokens: int, block_size: int) -> int:
    """Blocks needed to hold `num_tokens` tokens."""
    return max(0, -(-int(num_tokens) // int(block_size)))


def prefix_block_hash(parent: int, tokens) -> int:
    """Rolling content hash of one block: H(parent_hash, block_tokens),
    blake2b over the 16-byte little-endian parent and the tokens as
    int64 LE — the reference's function, so both give the same ints."""
    data = int(parent).to_bytes(16, "little") + \
        np.ascontiguousarray(np.asarray(tokens, np.int64)).tobytes()
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=16).digest(), "little")


def _leaves(kv):
    """(codes, scales) of an int8 pool or payload (any class with those
    fields: a reference payload carries its own), else the one array."""
    return (kv.codes, kv.scales) if hasattr(kv, "codes") else (kv,)


def _to_numpy(t):
    """A numpy copy of a pool slice, never a view of the pool (bf16,
    which numpy lacks, as float32: exact)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


def _from_numpy(a):
    """A CPU tensor of a payload array (a copy: wire arrays may be
    read-only; a bfloat16 numpy extension array comes as float32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


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
    tier: a `kv_tier.HostKVTier` below the pool (True for the default
        one); None keeps the pool without a tier.
    device: None -> CUDA (raises when absent); "cpu" for the plain path.
    name: the `pool` label of this pool's metric series (default
        "poolN", N counting the pools of the process).
    local_heads, head_offset, groups, group: a sharded pool's slice (see
        the module docstring); the defaults hold the whole pool.
    """

    def __init__(self, num_layers, num_heads, head_dim, *, block_size=128,
                 num_blocks=64, dtype=None, kv_dtype=None, tier=None,
                 device=None, name=None, local_heads=None, head_offset=0,
                 groups=1, group=0):
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
        self._name = str(name) if name else f"pool{next(_pool_ids)}"
        self.device = resolve_device(device)
        self.dtype = torch.float32 if dtype is None else dtype
        self.groups, self.group = int(groups), int(group)
        if self.num_blocks % self.groups:
            raise ValueError(f"num_blocks {self.num_blocks} does not split "
                             f"into {self.groups} block groups")
        self._gsize = self.num_blocks // self.groups
        self.local_heads = (self.num_heads if local_heads is None
                            else int(local_heads))
        self.head_offset = int(head_offset)
        shape = (self.num_layers, self._gsize, self.block_size,
                 self.local_heads, self.head_dim)

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
        # block 0 reserved (and each group's first block): the free list
        # starts at 1 (popped from the end)
        self._free = [b for b in range(self.num_blocks - 1, 0, -1)
                      if b % self._gsize]
        self._usable = self.num_blocks - self.groups
        self._seq_group: dict = {}     # seq -> block group (groups > 1)
        self._shard_count = 1          # ranks the pool is split over
        self.mirror = None
        self._tables: dict[object, list[int]] = {}
        self._lens: dict[object, int] = {}
        # prefix cache: refcounts (tables holding each block), the
        # content index hash -> (block, fill, parent), the reverse map
        # block -> entry hashes, candidate fills per parent hash, and
        # the LRU list of freed blocks that still hold indexed content
        self._ref: dict[int, int] = {}
        self._index: dict[int, tuple[int, int, int]] = {}
        self._block_entries: dict[int, set[int]] = {}
        self._child_fills: dict[int, dict[int, int]] = {}
        self._retained: OrderedDict[int, None] = OrderedDict()
        self._peak_blocks = 0
        self._peak_retained = 0
        self._prefix_lookups = 0
        self._prefix_hits = 0
        self._hit_tokens = 0
        self._lookup_tokens = 0
        self._evictions = 0
        self._cow_copies = 0
        # host tier: None = no tier
        self._tier = None
        #: optional callback(kind, **fields); kind is "demote",
        #: "promote" or "tier_promote" (one per promoting chain walk)
        self.on_tier_event = None
        self._tier_demotions = 0
        self._tier_promotions = 0
        self._tier_bytes_out = 0
        self._tier_bytes_in = 0
        self._tier_hit_tokens = 0
        # (event, payloads) of asynchronous host-to-device copies whose
        # page-locked sources must outlive the copy
        self._h2d_inflight: list = []
        # attribution: the engine's ResourceLedger (None = off) and the
        # single-owner maps it is charged through
        self.ledger = None
        self._seq_owner: dict = {}     # seq -> (tenant, rid)
        self._block_owner: dict = {}   # block -> (tenant, rid)
        self._tier_owner: dict = {}    # hash -> (tenant, bytes)
        if tier is not None:
            self.attach_tier(tier)

    # ---- pool bookkeeping (host-side) ---------------------------------
    @property
    def free_block_count(self):
        return len(self._free)

    @property
    def retained_block_count(self):
        return len(self._retained)

    @property
    def available_block_count(self):
        """Blocks an allocation can obtain: the free list plus the
        LRU-retained blocks it may reclaim (a demotion moves a block
        retained -> free, so the sum is unchanged by the tier)."""
        return len(self._free) + len(self._retained)

    @property
    def capacity_tokens(self):
        return self._usable * self.block_size

    @property
    def pool_bytes_per_shard(self):
        """Device bytes held by THIS pool's K/V tensors (codes + scales
        for an int8 pool): one rank's slice of a sharded pool."""
        return sum(t.numel() * t.element_size()
                   for kv in (self.k_blocks, self.v_blocks)
                   for t in _leaves(kv))

    @property
    def pool_bytes_total(self):
        """Device bytes of the whole pool: this slice times the shards
        (`set_shard_count`; the slices are equal)."""
        return self.pool_bytes_per_shard * self._shard_count

    def set_shard_count(self, n):
        """Record over how many ranks the pool is split (tp * dp): the
        byte gauges then also report one series a shard."""
        n = int(n)
        if n < 1:
            raise ValueError(f"shard count must be >= 1, got {n}")
        self._shard_count = n
        self._push_gauges()

    @property
    def scale_bytes(self):
        """Bytes of the per-vector scale buffers (0 for a dense pool): the
        quantization's overhead on top of the int8 codes."""
        if self.kv_dtype != "int8":
            return 0
        return self._shard_count * sum(
            t.numel() * t.element_size()
            for t in (self.k_blocks.scales, self.v_blocks.scales))

    @property
    def bytes_per_token(self):
        """Pool bytes per usable token slot (the trash block's share
        included)."""
        return self.pool_bytes_total / (self.capacity_tokens or 1)

    def stats_kv_dtype(self):
        """The stored element dtype as a stats string: "int8" for a
        quantized pool, else the dense dtype's name."""
        return self.kv_dtype or str(self.dtype).replace("torch.", "")

    def _pool_leaves(self):
        return _leaves(self.k_blocks) + _leaves(self.v_blocks)

    def _get_table(self, seq_id, op):
        try:
            return self._tables[seq_id]
        except KeyError:
            raise KeyError(
                f"unknown sequence {seq_id!r} in {op}(): not allocated "
                f"in this cache (live sequences: {len(self._tables)})"
            ) from None

    def set_seq_owner(self, seq_id, tenant, rid=None):
        """Name who pays for `seq_id`'s future allocations (attribution;
        the engine calls this at slot install, before the first growth).
        Unowned sequences charge the "default" tenant. Cleared by
        `free`."""
        self._seq_owner[seq_id] = (str(tenant), rid)

    def _ledger_block_freed(self, b):
        """A block re-entered the free list: close its ownership."""
        own = self._block_owner.pop(b, None)
        if own is not None and self.ledger is not None:
            self.ledger.block_event(own[0], own[1], -1)

    def _ledger_tier_add(self, h, tenant, nbytes):
        if self.ledger is None or h in self._tier_owner:
            return
        self._tier_owner[h] = (tenant, nbytes)
        self.ledger.host_bytes_event(tenant, nbytes)

    def _ledger_tier_drop(self, h):
        own = self._tier_owner.pop(h, None)
        if own is not None and self.ledger is not None:
            self.ledger.host_bytes_event(own[0], -own[1])

    # ---- block groups (a dp-sharded pool) -------------------------------
    def local_block(self, b):
        """This rank's index of global block `b`, None when another
        group holds it."""
        g, off = divmod(int(b), self._gsize)
        return off if g == self.group else None

    def set_seq_group(self, seq_id, group):
        """The block group `seq_id` allocates in (groups > 1)."""
        self._seq_group[seq_id] = int(group)

    def _free_in(self, g):
        if self.groups == 1:
            return len(self._free)
        return sum(1 for b in self._free if b // self._gsize == g)

    def _retained_in(self, g):
        if self.groups == 1:
            return len(self._retained)
        return sum(1 for b in self._retained if b // self._gsize == g)

    def available_in(self, g):
        """Blocks an allocation in group `g` can obtain (free plus
        reclaimable); the whole pool's with one group."""
        return self._free_in(g) + self._retained_in(g)

    def _pop_free(self, g):
        if self.groups == 1:
            return self._free.pop()
        for i in range(len(self._free) - 1, -1, -1):
            if self._free[i] // self._gsize == g:
                return self._free.pop(i)
        raise AssertionError("no free block in group %d" % g)

    def _take_blocks(self, n, owner=None, group=0):
        """Pop `n` blocks of block group `group` off the free list
        (refcount 1 each), reclaiming LRU-retained blocks as needed.
        Callers that need all-or-nothing semantics pre-check
        availability. `owner` is the (tenant, rid) charged while the
        blocks stay off the free list."""
        while self._free_in(group) < n and self._retained_in(group):
            self._reclaim_lru(group)
        if n > self._free_in(group):
            _m_alloc_failures.labels(pool=self._name).inc()
            raise BlockPoolExhausted(
                f"need {n} blocks, only {self._free_in(group)} free "
                f"(pool {self._usable})",
                needed=n, available=self._free_in(group))
        taken = [self._pop_free(group) for _ in range(n)]
        for b in taken:
            self._ref[b] = 1
        if self.ledger is not None and taken:
            tenant, rid = owner if owner is not None else ("default", None)
            for b in taken:
                self._block_owner[b] = (tenant, rid)
            self.ledger.block_event(tenant, rid, len(taken))
        used = self._usable - len(self._free) - len(self._retained)
        self._peak_blocks = max(self._peak_blocks, used)
        return taken

    def _release_block(self, b):
        """Drop one table reference to `b`; at refcount zero the block
        parks in retention if the index names it, else frees."""
        left = self._ref.get(b, 0) - 1
        if left > 0:
            self._ref[b] = left
            return
        self._ref.pop(b, None)
        if self._block_entries.get(b):
            self._retained[b] = None
            self._retained.move_to_end(b)
            self._peak_retained = max(self._peak_retained,
                                      len(self._retained))
        else:
            self._free.append(b)
            self._ledger_block_freed(b)

    def _reclaim_lru(self, group=0):
        """Evict the least recently retained block (of `group` when the
        pool has several): drop its entries and free it — or, with a
        tier, demote it."""
        if self._tier is not None:
            self._demote_lru()
            return
        if self.groups == 1:
            b, _ = self._retained.popitem(last=False)
        else:
            b = next(x for x in self._retained if x // self._gsize == group)
            del self._retained[b]
        for h in list(self._block_entries.get(b, ())):
            self._drop_entry(h)
        self._free.append(b)
        self._ledger_block_freed(b)
        self._evictions += 1
        _m_prefix_evictions.labels(pool=self._name).inc()

    def _register_entry(self, h, block, fill, parent):
        self._index[h] = (block, fill, parent)
        self._block_entries.setdefault(block, set()).add(h)
        fills = self._child_fills.setdefault(parent, {})
        fills[fill] = fills.get(fill, 0) + 1
        if self._tier is not None and self._tier.has(h):
            # a hash never lives in both indexes: the device copy wins
            self._tier.drop(h)
            self._ledger_tier_drop(h)
            if self.mirror is not None:
                self.mirror.tier_forget([h])

    def _drop_entry(self, h):
        block, fill, parent = self._index.pop(h)
        ents = self._block_entries.get(block)
        if ents is not None:
            ents.discard(h)
            if not ents:
                del self._block_entries[block]
        fills = self._child_fills.get(parent)
        if fills is not None:
            left = fills.get(fill, 1) - 1
            if left > 0:
                fills[fill] = left
            else:
                fills.pop(fill, None)
                if not fills:
                    del self._child_fills[parent]

    # ---- host tier ------------------------------------------------------
    def attach_tier(self, tier):
        """Attach a `kv_tier.HostKVTier` below this pool (True builds the
        default tier; None detaches and forgets the tier's content).
        Returns the attached tier or None."""
        self._tier = normalize_kv_tier(tier)
        if self._tier is None:
            for h in list(self._tier_owner):  # forgotten content is
                self._ledger_tier_drop(h)     # no longer anyone's cost
        return self._tier

    @property
    def tier(self):
        return self._tier

    def _to_host(self, t):
        """A host copy of a device slice: page-locked when the pool is on
        a card (the copy waits for the device: a host sync)."""
        if self.device.type != "cuda":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
        return out

    def _tier_grab(self, b, fill):
        """Host copy of rows [0, fill) of block `b` in the tier codec: an
        int8 pool's own codes and scales, a dense pool's `kv_encode`
        (run on the device first)."""
        b = self.local_block(b)

        def grab(arr):
            if self.kv_dtype == "int8":
                codes, scales = arr.codes[:, b, :fill], arr.scales[:, b, :fill]
            else:
                codes, scales = kv_encode(arr[:, b, :fill])
            return QuantizedKV(self._to_host(codes), self._to_host(scales))
        return grab(self.k_blocks), grab(self.v_blocks)

    def _tier_install(self, b, fill, k_pay, v_pay):
        """Write a tier payload into rows [0, fill) of block `b`, on the
        current stream (asynchronous from page-locked memory: the next
        dispatch on the stream reads it in order)."""
        dev = self.device
        cuda = dev.type == "cuda"
        b = self.local_block(b)

        def h2d(t):
            return t.to(dev, non_blocking=cuda)

        for arr, pay in ((self.k_blocks, k_pay), (self.v_blocks, v_pay)):
            if self.kv_dtype == "int8":
                arr.codes[:, b, :fill].copy_(pay.codes, non_blocking=cuda)
                arr.scales[:, b, :fill].copy_(pay.scales, non_blocking=cuda)
            else:
                arr[:, b, :fill] = kv_decode(h2d(pay.codes),
                                             h2d(pay.scales), arr.dtype)
        if cuda:
            self._h2d_inflight = [(ev, p) for ev, p in self._h2d_inflight
                                  if not ev.query()]
            ev = torch.cuda.Event()
            ev.record()
            self._h2d_inflight.append((ev, (k_pay, v_pay)))

    def _demote_lru(self):
        """Demote the LRU retained block: every index entry on it moves
        to the tier with a host copy of its rows, and the device slot
        frees."""
        b, _ = self._retained.popitem(last=False)
        owner = self._block_owner.get(b, ("default", None))
        moved = 0
        nbytes = 0
        for h in list(self._block_entries.get(b, ())):
            _blk, fill, parent = self._index[h]
            kp, vp = self._tier_grab(b, fill)
            evicted = self._tier.put(h, fill, parent, kp, vp)
            if self.mirror is not None:
                self.mirror.tier_put(h, b, fill)
                self.mirror.tier_forget(evicted)
            per = payload_nbytes((kp, vp))
            nbytes += per
            # the demoting block's owner keeps paying, in host
            # byte-seconds; a capacity eviction ends the old owner's
            self._ledger_tier_add(h, owner[0], per)
            for old in evicted:
                self._ledger_tier_drop(old)
            self._drop_entry(h)
            moved += 1
        self._free.append(b)
        self._ledger_block_freed(b)
        self._tier_demotions += 1
        self._tier_bytes_out += nbytes
        if _metrics.enabled():
            _m_tier_demotions.labels(pool=self._name).inc()
            _m_tier_bytes.labels(pool=self._name,
                                 direction="out").inc(nbytes)
        cb = self.on_tier_event
        if cb is not None:
            cb("demote", block=b, entries=moved, bytes=nbytes)

    def maybe_demote(self):
        """Watermark sweep: while the free list is below the tier's
        watermark of the usable pool and retained blocks remain, demote
        the coldest. Returns blocks demoted (0 without a tier)."""
        if self._tier is None or self._tier.watermark <= 0:
            return 0
        low = int(self._tier.watermark * self._usable)
        n = 0
        while len(self._free) < low and self._retained:
            self._demote_lru()
            n += 1
        return n

    def demote_cold(self, n=1):
        """Demote up to `n` LRU retained blocks to the tier. Returns
        blocks demoted."""
        moved = 0
        while (moved < int(n) and self._retained
               and self._tier is not None):
            self._demote_lru()
            moved += 1
        return moved

    def _promote_entry(self, h):
        """Pull one tier entry back into a device block (registered and
        parked in retention, MRU). Returns the payload bytes, 0 when the
        device re-published the hash meanwhile, None when the entry is
        gone or no block is obtainable."""
        ent = self._tier.get(h)
        if ent is None:
            return None
        if h in self._index:
            self._tier.drop(h)
            self._ledger_tier_drop(h)
            if self.mirror is not None:
                self.mirror.tier_forget([h])
            return 0
        if self.available_block_count < 1:
            return None
        fill, parent, kp, vp = ent
        # the promoted block belongs to whoever paid for the tier entry
        # (the demoter), not to whoever triggered the match
        own = self._tier_owner.get(h)
        b = self._take_blocks(
            1, owner=(own[0], None) if own is not None else None)[0]
        self._tier_install(b, fill, kp, vp)
        if self.mirror is not None:
            self.mirror.tier_take(h, b, fill)
        self._tier.pop(h)
        self._ledger_tier_drop(h)
        self._register_entry(h, b, fill, parent)
        self._release_block(b)  # refcount 0 + indexed -> retention MRU
        nbytes = payload_nbytes((kp, vp))
        self._tier_promotions += 1
        self._tier_bytes_in += nbytes
        if _metrics.enabled():
            _m_tier_promotions.labels(pool=self._name).inc()
            _m_tier_bytes.labels(pool=self._name,
                                 direction="in").inc(nbytes)
        cb = self.on_tier_event
        if cb is not None:
            cb("promote", block=b, tokens=fill, bytes=nbytes)
        return nbytes

    def _walk_device(self, ids, max_match):
        """The device half of a promotion walk: (hash at the chain's end,
        position), or None when a partial block ends the chain."""
        n = int(ids.size)
        h = ROOT_HASH
        pos = 0
        while pos < max_match:
            cand = self._child_fills.get(h)
            hit = None
            if cand:
                for f in sorted(cand, reverse=True):
                    if f > n - pos:
                        continue
                    hh = prefix_block_hash(h, ids[pos:pos + f])
                    if hh in self._index:
                        hit = (hh, f)
                        break
            if hit is None:
                break
            hh, f = hit
            use = min(f, max_match - pos)
            pos += use
            if f < self.block_size or use < f:
                return None
            h = hh
        return h, pos

    def _promote_for(self, ids, max_match, limit_blocks=None,
                     overlapped=False, collect=None):
        """Walk the device chain along `ids` to its end, then continue
        through the tier index, promoting each tiered entry so the match
        that follows sees one device chain. Returns tokens promoted."""
        if self._tier is None or not len(self._tier):
            return 0
        walked = self._walk_device(ids, max_match)
        if walked is None:
            return 0
        h, pos = walked
        n = int(ids.size)
        promoted_tokens = 0
        blocks = 0
        nbytes = 0
        t0 = time.perf_counter()
        while pos < max_match:
            if limit_blocks is not None and blocks >= int(limit_blocks):
                break
            cand = self._tier.child_fills(h)
            hit = None
            if cand:
                for f in sorted(cand, reverse=True):
                    if f > n - pos:
                        continue
                    hh = prefix_block_hash(h, ids[pos:pos + f])
                    if self._tier.has(hh):
                        hit = (hh, f)
                        break
            if hit is None:
                break
            hh, f = hit
            nb = self._promote_entry(hh)
            if nb is None:
                break          # pool full: serve what promoted so far
            if nb > 0:
                blocks += 1
                nbytes += nb
                if collect is not None:
                    collect.append(hh)
            use = min(f, max_match - pos)
            promoted_tokens += use
            pos += use
            if f < self.block_size or use < f:
                break
            h = hh
        if blocks:
            cb = self.on_tier_event
            if cb is not None:
                cb("tier_promote", blocks=blocks, tokens=promoted_tokens,
                   bytes=nbytes, dur_s=time.perf_counter() - t0,
                   overlapped=bool(overlapped))
        self._tier_hit_tokens += promoted_tokens
        if promoted_tokens and _metrics.enabled():
            _m_tier_hit_tokens.labels(pool=self._name).inc(
                promoted_tokens)
        return promoted_tokens

    def prefetch_promote(self, ids, limit_blocks=None):
        """Promote the tiered chain tail for `ids` now (ahead of an
        attach). `limit_blocks` caps the device blocks one call may
        take. Returns (hashes, tokens, bytes) promoted."""
        ids = np.asarray(ids).reshape(-1)
        hashes: list = []
        before = self._tier_bytes_in
        tokens = self._promote_for(
            ids, int(ids.size) - 1, limit_blocks=limit_blocks,
            overlapped=True, collect=hashes)
        return hashes, tokens, self._tier_bytes_in - before

    def device_resident_count(self, hashes):
        """How many of `hashes` are in the device index now."""
        return sum(1 for h in hashes if h in self._index)

    # ---- allocation -----------------------------------------------------
    def _push_gauges(self):
        if not _metrics.enabled():  # keep the hot path one branch
            return
        p = self._name
        used = self._usable - len(self._free) - len(self._retained)
        held = sum(self._lens.values())
        _m_used_blocks.labels(pool=p, tier="device").set(used)
        _m_free_blocks.labels(pool=p, tier="device").set(len(self._free))
        _m_retained_blocks.labels(pool=p,
                                  tier="device").set(len(self._retained))
        if self._tier is not None:
            t = self._tier
            _m_used_blocks.labels(pool=p, tier="host").set(0)
            _m_free_blocks.labels(pool=p, tier="host").set(
                max(0, t.capacity_blocks - len(t)))
            _m_retained_blocks.labels(pool=p, tier="host").set(len(t))
        _m_sequences.labels(pool=p).set(len(self._tables))
        _m_utilization.labels(pool=p).set(held / (self.capacity_tokens
                                                  or 1))
        _m_block_fill.labels(pool=p).set(
            held / ((used * self.block_size) or 1))
        _m_pool_bytes.labels(pool=p, shard="all").set(
            self.pool_bytes_total)
        _m_bytes_per_token.labels(pool=p, shard="all").set(
            self.bytes_per_token)
        if self._shard_count > 1:
            # each rank's slice: 1/n of the pool's bytes
            per = self.pool_bytes_per_shard
            per_tok = self.bytes_per_token / self._shard_count
            for r in range(self._shard_count):
                _m_pool_bytes.labels(pool=p, shard=str(r)).set(per)
                _m_bytes_per_token.labels(pool=p, shard=str(r)).set(per_tok)

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
        the pool cannot hold the TOTAL demand even after reclaiming
        every retained block — BlockPoolExhausted is raised with NO side
        effects."""
        updates = [(s, int(n)) for s, n in updates]
        need = []
        by_group: dict = {}
        for seq_id, n in updates:
            grow = blocks_for(n, self.block_size) \
                - len(self._tables.get(seq_id, ()))
            need.append(max(0, grow))
            g = self._seq_group.get(seq_id, 0)
            by_group[g] = by_group.get(g, 0) + max(0, grow)
        for g, total in by_group.items():
            if total > self.available_in(g):
                _m_alloc_failures.labels(pool=self._name).inc()
                raise BlockPoolExhausted(
                    f"need {total} blocks across {len(updates)} "
                    f"sequences, only {self._free_in(g)} free + "
                    f"{self._retained_in(g)} reclaimable (pool "
                    f"{self._usable})",
                    needed=total, available=self.available_in(g))
        for (seq_id, n), grow in zip(updates, need):
            table = self._tables.setdefault(seq_id, [])
            if grow:
                table.extend(self._take_blocks(
                    grow, owner=self._seq_owner.get(seq_id),
                    group=self._seq_group.get(seq_id, 0)))
            self._lens[seq_id] = max(self._lens.get(seq_id, 0), n)
        self.maybe_demote()
        self._push_gauges()

    def append(self, seq_id, n=1):
        """Reserve room for `n` more tokens; returns the (possibly grown)
        block table."""
        return self.ensure(seq_id, self.seq_len(seq_id) + int(n))

    def free(self, seq_id):
        """Release a sequence's blocks (refcount-aware: shared blocks stay
        for their other referents, indexed ones park in retention);
        returns how many table entries were released."""
        table = self._get_table(seq_id, "free")
        del self._tables[seq_id]
        del self._lens[seq_id]
        self._seq_owner.pop(seq_id, None)
        self._seq_group.pop(seq_id, None)
        for b in reversed(table):
            self._release_block(b)
        self.maybe_demote()
        self._push_gauges()
        return len(table)

    def truncate_seq(self, seq_id, new_len):
        """Roll a sequence back to `new_len` live tokens, releasing
        (refcount-aware) the tail blocks that no longer cover a live
        position. Rows >= new_len in the kept tail block become dead
        (masking is by length, and later writes overwrite them; an entry
        only claims rows below its fill, and only prompt tokens are ever
        published). Returns the entries released."""
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
        for b in reversed(dropped):
            self._release_block(b)
        self.maybe_demote()
        self._push_gauges()
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

    # ---- prefix cache ---------------------------------------------------
    def _match_chain(self, ids, max_match, group=None):
        """The longest chain of cached blocks covering a prefix of
        ids[:max_match]: (blocks, fills, pos), fills[i] the tokens block
        i contributes (a partial tail or the cap ends the chain; with
        `group` given, a block of another group ends it too).
        Read-only."""
        matched: list[int] = []
        fills: list[int] = []
        h = ROOT_HASH
        pos = 0
        n = int(ids.size)
        while pos < max_match:
            cand = self._child_fills.get(h)
            if not cand:
                break
            hit = None
            for f in sorted(cand, reverse=True):  # longest match first
                if f > n - pos:
                    continue
                hh = prefix_block_hash(h, ids[pos:pos + f])
                ent = self._index.get(hh)
                if ent is not None:
                    hit = (hh, ent[0], f)
                    break
            if hit is None:
                break
            hh, block, f = hit
            if group is not None and block // self._gsize != group:
                break
            use = min(f, max_match - pos)
            matched.append(block)
            fills.append(use)
            pos += use
            if f < self.block_size or use < f:
                break
            h = hh
        return matched, fills, pos

    def match_prefix_len(self, token_ids):
        """How many tokens of `token_ids` an `attach_prefix` would serve
        from cache now (capped at len - 1), claiming nothing and moving
        no counter — but a chain that continues into the tier is
        promoted first."""
        ids = np.asarray(token_ids).reshape(-1)
        self._promote_for(ids, int(ids.size) - 1)
        return self._match_chain(ids, int(ids.size) - 1)[2]

    def attach_prefix(self, seq_id, token_ids):
        """Start `seq_id` on the longest cached chain matching
        `token_ids` (refcount bump, no device work). Returns the cached
        token count; 0 means no match and the sequence is NOT created.
        At most len - 1 tokens match: the last prompt token is left to
        the prefill, which samples token 0 from it. A match may end
        mid-block; the sequence's first write there goes through
        `prepare_write`."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        ids = np.asarray(token_ids).reshape(-1)
        max_match = int(ids.size) - 1
        self._prefix_lookups += 1
        self._lookup_tokens += max(0, max_match)
        if _metrics.enabled():
            _m_prefix_lookups.labels(pool=self._name).inc()
            _m_prefix_lookup_tokens.labels(pool=self._name).inc(
                max(0, max_match))
        self._promote_for(ids, max_match)
        matched, _fills, pos = self._match_chain(
            ids, max_match, self._seq_group.get(seq_id, 0)
            if self.groups > 1 else None)
        if pos == 0:
            return 0
        for b in matched:              # claim the chain
            r = self._ref.get(b, 0)
            if r == 0:                 # parked in retention: revive
                self._retained.pop(b, None)
            self._ref[b] = r + 1
        self._tables[seq_id] = matched
        self._lens[seq_id] = pos
        self._prefix_hits += 1
        self._hit_tokens += pos
        if _metrics.enabled():
            _m_prefix_hits.labels(pool=self._name).inc()
            _m_prefix_hit_tokens.labels(pool=self._name).inc(pos)
        self._push_gauges()
        return pos

    def publish_prefix(self, seq_id, token_ids):
        """Index `seq_id`'s blocks under their rolling hashes, once the
        K/V of `token_ids` has been written. Full blocks chain; a partial
        tail block is indexed with its fill. An existing hash keeps its
        block (first publisher wins)."""
        table = self._get_table(seq_id, "publish_prefix")
        ids = np.asarray(token_ids).reshape(-1)
        n = int(ids.size)
        if n > self._lens[seq_id]:
            raise ValueError(
                f"cannot publish {n} tokens for sequence {seq_id!r}: "
                f"only {self._lens[seq_id]} are live")
        bs = self.block_size
        h = ROOT_HASH
        nfull = n // bs
        for i in range(nfull):
            hh = prefix_block_hash(h, ids[i * bs:(i + 1) * bs])
            if hh not in self._index:
                self._register_entry(hh, table[i], bs, h)
            h = hh
        fill = n - nfull * bs
        if fill:
            hh = prefix_block_hash(h, ids[nfull * bs:])
            if hh not in self._index:
                self._register_entry(hh, table[nfull], fill, h)

    def prepare_write(self, seq_id, pos):
        """Make the block holding position `pos` exclusively writable for
        `seq_id` before a dispatch writes K/V there. If the block is
        shared (refcount > 1) or an index entry claims rows at or after
        `pos`, it is copied on the device (every leaf, codes and scales
        together, on the current stream) and the table entry swapped.
        With no spare block and the sequence the sole referent, the
        claiming entries are dropped and the write goes in place.
        Returns True iff a copy happened."""
        table = self._get_table(seq_id, "prepare_write")
        bi = int(pos) // self.block_size
        if bi >= len(table):
            return False               # growth region: nothing cached
        block = table[bi]
        row = int(pos) % self.block_size
        shared = self._ref.get(block, 0) > 1
        blocking = [h for h in self._block_entries.get(block, ())
                    if self._index[h][1] > row]
        if not shared and not blocking:
            return False
        g = self._seq_group.get(seq_id, 0)
        if self.available_in(g) >= 1:
            new = self._take_blocks(
                1, owner=self._seq_owner.get(seq_id), group=g)[0]
            self.copy_block(block, new)
            if self.mirror is not None:
                self.mirror.copy_block(block, new)
            table[bi] = new
            self._release_block(block)
            self._cow_copies += 1
            _m_prefix_cow.labels(pool=self._name).inc()
            self._push_gauges()
            return True
        if shared:
            _m_alloc_failures.labels(pool=self._name).inc()
            raise BlockPoolExhausted(
                f"copy-on-write for sequence {seq_id!r} at position "
                f"{pos} needs 1 block, pool exhausted "
                f"(pool {self._usable})", needed=1, available=0)
        for h in blocking:             # sole referent: cede the entries
            self._drop_entry(h)
        return False

    def copy_block(self, src, dst):
        """Copy block `src` to `dst` on the device (every leaf, codes and
        scales together, on the current stream) — on this rank's slice,
        when its group holds them."""
        src, dst = self.local_block(src), self.local_block(dst)
        if src is None or dst is None:
            return
        for a in self._pool_leaves():
            a[:, dst].copy_(a[:, src])

    def swap_out_seq(self, seq_id, token_ids):
        """Publish the sequence's live K/V prefix (the first
        `seq_len(seq_id)` of `token_ids`), then release its blocks; they
        park in retention, so a later attach of the same stream resumes
        it. Returns the tokens published."""
        live = self.seq_len(seq_id)
        ids = np.asarray(token_ids).reshape(-1)
        if live > ids.size:
            raise ValueError(
                f"swap_out_seq of {seq_id!r}: {live} live tokens but "
                f"only {ids.size} token ids supplied")
        if live > 0:
            self.publish_prefix(seq_id, ids[:live])
        self.free(seq_id)
        return live

    # ---- migration between pools ----------------------------------------
    def export_prefix(self, token_ids):
        """The longest cached chain matching `token_ids` as the
        reference's wire payload: numpy copies of the whole blocks (an
        int8 pool's as `QuantizedKV` pairs of numpy arrays), fills and
        the pool layout. A chain continuing into the tier is promoted
        first. None when nothing matches."""
        ids = np.asarray(token_ids).reshape(-1)
        self._promote_for(ids, int(ids.size))
        blocks, fills, pos = self._match_chain(ids, int(ids.size))
        if pos == 0:
            return None

        if self.mirror is not None:
            ks, vs = self.mirror.export_blocks(blocks)
        else:
            ks = [self.block_arrays(self.k_blocks, b) for b in blocks]
            vs = [self.block_arrays(self.v_blocks, b) for b in blocks]
        return {
            "tokens": [int(t) for t in ids[:pos]],
            "block_size": self.block_size,
            "kv_dtype": self.kv_dtype,
            "num_layers": self.num_layers,
            "num_heads": self.num_heads,
            "head_dim": self.head_dim,
            "fills": list(fills),
            "k": ks,
            "v": vs,
        }

    def block_arrays(self, arr, b):
        """numpy copies of this rank's slice of block `b` of one pool
        tensor (an int8 pool's as a `QuantizedKV` pair)."""
        b = self.local_block(b)
        if self.kv_dtype == "int8":
            return QuantizedKV(_to_numpy(arr.codes[:, b]),
                               _to_numpy(arr.scales[:, b]))
        return _to_numpy(arr[:, b])

    def write_payload_block(self, b, pk, pv):
        """Write one payload block (all heads) into this rank's slice of
        block `b`: its heads, when its group holds the block."""
        b = self.local_block(b)
        if b is None:
            return
        h0, hl = self.head_offset, self.local_heads
        for arr, pay in ((self.k_blocks, pk), (self.v_blocks, pv)):
            for dst, src in zip(_leaves(arr), _leaves(pay)):
                src = _from_numpy(src)
                if hl != self.num_heads:
                    src = src[:, :, h0:h0 + hl]
                dst[:, b].copy_(src)

    def import_prefix(self, payload, owner=None):
        """Install an `export_prefix` payload (this port's or the
        reference's): allocate blocks, write the contents, and register
        the chain as `publish_prefix` would; the blocks park in
        retention until an attach claims them. A hash this pool already
        holds keeps its block and the import's block frees. Raises
        BlockPoolExhausted when the pool cannot cover the chain and
        ValueError on a layout mismatch. Returns the tokens
        published."""
        for field in ("block_size", "kv_dtype", "num_layers",
                      "num_heads", "head_dim"):
            if payload[field] != getattr(self, field):
                raise ValueError(
                    f"import_prefix layout mismatch on {field}: "
                    f"payload has {payload[field]!r}, pool has "
                    f"{getattr(self, field)!r}")
        ids = np.asarray(payload["tokens"], np.int64).reshape(-1)
        fills = [int(f) for f in payload["fills"]]
        if not fills or int(ids.size) != sum(fills):
            raise ValueError(
                f"import_prefix payload inconsistent: {ids.size} "
                f"tokens vs fills {fills}")
        new_blocks = self._take_blocks(len(fills),
                                       owner=owner)  # may raise
        for b, pk, pv in zip(new_blocks, payload["k"], payload["v"]):
            self.write_payload_block(b, pk, pv)
        if self.mirror is not None:
            self.mirror.import_blocks(new_blocks, payload["k"],
                                      payload["v"])
        h = ROOT_HASH
        pos = 0
        for b, f in zip(new_blocks, fills):
            hh = prefix_block_hash(h, ids[pos:pos + f])
            if hh not in self._index:
                self._register_entry(hh, b, f, h)
            self._release_block(b)     # indexed -> retention, else free
            pos += f
            if f < self.block_size:
                break                  # a partial tail ends the chain
            h = hh
        self.maybe_demote()
        return pos

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

    def headroom(self):
        """Capacity view for the pressure sampler: host-side counters
        only, no device read (safe at round rates)."""
        held = sum(self._lens.values())
        used = self._usable - len(self._free) - len(self._retained)
        return {
            "num_blocks": self._usable,
            "used_blocks": used,
            "free_blocks": len(self._free),
            "retained_blocks": len(self._retained),
            "available_blocks": len(self._free) + len(self._retained),
            "sequences": len(self._tables),
            "held_tokens": held,
            "utilization": held / (self.capacity_tokens or 1),
        }

    def block_fill(self):
        """Live tokens / allocated block capacity."""
        used = self._usable - len(self._free) - len(self._retained)
        return sum(self._lens.values()) / ((used * self.block_size) or 1)

    def stats(self):
        used = self._usable - len(self._free) - len(self._retained)
        held = sum(self._lens.values())
        return {
            "block_size": self.block_size,
            "num_blocks": self._usable,  # usable (trash excluded)
            "kv_dtype": self.stats_kv_dtype(),
            "pool_bytes_total": self.pool_bytes_total,
            "pool_bytes_per_token": self.bytes_per_token,
            # ranks the pool is split over, and one rank's real bytes
            "shards": self._shard_count,
            "pool_bytes_per_shard": self.pool_bytes_per_shard,
            "scale_bytes": self.scale_bytes,
            "used_blocks": used,
            "free_blocks": len(self._free),
            "retained_blocks": len(self._retained),
            "peak_retained_blocks": self._peak_retained,
            "peak_used_blocks": self._peak_blocks,
            "sequences": len(self._tables),
            "held_tokens": held,
            # shared blocks count once per referent: can exceed 1.0
            "utilization": held / (self.capacity_tokens or 1),
            "block_fill": held / ((used * self.block_size) or 1),
            "prefix_cache": {
                "index_entries": len(self._index),
                "lookups": self._prefix_lookups,
                "hits": self._prefix_hits,
                "hit_tokens": self._hit_tokens,
                "lookup_tokens": self._lookup_tokens,
                # the last token of every prompt is never matchable
                "hit_rate": self._hit_tokens / (self._lookup_tokens or 1),
                "evictions": self._evictions,
                "cow_copies": self._cow_copies,
            },
            "tier": self._tier_stats(),
        }

    def _tier_stats(self):
        if self._tier is None:
            return disabled_tier_stats()
        s = self._tier.stats()
        return {
            "enabled": True,
            "capacity_blocks": s["capacity_blocks"],
            "tiered_blocks": s["tiered_blocks"],
            "tiered_tokens": s["tiered_tokens"],
            "bytes_resident": s["bytes_resident"],
            "demotions": self._tier_demotions,
            "promotions": self._tier_promotions,
            "evictions": s["evictions"],
            "bytes_out": self._tier_bytes_out,
            "bytes_in": self._tier_bytes_in,
            "hit_tokens": self._tier_hit_tokens,
        }


__all__ = ["PagedKVCache", "BlockPoolExhausted", "blocks_for",
           "prefix_block_hash", "ROOT_HASH"]
