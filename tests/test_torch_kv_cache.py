"""The port's block pool (paddle_tpu_torch/inference/kv_cache.py) — twins
of the pool tests in tests/test_paged_kv.py: allocation and growth, the
trash block 0 never handed out, atomic ensure_many refusal leaving the
state byte-identical, free/truncate accounting, table_array padding, a
fixed-seed alloc/free fuzz asserting that free ∪ tables partitions the
pool, and the same op sequence giving the reference's block tables."""
import copy

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.kv_cache import (BlockPoolExhausted,
                                                 PagedKVCache, blocks_for)

torch.set_num_threads(1)


def _cache(num_blocks=8, block_size=4, kv_dtype=None):
    return PagedKVCache(2, 4, 8, block_size=block_size,
                        num_blocks=num_blocks, kv_dtype=kv_dtype,
                        device="cpu")


def _state(c):
    return (list(c._free), copy.deepcopy(c._tables), dict(c._lens),
            c._peak_blocks)


def check_partition(c):
    """free ∪ tables partition blocks 1..N-1; block 0 in neither; every
    table covers exactly blocks_for(len) blocks."""
    live = [b for tab in c._tables.values() for b in tab]
    both = sorted(c._free + live)
    assert both == list(range(1, c.num_blocks)), both
    assert 0 not in c._free and 0 not in live
    for s, tab in c._tables.items():
        assert len(tab) == blocks_for(c._lens[s], c.block_size)


def test_alloc_sizes_and_capacity():
    c = _cache()
    assert c.capacity_tokens == 7 * 4  # block 0 is reserved trash
    t = c.allocate("a", 9)             # 9 tokens -> 3 blocks of 4
    assert len(t) == blocks_for(9, 4) == 3
    assert 0 not in t
    assert c.free_block_count == 4


def test_append_crosses_block_boundary():
    c = _cache()
    c.allocate("a", 4)
    assert len(c.block_table("a")) == 1
    c.append("a")
    assert len(c.block_table("a")) == 2 and c.seq_len("a") == 5
    c.append("a", 3)
    assert len(c.block_table("a")) == 2


def test_free_returns_blocks_and_reuse():
    c = _cache()
    t_a = c.allocate("a", 12)
    c.allocate("b", 8)
    assert c.free_block_count == 2
    assert c.free("a") == 3
    assert c.free_block_count == 5
    t_c = c.allocate("c", 20)
    assert set(t_a) <= set(t_c)
    assert c.free_block_count == 0


def test_ensure_many_refusal_leaves_state_byte_identical():
    c = _cache()
    c.allocate("a", 16)                # 4 of 7 blocks
    before = _state(c)
    with pytest.raises(BlockPoolExhausted) as ei:
        c.ensure_many([("b", 12), ("a", 20)])  # 4 needed, 3 free
    assert ei.value.needed == 4 and ei.value.available == 3
    assert _state(c) == before
    assert not c.has_seq("b")
    c.ensure_many([("a", 6), ("b", 9)])  # shrink is a no-op; b takes 3
    assert c.seq_len("a") == 16 and c.seq_len("b") == 9
    assert c.free_block_count == 0


def test_double_alloc_and_unknown_seq_errors():
    c = _cache()
    c.allocate("a", 4)
    with pytest.raises(ValueError):
        c.allocate("a", 4)
    for fn in (c.free, c.seq_len, c.block_table,
               lambda s: c.ensure(s, 8), lambda s: c.append(s)):
        with pytest.raises(KeyError, match="unknown sequence 'ghost'"):
            fn("ghost")
    assert c.has_seq("a") and c.free_block_count == 6


def test_truncate_accounting():
    c = _cache()
    c.allocate("a", 14)                # 4 blocks
    assert c.truncate_seq("a", 9) == 1  # 9 tokens keep 3 blocks
    assert c.seq_len("a") == 9 and len(c.block_table("a")) == 3
    assert c.truncate_seq("a", 9) == 0
    with pytest.raises(ValueError, match="only rolls back"):
        c.truncate_seq("a", 10)
    assert c.truncate_seq("a", 0) == 3
    assert c.free_block_count == 7
    check_partition(c)


def test_stats_and_table_array_padding():
    c = _cache()
    c.allocate("a", 6)
    st = c.stats()
    assert st["used_blocks"] == 2 and st["held_tokens"] == 6
    assert st["block_fill"] == c.block_fill() == 6 / 8
    tab = c.table_array(["a", None], width=4)
    assert tab.dtype == np.int32 and tab.shape == (2, 4)
    assert (tab[1] == 0).all()         # idle row -> all trash
    assert tab[0, 2:].tolist() == [0, 0]
    with pytest.raises(ValueError, match="exceeds width"):
        c.table_array(["a"], width=1)
    c.free("a")
    assert c.stats()["used_blocks"] == 0
    assert c.stats()["peak_used_blocks"] == 2


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pool_tensors_and_bytes(kv_dtype):
    c = _cache(kv_dtype=kv_dtype)
    if kv_dtype is None:
        assert c.k_blocks.shape == (2, 8, 4, 4, 8)
        assert c.pool_bytes_total == 2 * 2 * 8 * 4 * 4 * 8 * 4
    else:
        assert c.k_blocks.codes.dtype == torch.int8
        assert c.k_blocks.scales.shape == (2, 8, 4, 4)
        assert c.pool_bytes_total == 2 * (2 * 8 * 4 * 4 * 8
                                          + 2 * 8 * 4 * 4 * 4)
    assert c.k_blocks is not c.v_blocks


@pytest.mark.parametrize("seed", [11, 12])
def test_fixed_seed_fuzz_partitions_pool(seed):
    rs = np.random.RandomState(seed)
    c = _cache(num_blocks=14)
    live = set()
    nxt = 0
    for _ in range(300):
        op = rs.randint(5)
        if op == 0 or not live:
            try:
                c.allocate(nxt, int(rs.randint(1, 20)))
                live.add(nxt)
            except BlockPoolExhausted:
                assert not c.has_seq(nxt)
            nxt += 1
        elif op == 1:
            s = sorted(live)[rs.randint(len(live))]
            before = _state(c)
            try:
                c.append(s, int(rs.randint(1, 6)))
            except BlockPoolExhausted:
                assert _state(c) == before
        elif op == 2:
            picks = {sorted(live)[rs.randint(len(live))] for _ in range(3)}
            before = _state(c)
            try:
                c.ensure_many([(s, c.seq_len(s) + int(rs.randint(0, 6)))
                               for s in picks])
            except BlockPoolExhausted:
                assert _state(c) == before
        elif op == 3:
            s = sorted(live)[rs.randint(len(live))]
            c.truncate_seq(s, int(rs.randint(0, c.seq_len(s) + 1)))
        else:
            s = sorted(live)[rs.randint(len(live))]
            c.free(s)
            live.discard(s)
        check_partition(c)
    for s in list(live):
        c.free(s)
    check_partition(c)
    assert c.free_block_count == c.num_blocks - 1


def test_block_tables_match_reference_pool():
    """The same alloc/grow/free/truncate sequence hands out the same
    block ids as the reference pool (so the decoder twins compare pools
    block for block)."""
    from paddle_tpu.inference.kv_cache import PagedKVCache as JCache

    jc = JCache(2, 4, 8, block_size=4, num_blocks=14)
    tc = _cache(num_blocks=14)
    ops = [("ensure_many", [("a", 9), ("b", 3)]), ("allocate", "c", 5),
           ("free", "a"), ("ensure_many", [("b", 13), ("d", 7)]),
           ("truncate_seq", "b", 5), ("allocate", "e", 10)]
    for op, *args in ops:
        getattr(jc, op)(*args)
        getattr(tc, op)(*args)
        seqs = sorted(tc._tables)
        np.testing.assert_array_equal(tc.table_array(seqs, 4),
                                      jc.table_array(seqs, 4))
        assert tc.free_block_count == jc.free_block_count
