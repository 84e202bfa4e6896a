"""The port's prefix cache (paddle_tpu_torch/inference/kv_cache.py and the
server's `enable_prefix_cache`) on the CPU — twins of
tests/test_prefix_cache.py, the prefix-cache cases of
tests/test_sampling.py and tests/test_quantized_serving.py:

  * `prefix_block_hash` gives the reference's integers over random chains;
  * a fixed-seed fuzz runs one op sequence (allocate, ensure, ensure_many,
    append, free, truncate, attach, publish, prepare_write, K/V writes,
    swap_out, export/import) through the reference pool (JAX) and the
    port's, dense and int8, comparing them after every op
    (`torch_twin_util.PoolMirror`: tables, free list, retention order,
    refcounts, index, stats and every pool element bit for bit);
  * the reference's pool tests (`TestPrefixPoolUnit`, the invariant and
    recovery fuzzes, over seeds, through the same mirror);
  * logits of a cached resume, mid-block copy-on-write included, against
    the reference decoder's at `LOGIT_ATOL` (tests/test_torch_decoder.py);
  * the server: cache on == off == the reference server's tokens,
    greedy and at a fixed seed, dense and int8 pools, under eviction
    pressure.

Where the reference's own test fails on its pinned workload
(`TestServedParity`'s prefix-cache and kv8_only cases: quantization
flips a greedy token there), the twin holds the port to what the test
specifies: int8 on == off == warm exactly, and int8 against dense
identical but where the dense logits' top two lie within the documented
int8 tolerance (LOGIT_TOL, 5% of the logit scale,
tests/test_quantized_serving.py) of each other."""
import numpy as np
import pytest
import torch

from torch_twin_util import (PoolMirror, check_pool_invariants, dense_logits,
                             pool_step_fuzz, reference_tiny_model)

from paddle_tpu_torch.inference.kv_cache import (BlockPoolExhausted,
                                                 PagedKVCache, blocks_for,
                                                 prefix_block_hash)

torch.set_num_threads(1)

LOGIT_ATOL = 1e-4   # tests/test_torch_decoder.py
LOGIT_TOL = 0.05    # tests/test_quantized_serving.py (int8 KV)


def _cache(num_blocks=16, block_size=4, **kw):
    return PagedKVCache(1, 1, 2, block_size=block_size,
                        num_blocks=num_blocks, device="cpu", **kw)


def _mirror(num_blocks=16, block_size=4, **kw):
    return PoolMirror(num_blocks=num_blocks, block_size=block_size, **kw)


# ---- hashes -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_block_hash_matches_reference(seed):
    from paddle_tpu.inference.kv_cache import ROOT_HASH
    from paddle_tpu.inference.kv_cache import prefix_block_hash as jhash

    rs = np.random.RandomState(seed)
    h = hj = ROOT_HASH
    for _ in range(32):
        n = int(rs.randint(1, 17))
        toks = rs.randint(0, 2 ** 31 - 1, n).astype(
            [np.int32, np.int64][int(rs.randint(2))])
        h, hj = prefix_block_hash(h, toks), jhash(hj, toks)
        assert h == hj
        assert prefix_block_hash(h, list(toks)) == jhash(hj, toks)


# ---- the pool, step against the reference -----------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
@pytest.mark.parametrize("seed", [31, 32])
def test_pool_step_against_reference(kv_dtype, seed):
    """Every op of a fixed-seed sequence gives the reference pool's
    result and state, including every pool element bit for bit."""
    c = _mirror(num_blocks=14, kv_dtype=kv_dtype, seed=seed)
    st = pool_step_fuzz(c, np.random.RandomState(seed), 250, tier=False)
    pc = st["prefix_cache"]
    assert pc["hits"] > 10 and pc["cow_copies"] > 0 and pc["evictions"] > 0


# ---- the reference's pool tests, as twins -----------------------------------

class TestPrefixPoolUnit:
    def test_publish_attach_full_chain(self):
        c = _mirror()
        toks = np.arange(100, 112, dtype=np.int32)
        c.allocate("a", 12)
        c.publish_prefix("a", toks)
        ta = c.block_table("a")
        c.free("a")
        assert c.retained_block_count == 3
        assert c.attach_prefix("b", toks) == 11
        assert c.block_table("b") == ta
        assert c.seq_len("b") == 11
        assert c.retained_block_count == 0
        st = c.stats()["prefix_cache"]
        assert st["hits"] == 1 and st["hit_tokens"] == 11
        assert st["lookups"] == 1 and st["lookup_tokens"] == 11
        check_pool_invariants(c.port)

    def test_attach_extension_prompt_hits_full_blocks(self):
        c = _mirror()
        toks = np.arange(50, 58, dtype=np.int32)
        c.allocate("a", 8)
        c.publish_prefix("a", toks)
        longer = np.concatenate([toks, np.arange(9, dtype=np.int32)])
        assert c.attach_prefix("b", longer) == 8
        assert c.block_table("b") == c.block_table("a")
        c.ensure("b", longer.size)
        assert c._ref[c.block_table("a")[0]] == 2
        check_pool_invariants(c.port)

    def test_no_match_returns_zero_without_creating_seq(self):
        c = _mirror()
        c.allocate("a", 8)
        c.publish_prefix("a", np.arange(8, dtype=np.int32))
        assert c.attach_prefix("b", np.arange(900, 912,
                                              dtype=np.int32)) == 0
        assert not c.has_seq("b")
        st = c.stats()["prefix_cache"]
        assert st["lookups"] == 1 and st["hits"] == 0
        check_pool_invariants(c.port)

    def test_partial_tail_attach_and_inplace_when_sole(self):
        c = _mirror()
        toks = np.arange(10, dtype=np.int32)
        c.allocate("a", 10)
        c.publish_prefix("a", toks)
        tail_block = c.block_table("a")[2]
        c.free("a")
        longer = np.concatenate([toks, np.arange(70, 75, dtype=np.int32)])
        assert c.attach_prefix("b", longer) == 10
        assert c.block_table("b")[2] == tail_block
        assert not c.prepare_write("b", 10)
        assert c.block_table("b")[2] == tail_block
        assert c.stats()["prefix_cache"]["cow_copies"] == 0
        check_pool_invariants(c.port)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["f32", "bf16"])
    def test_cow_when_shared_live(self, dtype):
        """The copy lands on a new block bit for bit (float32 against the
        reference pool; bf16 on the port's pool alone)."""
        toks = np.arange(10, dtype=np.int32)
        longer = np.concatenate([toks, np.arange(70, 76, dtype=np.int32)])
        mirror = dtype == torch.float32
        c = _mirror() if mirror else _cache(dtype=dtype)
        c.allocate("a", 10)
        c.publish_prefix("a", toks)
        tail = c.block_table("a")[2]
        if mirror:
            c.write("a", 8)          # the tail block's rows, both pools
        else:
            c.k_blocks[:, tail] = 7.5
            c.v_blocks[:, tail] = -2.5
        assert c.attach_prefix("b", longer) == 10
        assert c._ref[tail] == 2
        assert c.prepare_write("b", 10) is True
        new = c.block_table("b")[2]
        assert new != tail
        assert c.block_table("a")[2] == tail
        assert c._ref[tail] == 1 and c._ref[new] == 1
        for kv in (c.k_blocks, c.v_blocks):
            assert torch.equal(kv[:, new], kv[:, tail])
        assert c.stats()["prefix_cache"]["cow_copies"] == 1
        check_pool_invariants(c if not mirror else c.port)

    def test_cow_when_claiming_below_entry_fill(self):
        c = _mirror()
        toks = np.arange(300, 314, dtype=np.int32)
        c.allocate("a", 14)
        c.publish_prefix("a", toks)
        tail = c.block_table("a")[3]
        c.free("a")
        assert c.attach_prefix("b", toks) == 13
        assert c.block_table("b")[3] == tail
        assert c.prepare_write("b", 13) is True
        assert c.block_table("b")[3] != tail
        assert len(c._block_entries[tail]) == 1
        assert tail in c._retained
        check_pool_invariants(c.port)

    def test_retention_lru_order_and_eviction(self):
        c = _mirror(num_blocks=8)
        a = np.arange(0, 8, dtype=np.int32)
        b = np.arange(50, 58, dtype=np.int32)
        c.allocate("a", 8)
        c.publish_prefix("a", a)
        c.allocate("b", 8)
        c.publish_prefix("b", b)
        a_blocks = c.block_table("a")
        c.free("a")
        c.free("b")
        assert c.retained_block_count == 4
        assert c.free_block_count == 3
        c.allocate("c", 20)
        assert c.stats()["prefix_cache"]["evictions"] == 2
        assert set(a_blocks) <= set(c.block_table("c"))
        assert c.attach_prefix("x", a) == 0
        assert c.attach_prefix("y", b) == 7
        check_pool_invariants(c.port)

    def test_ensure_many_reclaims_before_raising(self):
        c = _mirror(num_blocks=8)
        c.allocate("a", 8)
        c.publish_prefix("a", np.arange(8, dtype=np.int32))
        c.free("a")
        c.ensure_many([("b", 24), ("c", 4)])
        assert c.stats()["prefix_cache"]["evictions"] == 2
        with pytest.raises(BlockPoolExhausted, match="reclaimable"):
            c.ensure_many([("d", 8)])
        assert not c.has_seq("d")
        check_pool_invariants(c.port)

    def test_publish_requires_live_tokens_and_known_seq(self):
        c = _mirror()
        c.allocate("a", 4)
        with pytest.raises(ValueError, match="only 4 are live"):
            c.publish_prefix("a", np.arange(8, dtype=np.int32))
        with pytest.raises(KeyError, match="unknown sequence"):
            c.publish_prefix("zzz", np.arange(4, dtype=np.int32))
        with pytest.raises(KeyError, match="unknown sequence"):
            c.prepare_write("zzz", 0)


def _invariants_fuzz(c, rs, n_ops):
    """The op mix of TestPoolInvariantsFuzz (tests/test_prefix_cache.py)."""
    master = rs.randint(1, 50, size=48).astype(np.int32)
    live = {}
    next_seq = [0]

    def new_tokens():
        n = int(rs.randint(1, 30))
        t = master[:n].copy()
        if rs.rand() < 0.4:
            t = np.concatenate([t, rs.randint(
                1, 50, size=int(rs.randint(1, 7))).astype(np.int32)])
        return t

    def op_admit():
        seq = next_seq[0]
        next_seq[0] += 1
        toks = new_tokens()
        try:
            cached = c.attach_prefix(seq, toks)
            if cached == 0:
                c.allocate(seq, toks.size)
            else:
                c.prepare_write(seq, cached)
                c.ensure(seq, toks.size)
        except BlockPoolExhausted:
            if c.has_seq(seq):
                c.free(seq)
            return
        live[seq] = toks

    def op_grow():
        if not live:
            return
        seq = list(live)[int(rs.randint(len(live)))]
        try:
            if rs.rand() < 0.5:
                c.append(seq, int(rs.randint(1, 6)))
            else:
                c.ensure(seq, c.seq_len(seq) + int(rs.randint(0, 6)))
        except BlockPoolExhausted:
            pass

    def op_bulk():
        if not live:
            return
        seqs = list(live)
        picks = [seqs[int(rs.randint(len(seqs)))]
                 for _ in range(min(3, len(seqs)))]
        try:
            c.ensure_many([(s, c.seq_len(s) + int(rs.randint(0, 5)))
                           for s in sorted(set(picks))])
        except BlockPoolExhausted:
            pass

    def op_publish():
        if live:
            seq = list(live)[int(rs.randint(len(live)))]
            c.publish_prefix(seq, live[seq])

    def op_write():
        if not live:
            return
        seq = list(live)[int(rs.randint(len(live)))]
        try:
            c.prepare_write(seq, int(rs.randint(0, c.seq_len(seq) + 1)))
        except BlockPoolExhausted:
            pass

    def op_free():
        if not live:
            return
        seq = list(live)[int(rs.randint(len(live)))]
        if rs.rand() < 0.5:
            c.publish_prefix(seq, live[seq])
        c.free(seq)
        del live[seq]

    ops = [op_admit, op_admit, op_grow, op_bulk, op_publish, op_write,
           op_free, op_free]
    for _ in range(n_ops):
        ops[int(rs.randint(len(ops)))]()
        check_pool_invariants(c.port)
    for seq in list(live):
        c.free(seq)
        check_pool_invariants(c.port)
    assert c._ref == {}
    assert c.free_block_count + c.retained_block_count == c.num_blocks - 1
    return c.stats()["prefix_cache"]


@pytest.mark.parametrize("seed", [1234, 1235])
def test_randomized_op_sequence_keeps_invariants(seed):
    """TestPoolInvariantsFuzz's twin, step for step against the
    reference pool."""
    st = _invariants_fuzz(_mirror(num_blocks=14),
                          np.random.RandomState(seed), 400)
    assert st["hits"] > 20
    assert st["cow_copies"] > 0
    assert st["evictions"] > 0


def _recovery_fuzz(c, rs, n_ops):
    """The op mix of TestRecoveryInterleavingFuzz: truncate-to-durable,
    swap-out, re-attach resume and refused (atomic) ensure_many."""
    master = rs.randint(1, 50, size=64).astype(np.int32)
    live = {}
    next_seq = [0]
    counters = {"swap_cycles": 0, "refused": 0, "truncates": 0}

    def stream_for(seq):
        n = c.seq_len(seq)
        t = live[seq]
        if t.size < n:
            t = np.concatenate([t, rs.randint(
                1, 50, size=n - t.size).astype(np.int32)])
            live[seq] = t
        return t[:n]

    def op_admit():
        seq = next_seq[0]
        next_seq[0] += 1
        n = int(rs.randint(1, 30))
        toks = master[:n].copy()
        if rs.rand() < 0.4:
            toks = np.concatenate([toks, rs.randint(
                1, 50, size=int(rs.randint(1, 7))).astype(np.int32)])
        try:
            cached = c.attach_prefix(seq, toks)
            if cached == 0:
                c.allocate(seq, toks.size)
            else:
                c.prepare_write(seq, cached)
                c.ensure(seq, toks.size)
        except BlockPoolExhausted:
            if c.has_seq(seq):
                c.free(seq)
            return
        live[seq] = toks

    def op_grow():
        if not live:
            return
        seq = list(live)[int(rs.randint(len(live)))]
        try:
            c.append(seq, int(rs.randint(1, 6)))
        except BlockPoolExhausted:
            pass

    def op_recover_cycle():
        if not live:
            return
        seq = list(live)[int(rs.randint(len(live)))]
        ids = stream_for(seq)
        durable = int(rs.randint(0, c.seq_len(seq) + 1))
        if durable < c.seq_len(seq):
            c.truncate_seq(seq, durable)
            counters["truncates"] += 1
        check_pool_invariants(c.port)
        c.swap_out_seq(seq, ids[:durable])
        check_pool_invariants(c.port)
        del live[seq]
        counters["swap_cycles"] += 1
        if durable < 2 or rs.rand() < 0.3:
            return
        rseq = next_seq[0]
        next_seq[0] += 1
        try:
            cached = c.attach_prefix(rseq, ids[:durable])
            if cached == 0:
                c.allocate(rseq, durable)
            else:
                c.prepare_write(rseq, cached)
                c.ensure(rseq, durable)
        except BlockPoolExhausted:
            if c.has_seq(rseq):
                c.free(rseq)
            return
        live[rseq] = ids[:durable].copy()

    def op_injected_exhaustion():
        if not live:
            return
        seqs = list(live)[:3]
        before = (list(c._free), list(c._retained),
                  {s: list(t) for s, t in c._tables.items()},
                  dict(c._lens))
        demand = [(s, c.seq_len(s) + c.num_blocks * c.block_size)
                  for s in seqs]
        with pytest.raises(BlockPoolExhausted):
            c.ensure_many(demand)
        counters["refused"] += 1
        assert before == (list(c._free), list(c._retained),
                          {s: list(t) for s, t in c._tables.items()},
                          dict(c._lens))

    def op_publish():
        if live:
            seq = list(live)[int(rs.randint(len(live)))]
            c.publish_prefix(seq, stream_for(seq))

    def op_free():
        if live:
            seq = list(live)[int(rs.randint(len(live)))]
            c.free(seq)
            del live[seq]

    ops = [op_admit, op_admit, op_grow, op_recover_cycle, op_recover_cycle,
           op_injected_exhaustion, op_publish, op_free]
    for _ in range(n_ops):
        ops[int(rs.randint(len(ops)))]()
        check_pool_invariants(c.port)
    for seq in list(live):
        c.free(seq)
        check_pool_invariants(c.port)
    assert c._ref == {}
    assert c.free_block_count + c.retained_block_count == c.num_blocks - 1
    return counters, c.stats()["prefix_cache"]


@pytest.mark.parametrize("seed", [4321, 9876])
def test_recovery_interleaving_keeps_invariants(seed):
    """TestRecoveryInterleavingFuzz's twin (its short and long seeds),
    step for step against the reference pool."""
    counters, st = _recovery_fuzz(_mirror(num_blocks=14),
                                  np.random.RandomState(seed), 400)
    assert counters["swap_cycles"] > 10
    assert counters["truncates"] > 5
    assert counters["refused"] > 5
    assert st["hits"] > 5


class TestQuantizedPool:
    """Twins of TestQuantizedPoolUnit's copy-on-write and bookkeeping
    cases (tests/test_quantized_serving.py)."""

    def test_cow_copies_scales_with_codes(self):
        c = PoolMirror(num_blocks=6, block_size=4, kv_dtype="int8",
                       shape=(1, 1, 4))
        toks = np.arange(1, 9, dtype=np.int32)
        c.allocate("pub", 8)
        b0 = c.block_table("pub")[0]
        c.write("pub", 0)          # recognisable codes + scales
        c.publish_prefix("pub", toks)
        assert c.attach_prefix("att", toks) > 0
        assert c.block_table("att")[0] == b0
        assert c.prepare_write("att", 0) is True
        new = c.block_table("att")[0]
        assert new != b0
        for kv in (c.k_blocks, c.v_blocks):
            assert torch.equal(kv.codes[:, new], kv.codes[:, b0])
            assert torch.equal(kv.scales[:, new], kv.scales[:, b0])
        for s in ("pub", "att"):
            c.free(s)

    def test_quantized_attach_truncate_swap_keep_scales_indexed(self):
        c = PoolMirror(num_blocks=8, block_size=4, kv_dtype="int8")
        toks = np.arange(1, 11, dtype=np.int32)
        c.allocate("a", 10)
        c.write("a", 0)
        assert c.swap_out_seq("a", toks) == 10
        assert not c.has_seq("a")
        assert c.retained_block_count > 0
        assert c.attach_prefix("b", toks) == 9
        c.ensure("b", 10)
        c.truncate_seq("b", 3)
        assert c.seq_len("b") == 3
        c.free("b")


def _as_reference_payload(pay):
    """The port's payload with its int8 pairs as the reference's
    `QuantizedKV` (the reference pool maps payloads as JAX pytrees, whose
    structure names the class; its wire decoder builds that class)."""
    from paddle_tpu.inference.kv_quant import QuantizedKV as JQ

    def conv(p):
        return JQ(p.codes, p.scales) if hasattr(p, "codes") else p

    return {**pay, "k": [conv(p) for p in pay["k"]],
            "v": [conv(p) for p in pay["v"]]}


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
def test_export_import_wire_format_crosses_pools(kv_dtype):
    """A chain exported by the port imports into the reference pool and
    the reference's into the port's: the same chain, tokens and
    contents either way (the migration wire format is the reference's)."""
    from paddle_tpu.inference.kv_cache import PagedKVCache as JCache

    src = PoolMirror(num_blocks=10, block_size=4, kv_dtype=kv_dtype,
                     shape=(2, 2, 4), seed=3)
    toks = np.arange(40, 51, dtype=np.int32)
    src.allocate("a", 11)
    src.write("a", 0)
    src.publish_prefix("a", toks)
    pay = src.export_prefix(toks)        # == the reference's payload
    pay_ref = src.ref.export_prefix(toks)
    assert pay["fills"] == [4, 4, 3]
    for payload, make in ((_as_reference_payload(pay), "ref"),
                          (pay_ref, "port")):
        if make == "ref":
            dst = JCache(2, 2, 4, block_size=4, num_blocks=10,
                         kv_dtype=kv_dtype)
        else:
            dst = PagedKVCache(2, 2, 4, block_size=4, num_blocks=10,
                               kv_dtype=kv_dtype, device="cpu")
        assert dst.import_prefix(payload) == 11
        assert dst.attach_prefix("b", toks) == 10
        for b_src, b_dst in zip(src.block_table("a"), dst.block_table("b")):
            for a_src, a_dst in ((src.k_blocks, dst.k_blocks),
                                 (src.v_blocks, dst.v_blocks)):
                leaves = ((a_src.codes, a_dst.codes), (a_src.scales,
                                                       a_dst.scales)) \
                    if kv_dtype else ((a_src, a_dst),)
                for x, y in leaves:
                    np.testing.assert_array_equal(
                        x[:, b_src].numpy(), np.asarray(y[:, b_dst]))


# ---- logits of a cached resume ----------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    model, cfg, port, tcfg = reference_tiny_model(13)
    return model, cfg, port, tcfg, port.flat_params()


class _Sides:
    """The reference decoder + pool and the port's, fed the same chunks
    (ensure -> prepare_write -> packed prefill, as the servers do)."""

    def __init__(self, tiny, bs=4):
        from paddle_tpu.inference.kv_cache import PagedKVCache as JCache
        from paddle_tpu.nn.decode import PagedDecoder as JDecoder

        from paddle_tpu_torch.nn.decode import PagedDecoder

        model, cfg, port, tcfg, params = tiny
        H, Dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        self.jparams = model.functional_state()[0]
        self.params = params
        self.jdec = JDecoder.for_config(cfg, bs, return_logits=True)
        self.dec = PagedDecoder.for_config(tcfg, bs, return_logits=True)
        self.jcache = JCache(cfg.num_layers, H, Dh, block_size=bs,
                             num_blocks=32)
        self.cache = PagedKVCache(tcfg.num_layers, H, Dh, block_size=bs,
                                  num_blocks=32, device="cpu")

    def packed(self, seq, toks, start):
        """One packed-prefill chunk feeding toks[start:] of `seq` on
        both sides: (reference token, logits), (port token, logits)."""
        import jax.numpy as jnp

        from paddle_tpu.sampling import greedy_args as jgreedy

        from paddle_tpu_torch.sampling import greedy_args

        n = toks.size - start
        T = 8
        while T < n:
            T *= 2
        stream = np.zeros((T,), np.int32)
        seg = np.zeros((T,), np.int32)
        pos = np.full((T,), -1, np.int32)
        stream[:n] = toks[start:]
        pos[:n] = np.arange(start, toks.size, dtype=np.int32)
        out = []
        for c in (self.jcache, self.cache):
            c.ensure(seq, toks.size)
            c.prepare_write(seq, start)
        assert self.cache.block_table(seq) == self.jcache.block_table(seq)
        width = blocks_for(toks.size, self.cache.block_size)
        tab = self.jcache.table_array([seq], width)
        tok, _s, kc, vc, _c, lg = self.jdec.packed_prefill(
            self.jparams, jnp.asarray(stream), jnp.asarray(seg),
            jnp.asarray(pos), jnp.asarray(tab), jnp.asarray([n - 1]),
            self.jcache.k_blocks, self.jcache.v_blocks, jgreedy(1))
        self.jcache.swap_arrays(kc, vc)
        out.append((int(np.asarray(tok)[0]), np.asarray(lg)[0]))
        tok, _s, _k, _v, _c, lg = self.dec.packed_prefill(
            self.params, torch.from_numpy(stream), torch.from_numpy(seg),
            torch.from_numpy(pos), torch.from_numpy(tab),
            torch.tensor([n - 1], dtype=torch.int32), self.cache.k_blocks,
            self.cache.v_blocks, greedy_args(1, "cpu"))
        out.append((int(tok[0]), lg[0].numpy()))
        np.testing.assert_allclose(out[1][1], out[0][1], atol=LOGIT_ATOL,
                                   rtol=0)
        assert out[0][0] == out[1][0]
        return out[1]

    def both(self, op, *args):
        r = getattr(self.jcache, op)(*args)
        assert getattr(self.cache, op)(*args) == r
        return r


class TestCachedPrefillLogitParity:
    def test_cached_resume_logits_match_full_prefill(self, tiny):
        cfg = tiny[1]
        s = _Sides(tiny)
        rs = np.random.RandomState(5)
        prompt = rs.randint(1, cfg.vocab_size, (13,)).astype(np.int32)
        s.both("allocate", 0, 0)
        tok0, logits0 = s.packed(0, prompt, 0)
        s.both("publish_prefix", 0, prompt)
        s.both("free", 0)
        cached = s.both("attach_prefix", 1, prompt)
        assert cached == 12
        tok1, logits1 = s.packed(1, prompt, cached)
        assert tok1 == tok0
        np.testing.assert_allclose(logits1, logits0, atol=LOGIT_ATOL,
                                   rtol=0)

    def test_midblock_cow_resume_logits_match(self, tiny):
        cfg = tiny[1]
        s = _Sides(tiny)
        rs = np.random.RandomState(6)
        a = rs.randint(1, cfg.vocab_size, (10,)).astype(np.int32)
        b = np.concatenate([a, rs.randint(
            1, cfg.vocab_size, (5,)).astype(np.int32)])
        s.both("allocate", 0, 0)
        s.packed(0, a, 0)
        s.both("publish_prefix", 0, a)            # stays live: sharing
        cached = s.both("attach_prefix", 1, b)
        assert cached == 10 and cached % 4 != 0
        assert s.cache._ref[s.cache.block_table(0)[2]] == 2
        tok_b, logits_b = s.packed(1, b, cached)
        assert s.cache.stats()["prefix_cache"]["cow_copies"] >= 1
        fresh = _Sides(tiny)
        fresh.both("allocate", 0, 0)
        tok_ref, logits_ref = fresh.packed(0, b, 0)
        assert tok_b == tok_ref
        np.testing.assert_allclose(logits_b, logits_ref, atol=LOGIT_ATOL,
                                   rtol=0)
        # the publisher's tail block survived the copy
        a_ext = np.concatenate([a, rs.randint(
            1, cfg.vocab_size, (1,)).astype(np.int32)])
        assert s.both("attach_prefix", 2, a_ext) == 10
        tok_a, logits_a = s.packed(2, a_ext, 10)
        fresh2 = _Sides(tiny)
        fresh2.both("allocate", 0, 0)
        tok_aref, logits_aref = fresh2.packed(0, a_ext, 0)
        assert tok_a == tok_aref
        np.testing.assert_allclose(logits_a, logits_aref, atol=LOGIT_ATOL,
                                   rtol=0)


# ---- the server -------------------------------------------------------------

def _port_server(port, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    kw.setdefault("device", "cpu")
    return PagedGenerationServer(port, **kw)


def _ref_server(model, **kw):
    from paddle_tpu.inference import PagedGenerationServer

    return PagedGenerationServer(model, **kw)


def _run(srv, prompts, sampling=None, burst=False, seed_first=False):
    """Outputs of `prompts` (sequentially, or all queued before the loop
    starts when `burst`) and the server's stats; stops the server."""
    sampling = sampling or [None] * len(prompts)
    try:
        if burst:
            if seed_first:
                srv.start()
                outs = [srv.submit(prompts[0], sampling=sampling[0])
                        .result(timeout=300)]
                futs = [srv.submit(p, sampling=s)
                        for p, s in zip(prompts[1:], sampling[1:])]
            else:
                outs = []
                futs = [srv.submit(p, sampling=s)
                        for p, s in zip(prompts, sampling)]
                srv.start()
            outs += [f.result(timeout=300) for f in futs]
        else:
            srv.start()
            outs = [srv.submit(p, sampling=s).result(timeout=300)
                    for p, s in zip(prompts, sampling)]
        st = srv.stats()
    finally:
        srv.stop()
    return [np.asarray(o) for o in outs], st


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _three_ways(tiny, prompts, sampling=None, burst=False, seed_first=False,
                **kw):
    """The reference server with caching on, and the port's with caching
    on and off: all three give the same tokens. Returns the port's
    cache-on stats."""
    model, _cfg, port, _tcfg, _p = tiny
    ref, _ = _run(_ref_server(model, enable_prefix_cache=True, **kw),
                  prompts, sampling, burst, seed_first)
    on, st = _run(_port_server(port, enable_prefix_cache=True, **kw),
                  prompts, sampling, burst, seed_first)
    off, st_off = _run(_port_server(port, **kw), prompts, sampling, burst,
                       seed_first)
    _assert_same(on, ref)
    _assert_same(off, on)
    assert st_off["kv_cache"]["prefix_cache"]["lookups"] == 0
    return st


def _with_prefix(rs, vocab, n_sys, tails):
    sys_p = rs.randint(1, vocab, (n_sys,)).astype(np.int32)
    return sys_p, [np.concatenate([sys_p, rs.randint(
        1, vocab, (n,)).astype(np.int32)]) for n in tails]


class TestServerPrefixParity:
    def test_sequential_shared_prefix_matches_solo(self, tiny):
        rs = np.random.RandomState(20)
        _s, prompts = _with_prefix(rs, tiny[3].vocab_size, 11, (3, 5, 2, 4))
        prompts.append(prompts[0].copy())      # exact resubmission: CoW
        st = _three_ways(tiny, prompts, max_slots=2, block_size=4,
                         max_prompt_len=20, max_new_tokens=4)
        kv = st["kv_cache"]
        assert kv["prefix_cache"]["hit_tokens"] > 0
        assert kv["prefix_cache"]["cow_copies"] >= 1
        assert kv["used_blocks"] == 0
        assert kv["retained_blocks"] > 0

    def test_burst_shared_prefix_matches_solo(self, tiny):
        rs = np.random.RandomState(21)
        _s, prompts = _with_prefix(rs, tiny[3].vocab_size, 9,
                                   (2, 3, 4, 5, 2, 3))
        st = _three_ways(tiny, prompts, burst=True, seed_first=True,
                         max_slots=3, block_size=4, max_prompt_len=16,
                         max_new_tokens=3)
        assert st["kv_cache"]["prefix_cache"]["hit_tokens"] > 0

    def test_parity_under_forced_eviction_pressure(self, tiny):
        rs = np.random.RandomState(22)
        vocab = tiny[3].vocab_size
        pa = rs.randint(1, vocab, (10,)).astype(np.int32)
        pb = rs.randint(1, vocab, (10,)).astype(np.int32)
        prompts = []
        for _ in range(2):
            for base in (pa, pb):
                prompts.append(np.concatenate([base, rs.randint(
                    1, vocab, (2,)).astype(np.int32)]))
        # worst = ceil((12 + 3) / 4) + 1 spare = 5; 6 usable blocks
        st = _three_ways(tiny, prompts, max_slots=2, block_size=4,
                         max_prompt_len=12, max_new_tokens=3, num_blocks=7)
        assert st["kv_cache"]["prefix_cache"]["evictions"] > 0

    def test_zero_hit_workload_and_disabled_fast_path(self, tiny):
        model, _cfg, port, tcfg, _p = tiny
        rs = np.random.RandomState(23)
        prompts = [rs.randint(1, tcfg.vocab_size, (n,)).astype(np.int32)
                   for n in (5, 9, 7)]
        kw = dict(max_slots=2, block_size=4, max_prompt_len=12,
                  max_new_tokens=3)
        ref, _ = _run(_ref_server(model, **kw), prompts)
        on, st = _run(_port_server(port, enable_prefix_cache=True, **kw),
                      prompts)
        _assert_same(on, ref)
        pc = st["kv_cache"]["prefix_cache"]
        assert pc["hit_tokens"] == 0
        assert pc["lookups"] == len(prompts)
        assert pc["cow_copies"] == 0
        # caching off (the default): no lookups, no index, no retention,
        # no spare block in the pool or the reservation
        srv = _port_server(port, **kw)
        assert srv.cache.num_blocks == 2 * blocks_for(12 + 3, 4) + 1
        off, st = _run(srv, prompts)
        _assert_same(off, ref)
        kv = st["kv_cache"]
        assert kv["prefix_cache"]["lookups"] == 0
        assert kv["prefix_cache"]["index_entries"] == 0
        assert kv["retained_blocks"] == 0
        on_srv = _port_server(port, enable_prefix_cache=True, **kw)
        assert on_srv.cache.num_blocks == 2 * (blocks_for(12 + 3, 4) + 1) + 1

    def test_on_off_servers_agree_token_for_token(self, tiny):
        rs = np.random.RandomState(24)
        sys_p, prompts = _with_prefix(rs, tiny[3].vocab_size, 10, (1, 4, 2))
        prompts.append(sys_p.copy())
        _three_ways(tiny, prompts, max_slots=2, block_size=4,
                    max_prompt_len=16, max_new_tokens=4)


def test_prefix_cache_sampling_parity_fixed_seed(tiny):
    """TestPrefixCacheSamplingParity's twin (tests/test_sampling.py): a
    fixed seed gives the same sampled tokens with caching on and off,
    and the reference server's."""
    from paddle_tpu.sampling import SamplingParams as JParams

    from paddle_tpu_torch.sampling import SamplingParams

    model, _cfg, port, tcfg, _p = tiny
    rs = np.random.RandomState(8)
    prefix = rs.randint(1, tcfg.vocab_size, (10,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rs.randint(
        1, tcfg.vocab_size, (n,)).astype(np.int32)]) for n in (3, 5)]
    kw = dict(max_slots=2, block_size=4, max_prompt_len=16,
              max_new_tokens=5)
    spec = dict(temperature=1.1, top_p=0.9, seed=5150)
    ref, _ = _run(_ref_server(model, enable_prefix_cache=True, **kw),
                  prompts, [JParams(**spec)] * 2)
    outs = {}
    for on in (False, True):
        outs[on], st = _run(_port_server(port, enable_prefix_cache=on,
                                         **kw),
                            prompts, [SamplingParams(**spec)] * 2)
        if on:
            assert st["kv_cache"]["prefix_cache"]["hits"] >= 1
    _assert_same(outs[True], outs[False])
    _assert_same(outs[True], ref)


def _int8_near_tie(port_params, tcfg, seq, dense_seq):
    """True where the int8 run's first differing token is one the dense
    logits place within LOGIT_TOL of the logit scale of their top
    token (the int8 tolerance of tests/test_quantized_serving.py)."""
    i = int(np.nonzero(seq != dense_seq)[0][0])
    lg = dense_logits(port_params, tcfg, seq[:i])
    scale = lg.abs().max().item()
    return (lg.max() - lg[int(seq[i])]).item() <= LOGIT_TOL * scale


def _int8_vs_dense(tiny, dense, int8):
    """int8 tokens equal the dense ones, or first differ at a token the
    dense logits hold within the int8 tolerance of the top one. Returns
    the number of sequences that differ."""
    params, tcfg = tiny[4], tiny[3]
    n = 0
    for a, b in zip(dense, int8):
        assert a.shape == b.shape
        if not np.array_equal(a, b):
            assert _int8_near_tie(params, tcfg, b, a), (a, b)
            n += 1
    return n


class TestServedParityKV8:
    """The kv8_only cases of TestServedParity (tests/test_quantized_
    serving.py), int8-KV serving on the port: the reference server's
    int8 tokens exactly, and dense within the int8 tolerance."""

    def test_decode_and_chunked_prefill_parity(self, tiny):
        model, cfg, port, tcfg, _p = tiny
        ids = np.random.RandomState(0).randint(
            1, tcfg.vocab_size, (4, 36)).astype(np.int32)
        prompts = [ids[i, :n] for i, n in enumerate((36, 30, 25, 21))]
        kw = dict(max_slots=2, block_size=4, max_prompt_len=48,
                  max_new_tokens=8, prefill_chunk_tokens=16)
        ref8, _ = _run(_ref_server(model, kv_dtype="int8", **kw), prompts,
                       burst=True)
        out8, st = _run(_port_server(port, kv_dtype="int8", **kw), prompts,
                        burst=True)
        dense, _ = _run(_port_server(port, **kw), prompts, burst=True)
        _assert_same(out8, ref8)
        assert st["kv_cache"]["kv_dtype"] == "int8"
        _int8_vs_dense(tiny, dense, out8)

    def test_prefix_cache_on_off_parity(self, tiny):
        model, cfg, port, tcfg, _p = tiny
        rs = np.random.RandomState(11)
        prefix = rs.randint(1, tcfg.vocab_size, (14,)).astype(np.int32)
        prompts = [np.concatenate([prefix, rs.randint(
            1, tcfg.vocab_size, (int(rs.randint(2, 8)),)
        ).astype(np.int32)]) for _ in range(5)]
        kw = dict(max_slots=2, block_size=4, max_prompt_len=48,
                  max_new_tokens=8, prefill_chunk_tokens=16, kv_dtype="int8")
        dense, _ = _run(_port_server(port, **{**kw, "kv_dtype": None}),
                        prompts, burst=True)
        off, _ = _run(_port_server(port, **kw), prompts, burst=True)
        on, _ = _run(_port_server(port, enable_prefix_cache=True, **kw),
                     prompts, burst=True)
        ref_on, _ = _run(_ref_server(model, enable_prefix_cache=True, **kw),
                         prompts, burst=True)
        srv = _port_server(port, enable_prefix_cache=True, **kw).start()
        try:
            [f.result(timeout=300) for f in [srv.submit(p) for p in prompts]]
            warm = [f.result(timeout=300)
                    for f in [srv.submit(p) for p in prompts]]
            assert srv.cache.stats()["prefix_cache"]["hit_tokens"] > 0
        finally:
            srv.stop()
        _assert_same(on, ref_on)
        _assert_same(on, off)
        _assert_same(warm, off)
        _int8_vs_dense(tiny, dense, off)
