"""Shared helpers of the tests/test_torch_*.py twins: one tiny GPT-2 built
by the JAX reference and carried into the PyTorch port through the
weight bridge, so both sides compute the same function on the CPU."""
import threading

import numpy as np
import torch


def reference_tiny_model(seed):
    """(reference GPT2, its config, the port's GPT2 with the same weights,
    the port's config) — f32, dropout off, on the CPU."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt2 import GPT2, GPT2Config

    from paddle_tpu_torch.models.gpt2 import GPT2Config as TConfig
    from paddle_tpu_torch.models.gpt2 import from_reference_params

    paddle.seed(seed)
    cfg = GPT2Config.tiny()
    cfg.dropout = 0.0
    model = GPT2(cfg)
    model.eval()
    params, _ = model.functional_state()
    tcfg = TConfig.tiny()
    tcfg.dropout = 0.0
    port = from_reference_params(
        tcfg, {k: np.asarray(v) for k, v in params.items()}, device="cpu")
    return model, cfg, port, tcfg


def t(a, dtype=None):
    """numpy -> CPU torch tensor (a copy; int32 stays int32)."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def dense_logits(port_params, cfg, ids):
    """float32 logits of the last position of `ids` by a plain causal
    forward over the whole sequence (no cache): shares no code with the
    paged engine."""
    import torch.nn.functional as F

    E, H = cfg.hidden_size, cfg.num_heads
    Dh = E // H
    p = port_params
    tk = torch.tensor([int(x) for x in ids])
    S = tk.numel()
    x = p["wte.weight"][tk] + p["wpe.weight"][:S]
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    for i in range(cfg.num_layers):
        a = F.layer_norm(x, (E,), p[f"h.{i}.ln_1.weight"],
                         p[f"h.{i}.ln_1.bias"], cfg.layer_norm_epsilon)
        qkv = a @ p[f"h.{i}.qkv_proj.weight"] + p[f"h.{i}.qkv_proj.bias"]
        q, k, v = (u.reshape(S, H, Dh).transpose(0, 1)
                   for u in qkv.split(E, dim=-1))
        s = (q @ k.transpose(1, 2)) * Dh ** -0.5
        w = torch.softmax(s.masked_fill(~causal, -1e30), dim=-1)
        o = (w @ v).transpose(0, 1).reshape(S, E)
        x = x + o @ p[f"h.{i}.out_proj.weight"] + p[f"h.{i}.out_proj.bias"]
        m = F.layer_norm(x, (E,), p[f"h.{i}.ln_2.weight"],
                         p[f"h.{i}.ln_2.bias"], cfg.layer_norm_epsilon)
        hdn = F.gelu(m @ p[f"h.{i}.fc1.weight"] + p[f"h.{i}.fc1.bias"],
                     approximate="tanh")
        x = x + hdn @ p[f"h.{i}.fc2.weight"] + p[f"h.{i}.fc2.bias"]
    xf = F.layer_norm(x[-1], (E,), p["ln_f.weight"], p["ln_f.bias"],
                      cfg.layer_norm_epsilon)
    return xf @ p["wte.weight"].T


def dense_greedy(port_params, cfg, prompt, n_new):
    """Plain full-recompute greedy decode of the port's weights: every
    step runs `dense_logits` over the whole sequence."""
    ids = [int(x) for x in prompt]
    for _ in range(n_new):
        ids.append(int(torch.argmax(dense_logits(port_params, cfg, ids))))
    return np.asarray(ids, np.int32)


def _pool_leaves(kv):
    """(codes, scales) of an int8 pool or payload, else the one array."""
    return (kv.codes, kv.scales) if hasattr(kv, "codes") else (kv,)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# the pool methods a PoolMirror runs on both pools; any other attribute
# is read from the port's pool
MIRRORED = ("allocate", "ensure", "ensure_many", "append", "free",
            "truncate_seq", "attach_prefix", "publish_prefix",
            "prepare_write", "swap_out_seq", "match_prefix_len",
            "demote_cold", "export_prefix", "import_prefix")
# stats() keys both pools report
SHARED_STATS = ("used_blocks", "free_blocks", "retained_blocks",
                "peak_retained_blocks", "peak_used_blocks", "sequences",
                "held_tokens", "prefix_cache", "tier")


class PoolMirror:
    """One op sequence through the reference pool (JAX, CPU) and the
    port's (`device="cpu"`), compared after every op: return values or
    the exception raised (type, `needed`, `available`); block tables and
    lengths; the free list and the retention order; `_ref`, `_index`,
    `_block_entries`, `_child_fills`; the tier's entries in LRU order
    with their payloads; the shared `stats()` keys; and every K/V (or
    int8 codes and scales) element of both pools, bit for bit.

    Calls of MIRRORED methods go to both pools and return the port's
    result (or raise the port's exception); `write` puts the same random
    rows into both; any other attribute is the port's."""

    def __init__(self, *, num_blocks=14, block_size=4, kv_dtype=None,
                 tier=None, shape=(1, 1, 2), seed=0):
        from paddle_tpu.inference.kv_cache import PagedKVCache as JCache
        from paddle_tpu.inference.kv_tier import HostKVTier as JTier

        from paddle_tpu_torch.inference.kv_cache import PagedKVCache
        from paddle_tpu_torch.inference.kv_tier import HostKVTier

        kw = dict(block_size=block_size, num_blocks=num_blocks,
                  kv_dtype=kv_dtype)
        self.ref = JCache(*shape, tier=None if tier is None
                          else JTier(**tier), **kw)
        self.port = PagedKVCache(*shape, tier=None if tier is None
                                 else HostKVTier(**tier), device="cpu",
                                 **kw)
        self.rs = np.random.RandomState(seed)
        self.check()

    def __getattr__(self, name):
        if name in MIRRORED:
            return lambda *a: self._both(name, *a)
        return getattr(self.port, name)

    def _both(self, op, *args):
        out = []
        for c in (self.ref, self.port):
            try:
                out.append((True, getattr(c, op)(*args)))
            except (RuntimeError, ValueError, KeyError) as e:
                out.append((False, e))
        (ok_r, r), (ok_p, p) = out
        self.last_ref = r
        assert ok_r == ok_p, (op, args, r, p)
        if not ok_p:
            assert type(r).__name__ == type(p).__name__, (op, r, p)
            assert getattr(r, "needed", None) == getattr(p, "needed", None)
            assert getattr(r, "available", None) == \
                getattr(p, "available", None)
        elif op == "export_prefix":
            assert_payloads_equal(r, p)
        else:
            assert r == p, (op, args, r, p)
        self.check()
        if not ok_p:
            raise p
        return p

    def write(self, seq, pos):
        """The same random content into rows [pos, seq_len) of `seq` in
        both pools (dense: float32 normals; int8: codes and positive
        scales), one block at a time."""
        j, t = self.ref, self.port
        table = t.block_table(seq)
        end = t.seq_len(seq)
        bs = t.block_size
        kj, vj = j.k_blocks, j.v_blocks
        for r0 in range(int(pos), end):
            if r0 != int(pos) and r0 % bs:
                continue
            r1 = min(end, (r0 // bs + 1) * bs)
            b, lo, hi = table[r0 // bs], r0 % bs, (r1 - 1) % bs + 1
            vals = []
            for _ in range(2):
                shp = (t.num_layers, hi - lo, t.num_heads, t.head_dim)
                if t.kv_dtype == "int8":
                    vals.append((
                        self.rs.randint(-127, 128, shp).astype(np.int8),
                        self.rs.uniform(0.01, 1.0, shp[:-1])
                        .astype(np.float32)))
                else:
                    vals.append((self.rs.randn(*shp).astype(np.float32),))
            new = []
            for arr, tarr, val in ((kj, t.k_blocks, vals[0]),
                                   (vj, t.v_blocks, vals[1])):
                leaves = []
                for a, ta, x in zip(_pool_leaves(arr), _pool_leaves(tarr),
                                    val):
                    leaves.append(a.at[:, b, lo:hi].set(x))
                    ta[:, b, lo:hi] = torch.from_numpy(x)
                new.append(type(arr)(*leaves) if hasattr(arr, "codes")
                           else leaves[0])
            kj, vj = new
        j.swap_arrays(kj, vj)
        self.check()

    def check(self):
        j, t = self.ref, self.port
        assert t._tables == j._tables
        assert t._lens == j._lens
        assert t._free == j._free
        assert list(t._retained) == list(j._retained)
        assert t._ref == j._ref
        assert t._index == j._index
        assert t._block_entries == j._block_entries
        assert t._child_fills == j._child_fills
        sj, st = j.stats(), t.stats()
        for k in SHARED_STATS:
            assert st[k] == sj[k], (k, st[k], sj[k])
        if t.tier is not None:
            assert list(t.tier._entries) == list(j.tier._entries)
            assert t.tier._child_fills == j.tier._child_fills
            for h, (f, par, kp, vp) in t.tier._entries.items():
                fj, pj, kpj, vpj = j.tier._entries[h]
                assert (f, par) == (fj, pj)
                for a, b in ((kp, kpj), (vp, vpj)):
                    for x, y in zip(_pool_leaves(a), _pool_leaves(b)):
                        np.testing.assert_array_equal(_np(x), _np(y))
        for a, b in ((t.k_blocks, j.k_blocks), (t.v_blocks, j.v_blocks)):
            for x, y in zip(_pool_leaves(a), _pool_leaves(b)):
                np.testing.assert_array_equal(_np(x), _np(y))


def assert_payloads_equal(a, b):
    """Two export_prefix payloads: the same keys, layout, tokens and
    fills, and the same block contents bit for bit."""
    if a is None or b is None:
        assert a is None and b is None
        return
    assert set(a) == set(b)
    for key in a:
        if key not in ("k", "v"):
            assert a[key] == b[key], key
    for key in ("k", "v"):
        assert len(a[key]) == len(b[key])
        for x, y in zip(a[key], b[key]):
            for u, w in zip(_pool_leaves(x), _pool_leaves(y)):
                assert isinstance(w, np.ndarray)
                np.testing.assert_array_equal(_np(u), w)


def check_pool_invariants(c):
    """The reference's pool invariants (tests/test_prefix_cache.py's
    check_invariants) on the port's pool: free, retained and the live
    tables partition it, refcounts, the index's reverse maps, int8
    leaves, and the tier's disjoint index."""
    from paddle_tpu_torch.inference.kv_cache import blocks_for

    usable = set(range(1, c.num_blocks))
    free = set(c._free)
    assert len(free) == len(c._free), "free list holds duplicates"
    retained = set(c._retained)
    in_tables = set()
    refs = {}
    for seq, table in c._tables.items():
        assert len(table) == len(set(table))
        assert len(table) == blocks_for(c._lens[seq], c.block_size)
        for b in table:
            in_tables.add(b)
            refs[b] = refs.get(b, 0) + 1
    assert free | retained | in_tables == usable
    assert not free & retained
    assert not free & in_tables
    assert not retained & in_tables
    assert refs == c._ref
    assert 0 not in free | retained | in_tables
    assert 0 not in c._block_entries
    for b in retained:
        assert c._block_entries.get(b)
    for h, (blk, fill, parent) in c._index.items():
        assert blk in in_tables | retained
        assert 0 < fill <= c.block_size
        assert h in c._block_entries[blk]
        assert c._child_fills[parent].get(fill, 0) >= 1
    if c.kv_dtype == "int8":
        for kv in (c.k_blocks, c.v_blocks):
            assert kv.codes.dtype == torch.int8
            assert kv.codes.shape == (c.num_layers, c.num_blocks,
                                      c.block_size, c.num_heads,
                                      c.head_dim)
            assert kv.scales.shape == kv.codes.shape[:-1]
    if c.tier is not None:
        t = c.tier
        assert not set(c._index) & set(t._entries)
        assert len(t) <= t.capacity_blocks
        fills_seen = {}
        for h, (fill, parent, kp, vp) in t._entries.items():
            assert 0 < fill <= c.block_size
            for pay in (kp, vp):
                assert pay.codes.dtype == torch.int8
                assert tuple(pay.codes.shape) == (c.num_layers, fill,
                                                  c.num_heads, c.head_dim)
                assert pay.scales.shape == pay.codes.shape[:-1]
            fs = fills_seen.setdefault(parent, {})
            fs[fill] = fs.get(fill, 0) + 1
        assert fills_seen == t._child_fills
        assert t.tokens_resident() == sum(
            ent[0] for ent in t._entries.values())


def pool_step_fuzz(c, rs, n_ops, tier):
    """A fixed-seed op sequence on a `PoolMirror` (so every op is
    compared with the reference pool): admit (attach, or allocate, then
    ensure + prepare_write + K/V writes), grow, ensure_many, publish,
    prepare_write + writes, truncate, swap_out, free, export/import, and
    with a tier match_prefix_len (promotion) and demote_cold. Returns the
    port's final stats."""
    from paddle_tpu_torch.inference.kv_cache import BlockPoolExhausted

    master = rs.randint(1, 50, size=48).astype(np.int32)
    live = {}
    nxt = [0]

    def tokens():
        n = int(rs.randint(1, 30))
        t = master[:n].copy()
        if rs.rand() < 0.4:
            t = np.concatenate([t, rs.randint(1, 50, size=int(
                rs.randint(1, 7))).astype(np.int32)])
        return t

    def pick():
        return list(live)[int(rs.randint(len(live)))]

    def op_admit():
        seq = nxt[0]
        nxt[0] += 1
        toks = tokens()
        try:
            cached = c.attach_prefix(seq, toks)
            if cached == 0:
                c.allocate(seq, toks.size)
                c.write(seq, 0)
            else:
                c.ensure(seq, toks.size)
                c.prepare_write(seq, cached)
                c.write(seq, cached)
        except BlockPoolExhausted:
            if c.has_seq(seq):
                c.free(seq)
            return
        live[seq] = toks

    def op_grow():
        if live:
            s = pick()
            n0 = c.seq_len(s)
            try:
                if rs.rand() < 0.5:
                    c.append(s, int(rs.randint(1, 6)))
                else:
                    c.ensure(s, n0 + int(rs.randint(0, 6)))
            except BlockPoolExhausted:
                return
            c.write(s, n0)

    def op_bulk():
        if live:
            picks = {pick() for _ in range(3)}
            try:
                c.ensure_many([(s, c.seq_len(s) + int(rs.randint(0, 5)))
                               for s in sorted(picks)])
            except BlockPoolExhausted:
                pass

    def op_publish():
        if live:
            s = pick()
            c.publish_prefix(s, live[s][:c.seq_len(s)])

    def op_write():
        if live:
            s = pick()
            pos = int(rs.randint(0, c.seq_len(s) + 1))
            try:
                c.prepare_write(s, pos)
            except BlockPoolExhausted:
                return
            c.write(s, pos)

    def op_truncate():
        if live:
            s = pick()
            c.truncate_seq(s, int(rs.randint(0, c.seq_len(s) + 1)))
            live[s] = live[s][:c.seq_len(s)]

    def op_swap_out():
        if live:
            s = pick()
            ids = np.concatenate([live[s], master[:c.seq_len(s)]])
            c.swap_out_seq(s, ids[:c.seq_len(s)])
            del live[s]

    def op_free():
        if live:
            s = pick()
            if rs.rand() < 0.5:
                c.publish_prefix(s, live[s][:c.seq_len(s)])
            c.free(s)
            del live[s]

    def op_migrate():
        pay = c.export_prefix(tokens())      # compared to the reference's
        pay_ref = c.last_ref
        if pay is None:
            return
        got = []
        for pool, payload in ((c.ref, pay_ref), (c.port, pay)):
            try:
                got.append(pool.import_prefix(payload))
            except RuntimeError as e:  # both pools must refuse alike
                got.append(type(e).__name__)
        assert got[0] == got[1]
        c.check()

    def op_probe():
        c.match_prefix_len(tokens())

    def op_demote():
        c.demote_cold(int(rs.randint(1, 4)))

    ops = [op_admit, op_admit, op_grow, op_bulk, op_publish, op_write,
           op_truncate, op_swap_out, op_free, op_free, op_migrate]
    if tier:
        ops += [op_probe, op_demote]
    for _ in range(n_ops):
        ops[int(rs.randint(len(ops)))]()
        check_pool_invariants(c.port)
    for s in list(live):
        c.free(s)
    return c.stats()


def hold_at(n):
    """An on_token callback that holds the engine at its n-th token
    (bounded, 60 s) until `go` is set, so a test can queue requests
    behind busy slots whatever the speed of the engine: (callback,
    reached, go). Shared by every request it is passed to."""
    reached, go = threading.Event(), threading.Event()
    seen = [0]

    def cb(_tok, _reason):
        seen[0] += 1
        if seen[0] == n:
            reached.set()
            go.wait(60)

    return cb, reached, go
