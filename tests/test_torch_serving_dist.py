"""CPU twins of tests/test_serving_dist.py: the port's sharded serving
(`paddle_tpu_torch.serving_dist`, `PagedGenerationServer(sharding=...)`)
against the JAX package's, on the reference's tiny GPT-2 (paddle seed 0)
carried across through the flat-params bridge.

The port's multi-rank cases run in ONE 4-rank gloo world (a module
fixture): every rank constructs each server with the same arguments,
rank 0 serves the pinned workload and ranks above 0 follow
(`serve_follower()`); a tp-2 server uses ranks 0 and 1 while ranks 2 and
3 only build its mesh (group creation is collective). The reference's
sharded servers run on the 8 virtual devices of tests/conftest.py, on the
same pinned workload (test_serving_dist.py:48-60). Tokens are compared
exactly (float32; the row-split sums reassociate, as the reference's
all-reduce does). Every rank's token digest must equal rank 0's. A world
of one (no process group) is held BITWISE to the unsharded port, tokens
and decoder logits; the port's logits are held to the reference's
within 1e-5 (float32).

Decided differences (ROADMAP §C): under dp the pool's block ids and its
default size differ from the reference's (slots are pinned to block
groups), and `stats()["sharding"]` carries a "graphs" key.
"""
import sys

import numpy as np
import pytest
import torch

from torch_dist_util import run_world
from torch_twin_util import reference_tiny_model

torch.set_num_threads(1)

N = 4
SERVER = dict(max_slots=2, block_size=8, max_prompt_len=64,
              max_new_tokens=8, prefill_chunk_tokens=16)
SPS = [None, dict(temperature=0.8, top_p=0.9, seed=11), None,
       dict(temperature=1.1, top_k=20, seed=7, repetition_penalty=1.2)]
MOTIF = np.array([7, 11, 13, 5], np.int32)
QUANT = dict(quantization="w8a16", kv_dtype="int8")
COMPOSED = dict(enable_prefix_cache=True, speculation=True,
                kv_dtype="int8", quantization="w8a16")
LOGIT_TOL = 1e-5


def _prompts(vocab):
    rng = np.random.RandomState(3)
    return [rng.randint(1, vocab, (n,)).astype(np.int32)
            for n in (5, 17, 9, 23)]


def _prefix_prompts(vocab):
    p = _prompts(vocab)
    return [p[0], np.concatenate([p[3], p[0]]),
            np.concatenate([p[3], p[2]]), p[3]]


def _repeat_prompts(vocab):
    """Two of the pinned prompts, each served twice: the second copy is
    fully cached, so its one prefilled token writes into a cached block
    (a copy-on-write, mirrored on every rank)."""
    p = _prompts(vocab)
    return [p[0], p[3], p[0], p[3]]


def _spec_prompts():
    return [np.tile(MOTIF, 5), np.tile(MOTIF[::-1], 4)]


def _pair(vocab):
    rs = np.random.RandomState(2)
    pv = rs.randint(1, vocab, (1, 7)).astype(np.int32)[0]
    pi = rs.randint(1, vocab, (1, 4)).astype(np.int32)[0]
    return pv, pi


# (name, tp, dp, prompts, sampling, server kwargs): every served case
CASES = [
    ("mixed", 4, 1, "pinned", SPS, {}),
    ("prefix_off", 4, 1, "prefix", SPS, dict(enable_prefix_cache=False)),
    ("prefix_on", 4, 1, "prefix", SPS, dict(enable_prefix_cache=True)),
    ("cow", 4, 1, "repeat", SPS, dict(enable_prefix_cache=True)),
    ("spec", 4, 1, "spec", None, dict(max_new_tokens=12, speculation=True)),
    ("quant", 4, 1, "pinned", SPS, QUANT),
    ("composed", 4, 1, "pinned", SPS, COMPOSED),
    ("dp14", 1, 4, "pinned", SPS, {}),
    ("dp22", 2, 2, "pinned", SPS, {}),
]


def _workload(name, vocab):
    return {"pinned": _prompts, "prefix": _prefix_prompts,
            "repeat": _repeat_prompts,
            "spec": lambda v: _spec_prompts()}[name](vocab)


# ---- the port's world -------------------------------------------------------

def _port_model(flat):
    from paddle_tpu_torch.models.gpt2 import GPT2Config, from_reference_params

    cfg = GPT2Config.tiny()
    cfg.dropout = 0.0
    return from_reference_params(cfg, flat, device="cpu")


def _port_sampling(sps, n):
    from paddle_tpu_torch.sampling import SamplingParams

    sps = sps or [None] * n
    return [None if s is None else SamplingParams(**s) for s in sps]


def _serve_rank(rank, model, prompts, sps, sharding, **kw):
    """Rank 0 serves `prompts` and returns its tokens, stats and digest;
    a follower follows and returns its digest."""
    from paddle_tpu_torch.inference import PagedGenerationServer

    args = dict(SERVER)
    args.update(kw)
    srv = PagedGenerationServer(model, device="cpu", sharding=sharding,
                                **args)
    if rank:
        return srv.serve_follower()
    srv.start()
    try:
        outs = [f.result(timeout=120).tolist() for f in
                [srv.submit(p, sampling=s) for p, s in
                 zip(prompts, _port_sampling(sps, len(prompts)))]]
        st = srv.stats()
    finally:
        srv.stop()
    return {"outs": outs, "st": st, "digest": srv._dist.digest()}


def _preempt_rank(rank, model, sharding):
    """The reference test's front-door preemption: a batch request held
    at its second token while an interactive one queues (one slot)."""
    from paddle_tpu_torch.frontend import FrontDoor

    from torch_twin_util import hold_at

    pv, pi = _pair(model.cfg.vocab_size)
    fd = FrontDoor(model, max_slots=1, block_size=4, max_prompt_len=16,
                   max_new_tokens=24, sharding=sharding, device="cpu")
    if rank:
        return fd.server.serve_follower()
    hold, reached, go = hold_at(2)
    hv = fd.submit(pv, lane="batch", max_new_tokens=24, on_token=hold)
    fd.start()
    try:
        assert reached.wait(120)
        hi_ = fd.submit(pi, lane="interactive", max_new_tokens=3)
        go.set()
        out_i = hi_.result(timeout=120)
        out_v = hv.result(timeout=120)
        st = fd.stats()
    finally:
        go.set()
        fd.stop()
    return {"v": out_v, "i": out_i, "fd": st["frontdoor"],
            "digest": fd.server._dist.digest()}


TIER = dict(max_slots=2, block_size=8, max_new_tokens=6,
            prefill_chunk_tokens=16, enable_prefix_cache=True,
            num_blocks=14, max_prompt_len=40)
MIGRATE = dict(max_slots=1, block_size=8, max_prompt_len=32,
               max_new_tokens=6, enable_prefix_cache=True,
               prefill_chunk_tokens=16)


def _tier_prompts(vocab):
    rng = np.random.RandomState(7)
    shared = rng.randint(1, vocab, (24,)).astype(np.int32)
    return [np.concatenate([shared, rng.randint(1, vocab, (k,))
                            .astype(np.int32)]) for k in (3, 5, 7, 4)]


def _tier_run(srv, prompts):
    """test_torch_kv_tier's churn: the prompts one by one, then at once
    (a pool one block above the worst case: demotions, then promotions
    of the shared prefix)."""
    outs = []
    srv.start()
    try:
        for p in prompts:
            outs.append(srv.submit(p).result(timeout=120).tolist())
        batch = [srv.submit(p) for p in prompts]
        outs += [f.result(timeout=120).tolist() for f in batch]
    finally:
        srv.stop()
    return outs, srv.stats()


def _migrate_run(make, prompt):
    """Serve `prompt`, demote a block to the tier, export the chain (the
    tier's part promoted first), import it into a fresh server and serve
    the prompt there: (first tokens, payload, second tokens, hit
    tokens). `make(tier)` builds a server."""
    from paddle_tpu_torch.inference.kv_tier import HostKVTier

    src = make(HostKVTier(capacity_blocks=16, watermark=0.0))
    src.start()
    try:
        first = src.submit(prompt).result(timeout=120)
        assert src.cache.demote_cold(1) == 1
        payload = src.cache.export_prefix(prompt)
    finally:
        src.stop()
    dst = make(None)
    dst.cache.import_prefix(payload)
    dst.start()
    try:
        out = dst.submit(prompt).result(timeout=120)
        hit = dst.stats()["kv_cache"]["prefix_cache"]["hit_tokens"]
    finally:
        dst.stop()
    return first, payload, out, hit


def _pool_ops_rank(rank, model):
    """tp 4 with the host tier (demote / promote mirrored) and a
    migration (export gathered to rank 0, import mirrored)."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.inference.kv_tier import HostKVTier
    from paddle_tpu_torch.serving_dist import ShardedEngineConfig

    tp4 = ShardedEngineConfig(tp=4)
    out = {}
    srv = PagedGenerationServer(
        model, device="cpu", sharding=tp4,
        kv_tier=HostKVTier(capacity_blocks=32, watermark=0.5), **TIER)
    if rank:
        out["tier"] = srv.serve_follower()
    else:
        outs, st = _tier_run(srv, _tier_prompts(model.cfg.vocab_size))
        out["tier"] = {"outs": outs, "tier": st["kv_cache"]["tier"],
                       "digest": srv._dist.digest()}

    def make(tier):
        s = PagedGenerationServer(model, device="cpu", sharding=tp4,
                                  kv_tier=tier, **MIGRATE)
        if rank:
            s.serve_follower()
        return s

    prompt = np.random.RandomState(4).randint(
        1, model.cfg.vocab_size, (21,)).astype(np.int32)
    if rank:
        make(HostKVTier(capacity_blocks=16, watermark=0.0))
        make(None)
    else:
        out["migrate"] = _migrate_run(make, prompt)
    return out


def _world(rank, flat):
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving_dist import (ShardedEngineConfig,
                                               pool_blocks_for_budget)

    model = _port_model(flat)
    V = model.cfg.vocab_size
    out = {}
    for name, tp, dp, work, sps, kw in CASES:
        out[name] = _serve_rank(rank, model, _workload(work, V), sps,
                                ShardedEngineConfig(tp=tp, dp=dp), **kw)
    out["preempt"] = _preempt_rank(rank, model, ShardedEngineConfig(tp=4))
    out["pool_ops"] = _pool_ops_rank(rank, model)
    out["mesh_axes"] = dict(ShardedEngineConfig(tp=2, dp=2)
                            .build_mesh().shape)
    # a tp-2 server on ranks 0 and 1 (2 and 3 only build its mesh)
    tp2 = ShardedEngineConfig(tp=2)
    if rank < 2:
        from paddle_tpu_torch.inference import PagedGenerationServer

        srv = PagedGenerationServer(model, max_slots=1, max_prompt_len=16,
                                    max_new_tokens=4, sharding=tp2,
                                    device="cpu")
        if rank == 0:
            before = srv.stats()["sharding"]
            srv.reset_stats()
            out["reset"] = (before, srv.stats()["sharding"])
            srv.stop()
        else:
            srv.serve_follower()
    else:
        tp2.build_mesh()
    # per-shard bytes and gauges at tp 4
    metrics.enable()
    from paddle_tpu_torch.inference import PagedGenerationServer

    srv = PagedGenerationServer(model, max_slots=1, max_prompt_len=16,
                                max_new_tokens=4, device="cpu",
                                sharding=ShardedEngineConfig(tp=4))
    out["gauges"] = {"kv": srv.cache.stats(), "pool": srv.cache._name,
                     "text": metrics.to_prometheus(),
                     "heads": srv.cache.k_blocks.shape[3]}
    if rank:
        srv.serve_follower()
    else:
        srv.stop()
    metrics.disable()
    # capacity at a fixed per-rank byte budget: the real tensor bytes
    budget = 1 << 19
    nb = pool_blocks_for_budget(model.cfg, 8, budget, tp=4)
    srv = PagedGenerationServer(model, max_slots=1, block_size=8,
                                max_prompt_len=24, max_new_tokens=8,
                                num_blocks=nb, device="cpu",
                                sharding=ShardedEngineConfig(tp=4))
    out["capacity"] = (nb, srv.cache.stats()["pool_bytes_per_shard"],
                       sum(t.numel() * t.element_size()
                           for t in (srv.cache.k_blocks,
                                     srv.cache.v_blocks)))
    if rank:
        srv.serve_follower()
    else:
        srv.stop()
    return out


@pytest.fixture(scope="module")
def tiny():
    model, cfg, port, tcfg = reference_tiny_model(0)
    params, _ = model.functional_state()
    flat = {k: np.asarray(v) for k, v in params.items()}
    return model, cfg, port, flat


@pytest.fixture(scope="module")
def world(tiny, tmp_path_factory):
    return run_world(_world, N, tmp_path_factory.mktemp("sdist"), tiny[3])


# ---- the reference ----------------------------------------------------------

def _ref_serve(model, prompts, sps=None, **kw):
    from paddle_tpu.inference import PagedGenerationServer
    from paddle_tpu.sampling import SamplingParams

    args = dict(SERVER)
    args.update(kw)
    srv = PagedGenerationServer(model, **args).start()
    try:
        sps = sps or [None] * len(prompts)
        outs = [f.result(timeout=600).tolist() for f in
                [srv.submit(p, sampling=None if s is None
                            else SamplingParams(**s))
                 for p, s in zip(prompts, sps)]]
        st = srv.stats()
    finally:
        srv.stop()
    return outs, st


def _ref_case(tiny, name):
    from paddle_tpu.serving_dist import ShardedEngineConfig as RefCfg

    model, cfg = tiny[0], tiny[1]
    _n, tp, dp, work, sps, kw = next(c for c in CASES if c[0] == name)
    return _ref_serve(model, _workload(work, cfg.vocab_size), sps,
                      sharding=RefCfg(tp=tp, dp=dp), **kw)


def _digests_equal(world, key, n=N):
    d0 = world[0][key]["digest"]
    assert all(world[r][key]["digest"] == d0 for r in range(1, n)), key


def _port_serve(tiny, prompts, sps=None, **kw):
    """The port's server in this process (a world of one)."""
    from paddle_tpu_torch.inference import PagedGenerationServer

    args = dict(SERVER)
    args.update(kw)
    srv = PagedGenerationServer(tiny[2], device="cpu", **args).start()
    try:
        outs = [f.result(timeout=120).tolist() for f in
                [srv.submit(p, sampling=s) for p, s in
                 zip(prompts, _port_sampling(sps, len(prompts)))]]
        st = srv.stats()
    finally:
        srv.stop()
    return outs, st


# ---- TestConfig -------------------------------------------------------------

class TestConfig:
    def test_validation_eager(self):
        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        with pytest.raises(ValueError, match="tp=0"):
            ShardedEngineConfig(tp=0)
        with pytest.raises(ValueError, match="dp=-1"):
            ShardedEngineConfig(dp=-1)
        with pytest.raises(ValueError, match="tp=2.5"):
            ShardedEngineConfig(tp=2.5)

    def test_tp_must_divide_heads(self, tiny):
        from paddle_tpu_torch.inference import PagedGenerationServer
        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        with pytest.raises(ValueError, match="num_heads"):
            PagedGenerationServer(tiny[2], device="cpu",
                                  sharding=ShardedEngineConfig(tp=3))

    def test_sharding_type_checked(self, tiny):
        from paddle_tpu_torch.inference import PagedGenerationServer

        with pytest.raises(TypeError, match="ShardedEngineConfig"):
            PagedGenerationServer(tiny[2], device="cpu", sharding="tp4")

    def test_device_shortfall_named(self):
        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        with pytest.raises(ValueError, match="needs 256 ranks"):
            ShardedEngineConfig(tp=4, dp=64).build_mesh()

    def test_mesh_axes_canonical(self, world):
        assert world[0]["mesh_axes"] == {"dp": 2, "pp": 1, "mp": 2,
                                         "sp": 1}
        assert all(world[r]["mesh_axes"] == world[0]["mesh_axes"]
                   for r in range(N))

    def test_true_normalizes_to_defaults(self, tiny):
        from paddle_tpu_torch.inference import PagedGenerationServer
        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        srv = PagedGenerationServer(tiny[2], max_slots=1, max_prompt_len=16,
                                    max_new_tokens=4, sharding=True,
                                    device="cpu")
        assert srv.sharding == ShardedEngineConfig()
        assert srv.stats()["sharding"]["tp_degree"] == 1


# ---- TestPlan ---------------------------------------------------------------

NAMES = [("h.0.qkv_proj.weight", 2), ("h.0.qkv_proj.bias", 1),
         ("h.3.fc1.weight", 2), ("h.3.fc1.bias", 1),
         ("h.1.out_proj.weight", 2), ("h.1.out_proj.bias", 1),
         ("h.1.fc2.weight", 2), ("h.1.fc2.bias", 1), ("wte.weight", 2),
         ("wpe.weight", 2), ("ln_f.weight", 1), ("h.0.ln_1.weight", 1),
         ("lm_head.weight", 2), ("h.0.qkv_proj.weight::w8c", 2),
         ("h.0.qkv_proj.weight::w8s", 1), ("h.0.out_proj.weight::w8s", 1),
         ("wte.weight::w8c", 2), ("wte.weight::w8s", 1)]


class TestPlan:
    """The port's specs equal the reference's, name for name."""

    @pytest.mark.parametrize("names", [NAMES[:8], NAMES[8:13]],
                             ids=["column_and_row_split",
                                  "vocab_parallel_and_replicated"])
    def test_specs_equal_reference(self, names):
        from paddle_tpu.serving_dist import decode_spec_for as ref_spec

        from paddle_tpu_torch.serving_dist import decode_spec_for

        for name, nd in names:
            assert tuple(decode_spec_for(name, nd)) \
                == tuple(ref_spec(name, nd)), name

    def test_w8_keys_follow_their_weight(self):
        from paddle_tpu.serving_dist import decode_spec_for as ref_spec

        from paddle_tpu_torch.serving_dist import decode_spec_for

        for name, nd in NAMES[13:]:
            assert tuple(decode_spec_for(name, nd)) \
                == tuple(ref_spec(name, nd)), name

    def test_indivisible_dims_fall_back_replicated(self, tiny):
        """_fit as the reference's; and the cut: tp 4 ranks' qkv parts,
        each head by head inside q, k and v, rebuild the full leaf."""
        import types

        from paddle_tpu_torch.parallel.mesh import P
        from paddle_tpu_torch.serving_dist.plan import (_fit,
                                                        shard_decode_params)

        shape = {"dp": 1, "pp": 1, "mp": 4, "sp": 1}
        assert _fit(shape, P("mp", None), (50257, 64)) == P(None, None)
        assert _fit(shape, P("mp", None), (1024, 64)) == P("mp", None)
        assert _fit(shape, P(None, "mp"), (64, 50257)) == P(None, None)
        params = tiny[2].flat_params()
        H = tiny[2].cfg.num_heads
        parts = [shard_decode_params(params, types.SimpleNamespace(
            shape=shape, coords={"mp": m}), H) for m in range(4)]
        E = params["wte.weight"].shape[1]
        w = params["h.0.qkv_proj.weight"]
        for t in range(3):                          # q, k, v
            got = torch.cat([p["h.0.qkv_proj.weight"][:, t * E // 4:
                                                      (t + 1) * E // 4]
                             for p in parts], dim=1)
            assert torch.equal(got, w[:, t * E:(t + 1) * E])
        assert torch.equal(torch.cat([p["wte.weight"] for p in parts]),
                           params["wte.weight"])
        assert torch.equal(torch.cat([p["h.1.fc2.weight"] for p in parts]),
                           params["h.1.fc2.weight"])
        assert parts[2]["h.1.fc2.bias"] is params["h.1.fc2.bias"]


# ---- TestOneDeviceMeshBitwise -----------------------------------------------

class TestOneDeviceMeshBitwise:
    """A world of one: bitwise the unsharded port."""

    def test_greedy_and_sampled_tokens_identical(self, tiny):
        from paddle_tpu.serving_dist import ShardedEngineConfig as RefCfg

        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        V = tiny[1].vocab_size
        ref, _ = _port_serve(tiny, _prompts(V), SPS)
        out, st = _port_serve(tiny, _prompts(V), SPS,
                              sharding=ShardedEngineConfig(tp=1))
        assert out == ref
        rout, rst = _ref_serve(tiny[0], _prompts(V), SPS,
                               sharding=RefCfg(tp=1))
        assert out == rout
        assert st["sharding"] == dict(rst["sharding"], graphs="off (cpu)")

    def test_decoder_logits_bitwise(self, tiny):
        """The world of one's decoder is the unsharded program: its
        prefill logits bitwise the unsharded decoder's, and within 1e-5 of
        the reference's sharded decoder's."""
        import jax.numpy as jnp

        from paddle_tpu.inference.kv_cache import PagedKVCache as RefCache
        from paddle_tpu.nn.decode import PagedDecoder as RefDecoder
        from paddle_tpu.sampling.buffers import greedy_args as ref_greedy
        from paddle_tpu.serving_dist import ShardedEngineConfig as RefCfg
        from paddle_tpu.serving_dist.plan import (build_decode_shardings,
                                                  place_decode_params,
                                                  place_kv_pool)

        from paddle_tpu_torch.inference import PagedGenerationServer
        from paddle_tpu_torch.sampling.buffers import greedy_args

        model, cfg, port, _ = tiny
        ids = np.random.RandomState(5).randint(
            1, cfg.vocab_size, (2, 12)).astype(np.int32)
        lens = np.array([12, 9], np.int32)

        def port_logits(sharding):
            srv = PagedGenerationServer(port, max_slots=2, block_size=8,
                                        num_blocks=8, max_prompt_len=16,
                                        max_new_tokens=4, device="cpu",
                                        sharding=sharding)
            dec = type(srv._decoder)(srv._decoder.spec, 8,
                                     return_logits=True)
            srv.cache.ensure_many([(0, 12), (1, 9)])
            tables = torch.from_numpy(srv.cache.table_array([0, 1], 2))
            out = dec.prefill(srv._params, torch.from_numpy(ids),
                              torch.from_numpy(lens), tables,
                              srv.cache.k_blocks, srv.cache.v_blocks,
                              greedy_args(2, "cpu"))
            return out[-1].numpy(), type(srv._decoder)

        plain, _ = port_logits(None)
        one, kind = port_logits(True)
        assert kind.__name__ == "PagedDecoder"
        np.testing.assert_array_equal(plain, one)
        params, _ = model.functional_state()
        spec = (cfg.num_layers, cfg.num_heads,
                cfg.hidden_size // cfg.num_heads, cfg.hidden_size,
                cfg.layer_norm_epsilon, cfg.tie_embeddings)
        cache = RefCache(cfg.num_layers, cfg.num_heads,
                         cfg.hidden_size // cfg.num_heads, block_size=8,
                         num_blocks=8, dtype=jnp.float32)
        mesh = RefCfg(tp=1).build_mesh()
        p = place_decode_params(mesh, params)
        place_kv_pool(mesh, cache)
        dec = RefDecoder(spec, 8, return_logits=True,
                         shardings=build_decode_shardings(mesh, p, None))
        cache.ensure_many([(0, 12), (1, 9)])
        out = dec.prefill(p, jnp.asarray(ids), jnp.asarray(lens),
                          jnp.asarray(cache.table_array([0, 1], 2)),
                          cache.k_blocks, cache.v_blocks, ref_greedy(2))
        np.testing.assert_allclose(one, np.asarray(out[-1]), rtol=0,
                                   atol=LOGIT_TOL)


# ---- TestMeshParity ---------------------------------------------------------

class TestMeshParity:
    """tp 4 (4 ranks) tokens equal the reference's tp-4 server's, and
    every rank's tokens rank 0's."""

    @pytest.mark.parametrize("name", ["mixed", "spec", "quant"],
                             ids=["mixed_greedy_sampled", "spec_decode",
                                  "int8_kv_and_w8a16"])
    def test_tokens_equal_reference(self, tiny, world, name):
        ref, rst = _ref_case(tiny, name)
        got = world[0][name]
        assert got["outs"] == ref
        _digests_equal(world, name)
        st = got["st"]
        assert st["sharding"]["tp_degree"] == 4
        assert st["sharding"]["graphs"].startswith("off (world > 1")
        if name == "spec":
            assert st["speculation"]["proposed_tokens"] >= 1
        if name == "quant":
            assert st["quantization"]["enabled"] is True

    def test_prefix_cache_on_off(self, tiny, world):
        ref, _ = _ref_case(tiny, "prefix_on")
        for key in ("prefix_off", "prefix_on"):
            assert world[0][key]["outs"] == ref, key
            _digests_equal(world, key)
        pc = world[0]["prefix_on"]["st"]["kv_cache"]["prefix_cache"]
        assert pc["hits"] >= 1

    def test_copy_on_write_mirrored(self, tiny, world):
        """A fully cached prompt's prefill writes into a cached block: the
        copy runs on rank 0's slice and, through the pool mirror, on
        every other rank's (a missed mirror changes the tokens)."""
        ref, _ = _ref_case(tiny, "cow")
        got = world[0]["cow"]
        assert got["outs"] == ref
        _digests_equal(world, "cow")
        assert got["st"]["kv_cache"]["prefix_cache"]["cow_copies"] >= 1

    def test_composed_acceptance_workload(self, tiny, world):
        ref, _ = _ref_case(tiny, "composed")
        got = world[0]["composed"]
        assert got["outs"] == ref
        _digests_equal(world, "composed")
        assert got["st"]["sharding"]["mesh_shape"] == {"dp": 1, "mp": 4,
                                                       "sp": 1}

    @pytest.mark.parametrize("name", ["dp14", "dp22"])
    def test_dp_axes(self, tiny, world, name):
        """dp pins slots to block groups: tokens equal the reference's
        dp placement; block ids may differ (§C)."""
        ref, _ = _ref_case(tiny, name)
        got = world[0][name]
        assert got["outs"] == ref
        _digests_equal(world, name)
        tp, dp = {"dp14": (1, 4), "dp22": (2, 2)}[name]
        assert got["st"]["sharding"]["mesh_shape"] == {"dp": dp, "mp": tp,
                                                       "sp": 1}

    def test_tier_and_migration_mirrored(self, tiny, world):
        """The device-side pool operations beyond copy-on-write: the
        tier's demote and promote (each rank keeps its own slice) and a
        migration (export gathers every rank's heads, import writes each
        rank's) give the unsharded port's tokens and payload."""
        from paddle_tpu_torch.inference import PagedGenerationServer
        from paddle_tpu_torch.inference.kv_tier import HostKVTier

        port = tiny[2]
        V = tiny[1].vocab_size
        got = world[0]["pool_ops"]
        ref, _ = _tier_run(PagedGenerationServer(
            port, device="cpu",
            kv_tier=HostKVTier(capacity_blocks=32, watermark=0.5), **TIER),
            _tier_prompts(V))
        assert got["tier"]["outs"] == ref
        assert got["tier"]["tier"]["demotions"] > 0
        assert got["tier"]["tier"]["promotions"] > 0
        assert world[1]["pool_ops"]["tier"]["digest"] \
            == got["tier"]["digest"]
        prompt = np.random.RandomState(4).randint(1, V, (21,)) \
            .astype(np.int32)
        want = _migrate_run(lambda tier: PagedGenerationServer(
            port, device="cpu", kv_tier=tier, **MIGRATE), prompt)
        first, payload, out, hit = got["migrate"]
        np.testing.assert_array_equal(first, want[0])
        np.testing.assert_array_equal(out, want[2])
        assert hit == want[3] > 0
        assert payload["fills"] == want[1]["fills"]
        for a, b in zip(payload["k"] + payload["v"],
                        want[1]["k"] + want[1]["v"]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=0, atol=1e-5)

    def test_preempt_resume_parity(self, tiny, world):
        """Preempt-then-resume through the sharded pool: both requests
        equal the reference's solo generate."""
        model, cfg = tiny[0], tiny[1]
        pv, pi = _pair(cfg.vocab_size)
        got = world[0]["preempt"]
        assert got["fd"]["preemptions"] >= 1 and got["fd"]["resumes"] >= 1
        _digests_equal(world, "preempt")
        np.testing.assert_array_equal(
            got["v"], model.generate(pv[None], 24).numpy()[0])
        np.testing.assert_array_equal(
            got["i"], model.generate(pi[None], 3).numpy()[0])


# ---- TestStatsAndTelemetry --------------------------------------------------

class TestStatsAndTelemetry:
    def test_sharding_block_zeroed_when_disabled(self, tiny):
        from paddle_tpu.inference import PagedGenerationServer as RefSrv

        from paddle_tpu_torch.inference import PagedGenerationServer

        srv = PagedGenerationServer(tiny[2], max_slots=1, max_prompt_len=16,
                                    max_new_tokens=4, device="cpu")
        ref = RefSrv(tiny[0], max_slots=1, max_prompt_len=16,
                     max_new_tokens=4)
        assert srv.stats()["sharding"] == ref.stats()["sharding"]

    def test_sharding_block_reset_coherent(self, world):
        before, after = world[0]["reset"]
        assert after == before
        assert before["tp_degree"] == 2

    def test_pool_shard_bytes_and_gauges(self, world):
        g = world[0]["gauges"]
        kv, pool = g["kv"], g["pool"]
        assert kv["shards"] == 4
        assert kv["pool_bytes_per_shard"] * 4 == kv["pool_bytes_total"]
        assert g["heads"] == 1  # 4 heads over tp 4: each rank holds 1
        assert f'kv_pool_bytes_total{{pool="{pool}",shard="all"}}' \
            in g["text"]
        assert f'kv_pool_bytes_total{{pool="{pool}",shard="3"}}' \
            in g["text"]

    def test_unsharded_pool_has_no_per_shard_series(self, tiny):
        from paddle_tpu_torch.inference import PagedGenerationServer
        from paddle_tpu_torch.observability import metrics

        was = metrics.enabled()
        metrics.enable()
        try:
            srv = PagedGenerationServer(tiny[2], max_slots=1,
                                        max_prompt_len=16, max_new_tokens=4,
                                        device="cpu")
            srv.cache.ensure_many([("s", 4)])
            srv.cache.free("s")
            pool = srv.cache._name
            text = metrics.to_prometheus()
            assert f'kv_pool_bytes_total{{pool="{pool}",shard="all"}}' \
                in text
            assert f'{{pool="{pool}",shard="0"}}' not in text
        finally:
            if not was:
                metrics.disable()


# ---- TestCapacity -----------------------------------------------------------

class TestCapacity:
    """At a fixed per-rank byte budget the pool holds tp * dp times the
    blocks: the reference's arithmetic, and the port's real tensors."""

    def test_blocks_scale_with_mesh(self, tiny):
        from paddle_tpu.serving_dist import pool_blocks_for_budget as ref

        from paddle_tpu_torch.serving_dist import pool_blocks_for_budget

        cfg = tiny[1]
        budget = 1 << 20
        got = [pool_blocks_for_budget(cfg, 16, budget, tp=tp, dp=dp)
               for tp, dp in ((1, 1), (4, 1), (2, 2))]
        assert got == [ref(cfg, 16, budget, tp=tp, dp=dp)
                       for tp, dp in ((1, 1), (4, 1), (2, 2))]
        assert got[1] >= 3.9 * got[0] and got[2] >= 3.9 * got[0]

    def test_slots_ratio_at_four_devices(self, tiny):
        from paddle_tpu.serving_dist import max_slots_for_budget as ref

        from paddle_tpu_torch.serving_dist import max_slots_for_budget

        cfg = tiny[1]
        budget = 1 << 20
        s1 = max_slots_for_budget(cfg, 16, budget, tokens_per_request=96)
        s4 = max_slots_for_budget(cfg, 16, budget, tokens_per_request=96,
                                  tp=4)
        assert (s1, s4) == (ref(cfg, 16, budget, tokens_per_request=96),
                            ref(cfg, 16, budget, tokens_per_request=96,
                                tp=4))
        assert s1 >= 1 and s4 >= 3 * s1

    def test_sharded_server_actually_admits_more(self, tiny, world):
        """A tp-4 rank's pool tensors really hold 1/4 of the blocks'
        bytes: within the per-rank budget with >= 3x the slots."""
        from paddle_tpu_torch.inference.kv_cache import blocks_for
        from paddle_tpu_torch.serving_dist import pool_blocks_for_budget

        cfg = tiny[1]
        budget = 1 << 19
        nb1 = pool_blocks_for_budget(cfg, 8, budget)
        nb4, per_shard, tensor_bytes = world[0]["capacity"]
        assert per_shard == tensor_bytes <= budget
        for r in range(N):
            assert world[r]["capacity"] == world[0]["capacity"]
        horizon = blocks_for(24 + 8, 8)
        assert (nb4 - 1) // horizon >= 3 * max((nb1 - 1) // horizon, 1)


# ---- TestZeroOverheadWhenDisabled -------------------------------------------

class TestZeroOverheadWhenDisabled:
    def test_unsharded_server_never_imports_serving_dist(self, tiny):
        from paddle_tpu_torch.inference import PagedGenerationServer

        saved = {k: sys.modules.pop(k) for k in list(sys.modules)
                 if k.startswith("paddle_tpu_torch.serving_dist")}
        try:
            PagedGenerationServer(tiny[2], max_slots=1, max_prompt_len=16,
                                  max_new_tokens=4, device="cpu")
            leaked = [k for k in sys.modules
                      if k.startswith("paddle_tpu_torch.serving_dist")]
            assert not leaked, leaked
        finally:
            sys.modules.update(saved)


# ---- the pool's block groups (the dp rule) ----------------------------------

class TestPoolGroups:
    """`PagedKVCache(groups=...)`: each group's first block is its trash
    block, a sequence allocates only in its group, a prefix match stops at
    another group's block, and a rank's tensors hold its group's blocks
    and its heads only."""

    def _pool(self, group=0):
        from paddle_tpu_torch.inference.kv_cache import PagedKVCache

        return PagedKVCache(2, 4, 8, block_size=4, num_blocks=10,
                            device="cpu", local_heads=2, head_offset=2,
                            groups=2, group=group)

    def test_groups_allocate_apart(self):
        from paddle_tpu_torch.inference.kv_cache import BlockPoolExhausted

        c = self._pool()
        assert tuple(c.k_blocks.shape) == (2, 5, 4, 2, 8)
        assert sorted(c._free) == [1, 2, 3, 4, 6, 7, 8, 9]
        assert c.stats()["num_blocks"] == 8
        c.set_seq_group("b", 1)
        c.ensure_many([("a", 8), ("b", 12)])
        assert all(b < 5 for b in c.block_table("a"))
        assert all(5 < b < 10 for b in c.block_table("b"))
        assert c.available_in(0) == 2 and c.available_in(1) == 1
        with pytest.raises(BlockPoolExhausted):
            c.ensure_many([("b", 20)])            # group 1 is full
        c.ensure_many([("a", 16)])                # group 0 still has room
        assert [c.local_block(b) for b in c.block_table("b")] \
            == [None] * 3
        assert c.local_block(c.block_table("a")[0]) \
            == c.block_table("a")[0]

    def test_prefix_match_stays_in_group(self):
        c = self._pool()
        ids = np.arange(1, 10, dtype=np.int64)
        c.ensure_many([("a", 9)])
        c.publish_prefix("a", ids)
        c.set_seq_group("b", 1)
        assert c.attach_prefix("b", ids) == 0     # the chain is group 0's
        assert c.attach_prefix("c", ids) == 8     # group 0 attaches it

    def test_payload_writes_this_ranks_heads(self):
        c = self._pool(group=1)
        pk = np.arange(2 * 4 * 4 * 8, dtype=np.float32).reshape(2, 4, 4, 8)
        c.write_payload_block(7, pk, pk + 1)
        np.testing.assert_array_equal(c.k_blocks[:, 2].numpy(),
                                      pk[:, :, 2:4])
        c.write_payload_block(3, pk, pk)          # group 0's: not held here
        assert not c.v_blocks[:, 3].any()
