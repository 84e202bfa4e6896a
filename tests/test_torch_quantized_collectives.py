"""CPU twins of tests/test_quantized_collectives.py: the port's quantized
TP collectives (`paddle_tpu_torch.serving_dist.collectives`) against the
JAX package's — config validation, the wire quantizers' codes and
bounds, the wire-byte formulas, the seams, and the served parity matrix
with the byte accounting — on the reference's tiny GPT-2 (paddle seed 0)
carried across through the flat-params bridge.

The port's multi-rank cases run in ONE 4-rank gloo world (a module
fixture): the seams on a tp-4 mesh; the tp-2 servers on ranks 0 and 1
while ranks 2 and 3 only build their meshes (group creation is
collective). The reference runs on the 8 virtual devices of
tests/conftest.py. The quantizers are held to the reference's codes
bitwise and its scales within 1 ulp; the served workloads to the same
match floors as the reference test (int8 >= 0.996 of the unsharded
composed engine's tokens, int4-group >= 0.75) and the same byte limits
(<= 0.30x / 0.20x the unquantized wire). The reference's slow-marked
points (tp 4, tp 2 x dp 2, int4-group, the split path, none == plain)
run here as ordinary cases: the port's side is cheap, and each is held
to the reference run the reference test itself compares with.

Left out: TestMigrationWireCompression (test_quantized_collectives.py:
516-590), which needs `fleet.migration`, the serving fleet of ROADMAP
§A 12, not yet ported.
"""
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
COMPOSED = dict(enable_prefix_cache=True, speculation=True,
                kv_dtype="int8", quantization="w8a16",
                unified_round=True, async_rounds=True)
SPLIT = dict(enable_prefix_cache=True, speculation=True)


def _prompts(vocab):
    rng = np.random.RandomState(3)
    motif = np.array([7, 11, 13, 5], np.int32)
    return [np.tile(motif, 5),
            rng.randint(1, vocab, (17,)).astype(np.int32),
            np.tile(motif[::-1], 4),
            rng.randint(1, vocab, (9,)).astype(np.int32)]


def _pair(vocab):
    rs = np.random.RandomState(2)
    return (rs.randint(1, vocab, (1, 7)).astype(np.int32)[0],
            rs.randint(1, vocab, (1, 4)).astype(np.int32)[0])


def _match(outs, ref):
    toks = [(a, b) for o, r in zip(outs, ref) for a, b in zip(o, r)]
    return sum(a == b for a, b in toks) / len(toks)


def _seam_data():
    rng = np.random.RandomState(5)
    lg = rng.randn(6, 64).astype(np.float32)
    lg[0, 3] = lg[0, 40] = 9.0     # cross-rank exact tie
    lg[1, 63] = 11.0
    lg[2, 16] = lg[2, 17] = 8.0    # same-rank tie
    g = np.random.RandomState(6).randn(4, 128).astype(np.float32) * 5.0
    rs = np.random.RandomState(7)
    x = rs.randn(5, 64).astype(np.float32)
    w = rs.randn(64, 32).astype(np.float32) * 0.2
    return lg, g, x, w


# (name, tp, dp, collective_quant, server kwargs)
CASES = [
    ("tp2", 2, 1, "int8", COMPOSED),
    ("tp4", 4, 1, "int8", COMPOSED),
    ("dp22", 2, 2, "int8", COMPOSED),
    ("int4g", 2, 1, "int4g", COMPOSED),
    ("split", 2, 1, "int8", SPLIT),
    ("plain", 2, 1, None, {}),
]


# ---- the port's world -------------------------------------------------------

def _serve_rank(rank, model, prompts, sharding, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.sampling import SamplingParams

    if rank >= sharding.total:
        sharding.build_mesh()
        return None
    args = dict(SERVER)
    args.update(kw)
    srv = PagedGenerationServer(model, device="cpu", sharding=sharding,
                                **args)
    if rank:
        return srv.serve_follower()
    srv.start()
    try:
        outs = [f.result(timeout=120).tolist() for f in
                [srv.submit(p, sampling=None if s is None
                            else SamplingParams(**s))
                 for p, s in zip(prompts, SPS)]]
        st = srv.stats()
    finally:
        srv.stop()
    return {"outs": outs, "st": st, "digest": srv._dist.digest()}


def _seams(rank):
    """The tp-4 seams on this rank's slices of the reference test's
    inputs (all ranks return the replicated results)."""
    from paddle_tpu_torch.serving_dist import (ShardedEngineConfig,
                                               build_collective_quant)

    cfg = ShardedEngineConfig(tp=4, collective_quant="int8")
    cq = build_collective_quant(cfg, cfg.build_mesh())
    lg, g, x, w = (torch.from_numpy(a) for a in _seam_data())
    m = cq.mesh.axis_index("mp")
    return {"greedy": cq.greedy_tokens(lg[:, m * 16:(m + 1) * 16]),
            "gather": cq.gather_logits(g[:, m * 32:(m + 1) * 32]),
            "psum": cq.matmul_psum(x[:, m * 16:(m + 1) * 16],
                                   w[m * 16:(m + 1) * 16])}


def _prefill_logits(rank, model):
    """tp 2, collective_quant None: the sharded decoder's prefill logits,
    twice (ranks 0 and 1; 2 and 3 build the mesh only)."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.sampling.buffers import greedy_args
    from paddle_tpu_torch.serving_dist import ShardedEngineConfig

    cfg = ShardedEngineConfig(tp=2)
    if rank >= 2:
        cfg.build_mesh()
        return None
    srv = PagedGenerationServer(model, max_slots=2, block_size=8,
                                num_blocks=8, max_prompt_len=16,
                                max_new_tokens=4, device="cpu",
                                sharding=cfg)
    rt = srv._dist
    ids = np.random.RandomState(5).randint(
        1, model.cfg.vocab_size, (2, 12)).astype(np.int32)
    lens = np.array([12, 9], np.int32)
    dec = PagedDecoder(rt.decoder.spec, 8, return_logits=True,
                       shard=rt.shard)
    srv.cache.ensure_many([(0, 12), (1, 9)])
    tables = torch.from_numpy(srv.cache.table_array([0, 1], 2))
    outs = [dec.prefill(rt.params, torch.from_numpy(ids),
                        torch.from_numpy(lens), tables, srv.cache.k_blocks,
                        srv.cache.v_blocks, greedy_args(2, "cpu"))[-1]
            for _ in range(2)]
    if rank:
        srv.serve_follower()
    else:
        srv.stop()
    return outs


def _preempt_rank(rank, model):
    from paddle_tpu_torch.frontend import FrontDoor
    from paddle_tpu_torch.serving_dist import ShardedEngineConfig

    from torch_twin_util import hold_at

    sh = ShardedEngineConfig(tp=2, collective_quant="int8")
    if rank >= 2:
        sh.build_mesh()
        return None
    pv, pi = _pair(model.cfg.vocab_size)
    fd = FrontDoor(model, max_slots=1, block_size=4, max_prompt_len=16,
                   max_new_tokens=24, sharding=sh, device="cpu")
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


def _metrics_rank(rank, model):
    """tp 2 int8 with the metrics registry on: the series appear while
    serving, and reset_stats zeroes the window's bytes."""
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.sampling import SamplingParams
    from paddle_tpu_torch.serving_dist import ShardedEngineConfig

    sh = ShardedEngineConfig(tp=2, collective_quant="int8")
    if rank >= 2:
        sh.build_mesh()
        return None
    metrics.enable()
    srv = PagedGenerationServer(model, max_slots=2, block_size=8,
                                max_prompt_len=64, max_new_tokens=4,
                                sharding=sh, device="cpu")
    if rank:
        out = srv.serve_follower()
        metrics.disable()
        return out
    srv.start()
    try:
        for p, s in zip(_prompts(model.cfg.vocab_size), SPS):
            srv.submit(p, sampling=None if s is None
                       else SamplingParams(**s)).result(timeout=120)
        live = srv.stats()["collectives"]
        text = metrics.to_prometheus()
        srv.reset_stats()
        after = srv.stats()["collectives"]
    finally:
        srv.stop()
        metrics.disable()
    return {"live": live, "text": text, "after": after}


def _world(rank, flat):
    from paddle_tpu_torch.models.gpt2 import GPT2Config, from_reference_params
    from paddle_tpu_torch.serving_dist import ShardedEngineConfig

    cfg = GPT2Config.tiny()
    cfg.dropout = 0.0
    model = from_reference_params(cfg, flat, device="cpu")
    prompts = _prompts(cfg.vocab_size)
    out = {"seams": _seams(rank)}
    for name, tp, dp, cq, kw in CASES:
        out[name] = _serve_rank(rank, model, prompts,
                                ShardedEngineConfig(tp=tp, dp=dp,
                                                    collective_quant=cq),
                                **kw)
    out["none"] = _serve_rank(rank, model, prompts,
                              ShardedEngineConfig(tp=2,
                                                  collective_quant=None))
    out["logits"] = _prefill_logits(rank, model)
    out["preempt"] = _preempt_rank(rank, model)
    out["metrics"] = _metrics_rank(rank, model)
    return out


@pytest.fixture(scope="module")
def tiny():
    model, cfg, port, tcfg = reference_tiny_model(0)
    params, _ = model.functional_state()
    return model, cfg, port, {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def world(tiny, tmp_path_factory):
    return run_world(_world, N, tmp_path_factory.mktemp("qcoll"), tiny[3])


def _ref_serve(model, prompts, **kw):
    from paddle_tpu.inference import PagedGenerationServer
    from paddle_tpu.sampling import SamplingParams

    args = dict(SERVER)
    args.update(kw)
    srv = PagedGenerationServer(model, **args).start()
    try:
        return [f.result(timeout=600).tolist() for f in
                [srv.submit(p, sampling=None if s is None
                            else SamplingParams(**s))
                 for p, s in zip(prompts, SPS)]]
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def composed_ref(tiny):
    return _ref_serve(tiny[0], _prompts(tiny[1].vocab_size), **COMPOSED)


# ---- TestConfigValidation ---------------------------------------------------

class TestConfigValidation:
    def test_unknown_mode_named(self):
        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        with pytest.raises(ValueError, match="collective_quant='int7'"):
            ShardedEngineConfig(tp=2, collective_quant="int7")

    def test_int4_group_named(self):
        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        with pytest.raises(ValueError, match="int4_group=0"):
            ShardedEngineConfig(tp=2, collective_quant="int4g",
                                int4_group=0)

    def test_collective_quant_bundle_validates(self):
        from paddle_tpu_torch.parallel.mesh import make_mesh
        from paddle_tpu_torch.serving_dist import CollectiveQuant

        mesh = make_mesh(1, 1, 1, 1)
        with pytest.raises(ValueError, match="mode='fp8'"):
            CollectiveQuant(mode="fp8", tp=2, mesh=mesh)
        with pytest.raises(ValueError, match="tp=1"):
            CollectiveQuant(mode="int8", tp=1, mesh=mesh)

    def test_tp1_normalizes_to_none(self):
        from paddle_tpu_torch.serving_dist import (ShardedEngineConfig,
                                                   build_collective_quant)

        cfg = ShardedEngineConfig(tp=1, collective_quant="int8")
        assert build_collective_quant(cfg, cfg.build_mesh()) is None
        assert build_collective_quant(ShardedEngineConfig(tp=2),
                                      None) is None

    def test_stats_block_carries_mode(self):
        from paddle_tpu.serving_dist import ShardedEngineConfig as RefCfg

        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        for cq in ("int8", None):
            assert ShardedEngineConfig(tp=2, collective_quant=cq) \
                .stats_block() == RefCfg(tp=2, collective_quant=cq) \
                .stats_block()

    def test_decoder_requires_shardings(self):
        """The quantized wire exists only inside a rank's shard context:
        the port's decoder takes no `collective_quant` of its own."""
        from paddle_tpu_torch.nn.decode import PagedDecoder

        with pytest.raises(TypeError, match="collective_quant"):
            PagedDecoder((2, 4, 32, 128, 1e-5, True), 8,
                         collective_quant="int8")


# ---- TestRoundTripBounds ----------------------------------------------------

class TestRoundTripBounds:
    """The port's quantizers against the reference's on the same inputs:
    codes bitwise, scales within 1 ulp, and the reference's bounds."""

    def test_int8_per_chunk_bound(self):
        from paddle_tpu.serving_dist import collectives as ref

        from paddle_tpu_torch.serving_dist import collectives as coll

        x = np.random.RandomState(0).randn(5, 64).astype(np.float32) * 3.0
        codes, sc = coll.encode_int8(torch.from_numpy(x))
        rc, rs = ref.encode_int8(x)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(rc))
        np.testing.assert_allclose(sc.numpy(), np.asarray(rs), rtol=1e-7)
        deq = coll.decode_int8(codes, sc).numpy()
        amax = np.abs(x).max(axis=-1, keepdims=True)
        assert (np.abs(deq - x) <= amax / 254.0 + 1e-9).all()

    def test_int4_group_bound(self):
        from paddle_tpu.serving_dist import collectives as ref

        from paddle_tpu_torch.serving_dist import collectives as coll

        x = np.random.RandomState(1).randn(7, 96).astype(np.float32) * 2.0
        codes, sc = coll.encode_int4(torch.from_numpy(x), 32)
        assert tuple(codes.shape) == (7, 48)
        rc, rs = ref.encode_int4(x, 32)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(rc))
        np.testing.assert_allclose(sc.numpy(), np.asarray(rs), rtol=1e-7)
        deq = coll.decode_int4(codes, sc, 32, 96).numpy()
        g = coll.group_size(96, 32)
        xg = x.reshape(7, 96 // g, g)
        amax = np.abs(xg).max(axis=-1, keepdims=True)
        assert (np.abs(deq.reshape(xg.shape) - xg) <= amax / 14.0
                + 1e-9).all()

    def test_int4_group_snaps_to_divisor(self):
        from paddle_tpu_torch.serving_dist import collectives as coll

        assert coll.group_size(48, 32) == 16
        assert coll.group_size(192, 32) == 32
        x = torch.from_numpy(np.random.RandomState(2).randn(3, 48)
                             .astype(np.float32))
        codes, sc = coll.encode_int4(x, 32)
        assert tuple(sc.shape) == (3, 3)
        assert tuple(coll.decode_int4(codes, sc, 32, 48).shape) == (3, 48)

    def test_zero_vector_roundtrip_exact(self):
        from paddle_tpu_torch.serving_dist import collectives as coll

        codes, sc = coll.encode_int8(torch.zeros(2, 16))
        assert (coll.decode_int8(codes, sc) == 0).all()


# ---- TestWireByteFormulas ---------------------------------------------------

class TestWireByteFormulas:
    """The port's formulas equal the reference's over a grid, and its
    ratios hold."""

    def test_psum_ratios(self):
        from paddle_tpu.serving_dist import collectives as ref

        from paddle_tpu_torch.serving_dist import collectives as coll

        for rows, width, tp, mode, it in [(64, 256, 4, "int8", 2),
                                          (64, 256, 4, "int4g", 2),
                                          (64, 256, 4, None, 2),
                                          (64, 256, 1, "int8", 2),
                                          (7, 768, 2, "int8", 4),
                                          (3, 96, 2, "int4g", 4)]:
            assert coll.psum_wire_bytes(rows, width, tp, mode, 32, it) \
                == ref.psum_wire_bytes(rows, width, tp, mode, 32, it)
        a8, base = coll.psum_wire_bytes(64, 256, 4, "int8", 32, 2)
        assert base == 2 * 3 * 64 * 256 * 2 // 4 and a8 < 0.56 * base
        assert coll.psum_wire_bytes(64, 256, 4, "int4g", 32, 2)[0] \
            < 0.35 * base

    def test_gather_and_argmax(self):
        from paddle_tpu.serving_dist import collectives as ref

        from paddle_tpu_torch.serving_dist import collectives as coll

        for args in [(8, 1024, 4, "int8", 32), (8, 1024, 4, None, 32),
                     (8, 1023, 4, "int8", 32), (5, 1024, 2, "int4g", 32)]:
            assert coll.gather_wire_bytes(*args) \
                == ref.gather_wire_bytes(*args)
        for args in [(8, 1024, 4), (8, 1023, 4), (3, 50257, 2)]:
            assert coll.argmax_wire_bytes(*args) \
                == ref.argmax_wire_bytes(*args)
        spec = (2, 4, 32, 128, 1e-5, True)
        for mode, fast in ((None, False), ("int8", True), ("int4g", False)):
            kw = dict(spec=spec, vocab=1024, tp=2, mode=mode, group=32,
                      trunk_rows=24, logit_rows=3, greedy_fast=fast,
                      base_itemsize=4)
            assert coll.dispatch_wire_bytes(**kw) \
                == ref.dispatch_wire_bytes(**kw)


# ---- TestSeamUnits ----------------------------------------------------------

class TestSeamUnits:
    """The tp-4 seams against numpy and against the reference's seams on
    its 4-device mesh."""

    def test_greedy_tokens_lossless_with_ties(self, world):
        lg = _seam_data()[0]
        for r in range(N):
            np.testing.assert_array_equal(world[r]["seams"]["greedy"],
                                          lg.argmax(-1).astype(np.int32))

    def test_gather_logits_bound(self, world):
        g = _seam_data()[1]
        shard = g.reshape(4, 4, 32)
        amax = np.abs(shard).max(axis=-1, keepdims=True)
        for r in range(N):
            got = world[r]["seams"]["gather"]
            assert (np.abs(got.reshape(shard.shape) - shard)
                    <= amax / 254.0 + 1e-9).all()
            np.testing.assert_array_equal(got, world[0]["seams"]["gather"])

    def test_matmul_psum_close(self, world):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from paddle_tpu.serving_dist import (ShardedEngineConfig,
                                             build_collective_quant)

        _lg, _g, x, w = _seam_data()
        cfg = ShardedEngineConfig(tp=4, collective_quant="int8")
        cq = build_collective_quant(cfg, cfg.build_mesh())
        fn = jax.jit(
            cq.matmul_psum,
            in_shardings=(NamedSharding(cq.mesh, P(None, "mp")),
                          NamedSharding(cq.mesh, P("mp", None))),
            out_shardings=NamedSharding(cq.mesh, P()))
        want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w)))
        ref = x @ w
        for r in range(N):
            got = world[r]["seams"]["psum"]
            assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max() \
                + 1e-6
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---- TestMeshParity ---------------------------------------------------------

class TestMeshParity:
    """The acceptance matrix: the full composed stack (prefix cache,
    speculation, W8A16 + int8 KV, the unified async round) under int8 /
    int4-group collectives against the reference's unsharded composed
    engine; every rank's tokens equal rank 0's."""

    @pytest.mark.parametrize("name", ["tp2", "tp4", "dp22"])
    def test_int8_composed_token_parity(self, world, composed_ref, name):
        got = world[0][name]
        assert _match(got["outs"], composed_ref) >= 0.996
        n = {"tp2": 2, "tp4": 4, "dp22": 4}[name]
        assert all(world[r][name]["digest"] == got["digest"]
                   for r in range(1, n))
        c = got["st"]["collectives"]
        assert c["enabled"] and c["mode"] == "int8"
        assert 0 < c["bytes_total"] <= 0.30 * c["bytes_baseline"], c
        assert got["st"]["rounds"]["dispatches_per_round"] == 1.0
        assert got["st"]["sharding"]["collective_quant"] == "int8"

    def test_int4_group_tolerance(self, world, composed_ref):
        got = world[0]["int4g"]
        assert _match(got["outs"], composed_ref) >= 0.75
        c = got["st"]["collectives"]
        assert c["mode"] == "int4g"
        assert c["bytes_total"] <= 0.20 * c["bytes_baseline"], c

    def test_split_path_parity_int8(self, tiny, world):
        ref = _ref_serve(tiny[0], _prompts(tiny[1].vocab_size), **SPLIT)
        got = world[0]["split"]
        assert _match(got["outs"], ref) >= 0.996
        assert got["st"]["collectives"]["bytes_total"] > 0

    def test_frontdoor_preempt_resume(self, tiny, world):
        model, cfg = tiny[0], tiny[1]
        pv, pi = _pair(cfg.vocab_size)
        got = world[0]["preempt"]
        assert got["fd"]["preemptions"] >= 1
        assert world[1]["preempt"]["digest"] == got["digest"]
        np.testing.assert_array_equal(
            got["v"], model.generate(pv[None], 24).numpy()[0])
        np.testing.assert_array_equal(
            got["i"], model.generate(pi[None], 3).numpy()[0])


# ---- TestDisabledPathIdentity -----------------------------------------------

class TestDisabledPathIdentity:
    def test_none_is_bitwise_plain_sharded(self, tiny, world):
        """collective_quant=None: the tp-2 decoder's prefill logits are
        bitwise equal over two runs and on both ranks, and within 1e-5 of
        the reference's tp-2 decoder's."""
        import jax.numpy as jnp

        from paddle_tpu.inference.kv_cache import PagedKVCache
        from paddle_tpu.nn.decode import PagedDecoder
        from paddle_tpu.sampling.buffers import greedy_args
        from paddle_tpu.serving_dist import ShardedEngineConfig
        from paddle_tpu.serving_dist.plan import (build_decode_shardings,
                                                  place_decode_params,
                                                  place_kv_pool)

        a, b = world[0]["logits"]
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, world[1]["logits"][0])
        model, cfg = tiny[0], tiny[1]
        params, _ = model.functional_state()
        spec = (cfg.num_layers, cfg.num_heads,
                cfg.hidden_size // cfg.num_heads, cfg.hidden_size,
                cfg.layer_norm_epsilon, cfg.tie_embeddings)
        ids = np.random.RandomState(5).randint(
            1, cfg.vocab_size, (2, 12)).astype(np.int32)
        lens = np.array([12, 9], np.int32)
        mesh = ShardedEngineConfig(tp=2).build_mesh()
        p = place_decode_params(mesh, params)
        cache = PagedKVCache(cfg.num_layers, cfg.num_heads,
                             cfg.hidden_size // cfg.num_heads, block_size=8,
                             num_blocks=8, dtype=jnp.float32)
        place_kv_pool(mesh, cache)
        dec = PagedDecoder(spec, 8, return_logits=True,
                           shardings=build_decode_shardings(mesh, p, None))
        cache.ensure_many([(0, 12), (1, 9)])
        out = dec.prefill(p, jnp.asarray(ids), jnp.asarray(lens),
                          jnp.asarray(cache.table_array([0, 1], 2)),
                          cache.k_blocks, cache.v_blocks, greedy_args(2))
        np.testing.assert_allclose(a, np.asarray(out[-1]), rtol=0,
                                   atol=1e-5)

    def test_serve_none_equals_plain(self, world):
        plain, none = world[0]["plain"], world[0]["none"]
        assert none["outs"] == plain["outs"]
        c = none["st"]["collectives"]
        assert c["enabled"] is False
        assert c["bytes_total"] == c["bytes_baseline"] > 0


# ---- TestStatsAndMetrics ----------------------------------------------------

class TestStatsAndMetrics:
    def test_block_zeroed_when_unsharded(self, tiny):
        from paddle_tpu_torch.inference import PagedGenerationServer

        srv = PagedGenerationServer(tiny[2], max_slots=1, max_prompt_len=16,
                                    max_new_tokens=4, device="cpu")
        assert srv.stats()["collectives"] == {
            "enabled": False, "mode": "none", "tp": 1, "bytes_total": 0,
            "bytes_baseline": 0, "by_collective": {}}

    def test_reset_coherent_and_metric_series(self, world):
        got = world[0]["metrics"]
        assert got["live"]["bytes_total"] > 0
        assert 'serving_collective_bytes_total{collective="row_psum",' \
               'dtype="int8"}' in got["text"]
        assert 'dtype="baseline"' in got["text"]
        after = got["after"]
        assert after["bytes_total"] == after["bytes_baseline"] == 0
        assert after["enabled"] is True
