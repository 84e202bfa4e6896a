"""CPU twins of tests/test_sp_prefill.py: sequence-parallel packed
prefill in the port's sharded server (`ShardedEngineConfig(sp=...)`,
`sp_attention` allgather / ring / ulysses) against the JAX package's, on
the reference's tiny GPT-2 (paddle seed 0) carried across through the
flat-params bridge.

The port runs in ONE 4-rank gloo world (a module fixture): a config of
fewer ranks uses the first ones while the rest only build its mesh
(group creation is collective). With sp > 1 each sp rank runs the packed
trunk on T/sp rows: allgather all-gathers K/V before the pool write and
runs K1 on the rank's own rows (the plain version here on the CPU);
ring and ulysses run `serving_dist.sp_attention`. The reference runs on
the 8 virtual devices of tests/conftest.py; tokens are compared exactly
with the reference's sharded server (sp 2, tp 2 x sp 2) and, as the
reference test does, with its unsharded server for every other point,
on the same pinned long-prompt workload (test_sp_prefill.py:48-62).
Every rank's tokens must equal rank 0's (a digest over every dispatch).

The reference's `test_mode_composed_acceptance_workload[ring]` flips
with the host's speed; this twin's tokens do not depend on any wall
clock: requests are submitted together and compared token for token.
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
QKW = dict(enable_prefix_cache=True, speculation=True, kv_dtype="int8",
           quantization="w8a16")


def _prompts(vocab):
    rng = np.random.RandomState(3)
    return [rng.randint(1, vocab, (n,)).astype(np.int32)
            for n in (5, 37, 9, 23)]


def _budget_prompt(vocab):
    return np.random.RandomState(5).randint(1, vocab, (37,)) \
        .astype(np.int32)


def _pair(vocab):
    rs = np.random.RandomState(2)
    return (rs.randint(1, vocab, (1, 7)).astype(np.int32)[0],
            rs.randint(1, vocab, (1, 4)).astype(np.int32)[0])


# (name, ShardedEngineConfig kwargs, server kwargs, the budget prompt?)
CASES = [
    ("sp1", dict(sp=1), {}, False),
    ("sp2", dict(sp=2), {}, False),
    ("sp4", dict(sp=4), {}, False),
    ("tp2sp2", dict(tp=2, sp=2), {}, False),
    ("q_sp2", dict(sp=2), QKW, False),
    ("q_tp2sp2", dict(tp=2, sp=2, collective_quant="int8"), QKW, False),
    ("ring2", dict(sp=2, sp_attention="ring"), {}, False),
    ("ring4", dict(sp=4, sp_attention="ring"), {}, False),
    ("ulysses2", dict(sp=2, sp_attention="ulysses"), {}, False),
    ("ulysses4", dict(sp=4, sp_attention="ulysses"), {}, False),
    ("q_ring", dict(tp=2, sp=2, sp_attention="ring",
                    collective_quant="int8"), QKW, False),
    ("q_ulysses", dict(tp=2, sp=2, sp_attention="ulysses"), QKW, False),
    ("budget1", dict(sp=1), {}, True),
    ("budget4", dict(sp=4), {}, True),
]


# ---- the port's world -------------------------------------------------------

def _serve_rank(rank, model, prompts, sps, sharding, **kw):
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
    sps = sps or [None] * len(prompts)
    srv.start()
    try:
        outs = [f.result(timeout=120).tolist() for f in
                [srv.submit(p, sampling=None if s is None
                            else SamplingParams(**s))
                 for p, s in zip(prompts, sps)]]
        st = srv.stats()
    finally:
        srv.stop()
    return {"outs": outs, "st": st,
            "digest": srv._dist.digest() if srv._dist.multi else None,
            "label": srv._dist.shardings.shard_label}


def _preempt_rank(rank, model):
    from paddle_tpu_torch.frontend import FrontDoor
    from paddle_tpu_torch.serving_dist import ShardedEngineConfig

    from torch_twin_util import hold_at

    sh = ShardedEngineConfig(sp=2)
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


def _world(rank, flat):
    from paddle_tpu_torch.models.gpt2 import GPT2Config, from_reference_params
    from paddle_tpu_torch.serving_dist import ShardedEngineConfig

    cfg = GPT2Config.tiny()
    cfg.dropout = 0.0
    model = from_reference_params(cfg, flat, device="cpu")
    V = cfg.vocab_size
    out = {}
    for name, sh, kw, budget in CASES:
        prompts = [_budget_prompt(V)] if budget else _prompts(V)
        out[name] = _serve_rank(rank, model, prompts,
                                None if budget else SPS,
                                ShardedEngineConfig(**sh), **kw)
    out["preempt"] = _preempt_rank(rank, model)
    return out


@pytest.fixture(scope="module")
def tiny():
    model, cfg, port, tcfg = reference_tiny_model(0)
    params, _ = model.functional_state()
    return model, cfg, port, {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def world(tiny, tmp_path_factory):
    return run_world(_world, N, tmp_path_factory.mktemp("sp"), tiny[3])


def _ref_serve(model, prompts, sps=None, **kw):
    from paddle_tpu.inference import PagedGenerationServer
    from paddle_tpu.sampling import SamplingParams

    args = dict(SERVER)
    args.update(kw)
    srv = PagedGenerationServer(model, **args).start()
    try:
        sps = sps or [None] * len(prompts)
        return [f.result(timeout=600).tolist() for f in
                [srv.submit(p, sampling=None if s is None
                            else SamplingParams(**s))
                 for p, s in zip(prompts, sps)]]
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def ref(tiny):
    """The reference's unsharded server on the pinned workload, plain and
    with the composed features."""
    model, cfg = tiny[0], tiny[1]
    return {"plain": _ref_serve(model, _prompts(cfg.vocab_size), SPS),
            "composed": _ref_serve(model, _prompts(cfg.vocab_size), SPS,
                                   **QKW)}


def _check(world, name, want):
    got = world[0][name]
    assert got["outs"] == want, name
    n = _TOTALS[name]
    assert all(world[r][name]["digest"] == got["digest"]
               for r in range(1, n)), name
    return got


_TOTALS = {name: int(np.prod([sh.get(k, 1) for k in ("tp", "dp",
                                                           "sp")]))
                 for name, sh, _kw, _b in CASES}


# ---- TestConfig -------------------------------------------------------------

class TestConfig:
    def test_sp_validated(self):
        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        with pytest.raises(ValueError, match="sp=0"):
            ShardedEngineConfig(sp=0)
        with pytest.raises(ValueError, match="dp"):
            ShardedEngineConfig(sp=2, dp=2)

    def test_sp_needs_devices(self):
        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        with pytest.raises(ValueError, match="ranks"):
            ShardedEngineConfig(tp=4, sp=64).build_mesh()

    def test_sp_unified_round_rejected(self, tiny):
        from paddle_tpu_torch.inference import PagedGenerationServer
        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        with pytest.raises(ValueError, match="unified"):
            PagedGenerationServer(tiny[2], unified_round=True, device="cpu",
                                  sharding=ShardedEngineConfig(sp=2))

    def test_shard_label_names_sp(self, world):
        """The reference's label (`mp2xdp1xsp2`) and mesh stats."""
        got = world[0]["tp2sp2"]
        st = got["st"]["sharding"]
        assert st["mesh_shape"] == {"dp": 1, "mp": 2, "sp": 2}
        assert st["sp_degree"] == 2
        assert got["label"] == "mp2xdp1xsp2"
        assert world[0]["sp1"]["label"] == "mp1xdp1"


# ---- TestSpParity -----------------------------------------------------------

class TestSpParity:
    def test_sp_token_parity(self, tiny, world, ref):
        """sp in {1, 2, 4}: the reference's unsharded tokens, and its sp-2
        server's, on the pinned long-prompt workload."""
        from paddle_tpu.serving_dist import ShardedEngineConfig as RefCfg

        model, cfg = tiny[0], tiny[1]
        ref2 = _ref_serve(model, _prompts(cfg.vocab_size), SPS,
                          sharding=RefCfg(sp=2))
        assert ref2 == ref["plain"]
        assert world[0]["sp1"]["outs"] == ref["plain"]
        for name in ("sp2", "sp4"):
            got = _check(world, name, ref2)
            assert got["st"]["sharding"]["sp_degree"] == int(name[-1])

    def test_sp_composes_with_tp(self, tiny, world):
        from paddle_tpu.serving_dist import ShardedEngineConfig as RefCfg

        model, cfg = tiny[0], tiny[1]
        want = _ref_serve(model, _prompts(cfg.vocab_size), SPS,
                          sharding=RefCfg(tp=2, sp=2))
        _check(world, "tp2sp2", want)

    def test_sp_composed_acceptance_workload(self, world, ref):
        """Prefix cache, speculation, int8 KV + W8A16 (+ int8 collectives
        at tp 2 x sp 2): the same features unsharded."""
        _check(world, "q_sp2", ref["composed"])
        _check(world, "q_tp2sp2", ref["composed"])

    def test_sp_multiplies_chunk_budget(self, world):
        one, four = world[0]["budget1"], world[0]["budget4"]
        assert one["outs"] == four["outs"]
        assert four["st"]["prefill_dispatches"] \
            < one["st"]["prefill_dispatches"]


# ---- TestSpAttentionModes ---------------------------------------------------

class TestSpAttentionModes:
    def test_knob_validated_eagerly(self):
        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        with pytest.raises(ValueError, match="sp_attention"):
            ShardedEngineConfig(sp=2, sp_attention="flash")

    def test_sp1_normalizes_to_allgather(self):
        from paddle_tpu_torch.serving_dist import ShardedEngineConfig

        for mode in ("ring", "ulysses"):
            assert ShardedEngineConfig(
                sp=1, sp_attention=mode).sp_attention == "allgather"
        assert ShardedEngineConfig(
            sp=2, sp_attention="ring").sp_attention == "ring"

    def test_ulysses_head_divisibility_checked(self):
        from paddle_tpu_torch.serving_dist import (ShardedEngineConfig,
                                                   normalize_sharding)

        with pytest.raises(ValueError, match="ulysses"):
            normalize_sharding(ShardedEngineConfig(
                tp=2, sp=4, sp_attention="ulysses"), 4)
        normalize_sharding(ShardedEngineConfig(
            tp=2, sp=4, sp_attention="ring"), 4)

    @pytest.mark.parametrize("mode", ["ring", "ulysses"])
    def test_mode_token_parity(self, world, ref, mode):
        for sp in (2, 4):
            got = _check(world, f"{mode}{sp}", ref["plain"])
            assert got["st"]["sharding"]["sp_attention"] == mode
            assert got["st"]["sharding"]["sp_attention_bytes_peak"] > 0

    @pytest.mark.parametrize("mode", ["ring", "ulysses"])
    def test_mode_composed_acceptance_workload(self, world, ref, mode):
        _check(world, f"q_{mode}", ref["composed"])


# ---- TestMemoryFlatness -----------------------------------------------------

class TestMemoryFlatness:
    def test_peak_bytes_flat_across_chunk_sweep(self):
        """The port's analytic bytes equal the reference's over the sweep,
        flat for ring/ulysses, linear for allgather."""
        from paddle_tpu.serving_dist import sp_attention_flat_bound as rbound
        from paddle_tpu.serving_dist import sp_attention_peak_bytes as rpeak

        from paddle_tpu_torch.serving_dist import (sp_attention_flat_bound,
                                                   sp_attention_peak_bytes)

        kw = dict(sp=4, tp=1, num_heads=8, head_dim=64)
        sweep = (2048, 8192, 32768)
        for kv_quant in (False, True):
            for mode in ("ring", "ulysses", "allgather"):
                peaks = [sp_attention_peak_bytes(mode, t, kv_quant=kv_quant,
                                                 **kw) for t in sweep]
                assert peaks == [rpeak(mode, t, kv_quant=kv_quant, **kw)
                                 for t in sweep]
                if mode == "allgather":
                    assert peaks[2] == 16 * peaks[0] == 4 * peaks[1]
                    continue
                bound = sp_attention_flat_bound(mode, 1, 8, 64,
                                                kv_quant=kv_quant)
                assert bound == rbound(mode, 1, 8, 64, kv_quant=kv_quant)
                assert max(peaks) <= 1.25 * min(peaks)
                assert all(p <= bound for p in peaks)
        with pytest.raises(ValueError, match="sp_attention"):
            sp_attention_peak_bytes("flash", 2048, **kw)

    def test_engine_asserts_flat_bound_per_dispatch(self, tiny, world):
        from paddle_tpu_torch.serving_dist import sp_attention_flat_bound

        cfg = tiny[1]
        peak = world[0]["ring2"]["st"]["sharding"]["sp_attention_bytes_peak"]
        assert 0 < peak <= sp_attention_flat_bound(
            "ring", 1, cfg.num_heads, cfg.hidden_size // cfg.num_heads)


# ---- TestSpFrontdoor --------------------------------------------------------

class TestSpFrontdoor:
    def test_sp_frontdoor_preempt_resume(self, tiny, world):
        model, cfg = tiny[0], tiny[1]
        pv, pi = _pair(cfg.vocab_size)
        got = world[0]["preempt"]
        assert got["fd"]["preemptions"] >= 1 and got["fd"]["resumes"] >= 1
        assert world[1]["preempt"]["digest"] == got["digest"]
        np.testing.assert_array_equal(
            got["v"], model.generate(pv[None], 24).numpy()[0])
        np.testing.assert_array_equal(
            got["i"], model.generate(pi[None], 3).numpy()[0])
