"""Offline generation on the port, held to the JAX reference on the CPU
with the same weights (`GPT2Config.tiny()`, float32, through the weight
bridge): the twins of `tests/test_gpt2_generate.py`'s 13 tests, of
`tests/test_paged_kv.py::TestPagedDenseParity`'s uniform-batch and
mixed-length tests, and of `tests/test_sampling.py`'s
`test_offline_generate_penalties` and
`test_offline_paged_matches_dense_greedy`.

Each runs `paddle_tpu_torch`'s `GPT2.generate` against the reference's
on the same inputs: greedy, left-padded, W8A16 and int8-KV tokens
identical; sampled tokens identical on these seeds, whose draws lie away
from near ties (the PRNG keys and uniforms are bitwise the reference's,
its Gumbel noise within 4 ulp, ROADMAP §C 11: a draw whose top-two
margin is below that could flip). The PRNG checks themselves:
`prng.split` keys and one-key [B, V] bits and uniforms bitwise equal to
`jax.random`'s, the Gumbel noise within 4 ulp, `prng.categorical` equal
to `jax.random.categorical`. And the paged engine's padded prefill
(`PagedDecoder.prefill`) against the reference's, logits within 1e-4.

The program cache twin clears the port's cache first, so its count
does not depend on which tests ran before it in the worker."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_twin_util import reference_tiny_model, t

torch.set_num_threads(1)

GUMBEL_ULPS = 4


@pytest.fixture(scope="module")
def tiny():
    # tests/test_sampling.py's tiny_model weights: paddle.seed(11)
    return reference_tiny_model(11)


def _untied(seed):
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt2 import GPT2, GPT2Config

    from paddle_tpu_torch.models.gpt2 import GPT2Config as TConfig
    from paddle_tpu_torch.models.gpt2 import from_reference_params

    paddle.seed(seed)
    cfg = GPT2Config.tiny()
    cfg.dropout, cfg.tie_embeddings = 0.0, False
    model = GPT2(cfg)
    model.eval()
    params, _ = model.functional_state()
    tcfg = TConfig.tiny()
    tcfg.dropout, tcfg.tie_embeddings = 0.0, False
    port = from_reference_params(
        tcfg, {k: np.asarray(v) for k, v in params.items()}, device="cpu")
    return model, cfg, port, tcfg


def _both(tiny, ids, n, **kw):
    """(reference tokens, port tokens) as numpy int32."""
    model, _cfg, port, _tcfg = tiny
    ref = np.asarray(model.generate(ids, n, **kw).numpy()).astype(np.int32)
    out = port.generate(ids, n, **kw)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    return ref, out.numpy()


def _naive_greedy(port, ids, n):
    """Full recompute of the port's forward each step (no cache)."""
    out = torch.from_numpy(np.asarray(ids, np.int64))
    with torch.no_grad():
        for _ in range(n):
            nxt = port(out)[:, -1].argmax(-1)
            out = torch.cat([out, nxt[:, None]], dim=1)
    return out.numpy().astype(np.int32)


# ---- the PRNG of the dense program ------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2**31, 2**32 - 1])
def test_split_keys_and_one_key_draws_match_jax(seed):
    from paddle_tpu_torch.sampling import prng

    key = jax.random.key(np.uint32(seed))
    tkey = prng.seed_key(seed)
    assert tkey.tolist() == np.asarray(jax.random.key_data(key)).tolist()
    for _ in range(3):  # a chain of splits, as the program's steps
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
        for j, tk in ((key, tkey), (sub, tsub)):
            np.testing.assert_array_equal(
                tk.numpy(), np.asarray(jax.random.key_data(j)))
    B, V = 3, 1000
    np.testing.assert_array_equal(
        prng.random_bits(tsub.reshape(1, 2), B * V).reshape(B, V).numpy(),
        np.asarray(jax.random.bits(sub, (B, V), jnp.uint32)).astype(
            np.int64))
    tiny = np.finfo(np.float32).tiny
    u = prng.uniform(tsub.reshape(1, 2), B * V).reshape(B, V).numpy()
    np.testing.assert_array_equal(
        u, np.asarray(jax.random.uniform(sub, (B, V), jnp.float32,
                                         minval=tiny, maxval=1.0)))
    g = prng.gumbel(tsub.reshape(1, 2), B * V).reshape(B, V).numpy()
    ref = np.asarray(jax.random.gumbel(sub, (B, V), jnp.float32))
    ulp = np.spacing(np.maximum(np.abs(ref), 1.0).astype(np.float32))
    assert (np.abs(g - ref) / ulp).max() <= GUMBEL_ULPS
    logits = np.random.RandomState(seed % 97).randn(B, V).astype(
        np.float32) * 3
    np.testing.assert_array_equal(
        prng.categorical(tsub, torch.from_numpy(logits)).numpy(),
        np.asarray(jax.random.categorical(sub, logits)))


def test_categorical_is_jax_default_low_mode():
    """`jax.random.categorical` draws in the "low" Gumbel mode unless
    `jax_high_dynamic_range_gumbel` is set: the mode the port copies."""
    assert not jax.config.jax_high_dynamic_range_gumbel


# ---- twins of tests/test_gpt2_generate.py -----------------------------------

def test_greedy_matches_naive_loop(tiny):
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 1024, (2, 7)).astype(np.int64)
    ref, out = _both(tiny, ids, 6)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _naive_greedy(tiny[2], ids, 6))


def test_single_token_and_eos(tiny):
    ids = np.array([[5, 9, 2]], np.int64)
    ref, one = _both(tiny, ids, 1)
    assert one.shape == (1, 4)
    np.testing.assert_array_equal(one, ref)
    np.testing.assert_array_equal(one, _naive_greedy(tiny[2], ids, 1))
    # force the first generated token to be "eos": the rest must be eos
    eos = int(one[0, -1])
    ref, full = _both(tiny, ids, 5, eos_token_id=eos)
    np.testing.assert_array_equal(full, ref)
    assert (full[0, 3:] == eos).all()


def test_untied_head_and_bounds():
    tiny = _untied(3)
    ids = np.array([[3, 1, 4]], np.int64)
    ref, out = _both(tiny, ids, 4)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _naive_greedy(tiny[2], ids, 4))
    port = tiny[2]
    # max_new_tokens=0 returns the prompt unchanged
    np.testing.assert_array_equal(port.generate(ids, 0).numpy(), ids)
    # exceeding the positional table raises instead of clamping
    long_ids = np.zeros((1, tiny[3].max_position - 2), np.int64)
    with pytest.raises(ValueError, match="max_position"):
        port.generate(long_ids, 5)


def test_sampling_is_reproducible_and_plausible(tiny):
    ids = np.array([[1, 2, 3, 4]], np.int64)
    ref, a = _both(tiny, ids, 8, temperature=0.8, seed=7)
    b = tiny[2].generate(ids, 8, temperature=0.8, seed=7).numpy()
    np.testing.assert_array_equal(a, b)  # same seed -> same sample
    np.testing.assert_array_equal(a, ref)
    assert a.shape == (1, 12)
    assert (a[:, :4] == ids).all()


def test_left_padded_batch_matches_per_row(tiny):
    port = tiny[2]
    pad = 0
    p1 = np.array([5, 9, 2, 7], np.int64)
    p2 = np.array([11, 3], np.int64)
    batch = np.stack([p1, np.concatenate([[pad, pad], p2])])
    ref, out = _both(tiny, batch, 5, pad_token_id=pad)
    np.testing.assert_array_equal(out, ref)
    r1 = port.generate(p1[None], 5).numpy()[0]
    r2 = port.generate(p2[None], 5).numpy()[0]
    np.testing.assert_array_equal(out[0, 4:], r1[4:])
    np.testing.assert_array_equal(out[1, 4:], r2[2:])
    # right padding is rejected loudly
    bad = np.stack([p1, np.concatenate([p2, [pad, pad]])])
    with pytest.raises(ValueError, match="LEFT-padded"):
        port.generate(bad, 3, pad_token_id=pad)
    with pytest.raises(ValueError, match="entirely padding"):
        port.generate(np.zeros((1, 4), np.int64), 3, pad_token_id=pad)


def test_top_k_top_p_filtering(tiny):
    port = tiny[2]
    ids = np.array([[2, 4, 6]], np.int64)
    greedy = port.generate(ids, 5).numpy()
    # top_k=1 sampling degenerates to greedy whatever the temperature
    k1 = port.generate(ids, 5, temperature=1.5, top_k=1, seed=3).numpy()
    np.testing.assert_array_equal(k1, greedy)
    # a tiny top_p likewise keeps only the argmax token
    p_small = port.generate(ids, 5, temperature=1.5, top_p=1e-6,
                            seed=4).numpy()
    np.testing.assert_array_equal(p_small, greedy)
    # permissive settings: the reference's tokens
    ref, free = _both(tiny, ids, 5, temperature=1.0, top_k=50, top_p=0.9,
                      seed=5)
    assert free.shape == (1, 8)
    assert (free >= 0).all() and (free < 1024).all()
    np.testing.assert_array_equal(free, ref)


def test_no_recompile_across_seed_temp_eos(tiny):
    """seed, temperature and eos are program inputs: one program serves
    all three calls (its own greedy and sampled variants inside). The
    cache is cleared first, so no earlier test's program counts."""
    from paddle_tpu_torch.models import gpt2_decode

    port = tiny[2]
    ids = np.array([[1, 2, 3]], np.int64)
    gpt2_decode._generate_impl.cache_clear()
    port.generate(ids, 4, temperature=0.7, seed=1)
    port.generate(ids, 4, temperature=1.3, seed=2, eos_token_id=5)
    port.generate(ids, 4, temperature=0.0, seed=3)
    assert gpt2_decode._generate_impl.cache_info().misses == 1


class TestWeightOnlyInt8Decode:
    def test_w8a16_matches_bf16_greedy(self, tiny):
        ids = np.random.RandomState(3).randint(5, 200, (2, 10)).astype(
            np.int32)
        a = tiny[2].generate(ids, 12).numpy()
        ref, b = _both(tiny, ids, 12, weight_quant="int8")
        np.testing.assert_array_equal(b, ref)
        # per-channel int8 weights: greedy paths agree on the tiny config
        assert (a == b).mean() > 0.9
        assert (b[:, :10] == ids).all()

    def test_quantize_weights_public_packing(self, tiny):
        """`quantize_weights()` packs every big 2-D decode weight, keeps
        no cache (an in-place edit shows at the next call, and in the
        next W8A16 generate too) and round-trips within the per-channel
        int8 bound."""
        from paddle_tpu_torch.models.gpt2 import from_reference_params

        port = from_reference_params(
            tiny[3], {k: v.numpy() for k, v in tiny[2].flat_params().items()},
            device="cpu")
        packed = port.quantize_weights()
        assert not hasattr(port, "_w8_cache")
        for name in ("wte.weight", "h.0.qkv_proj.weight", "h.1.fc2.weight"):
            assert name not in packed
            codes = packed[name + "::w8c"]
            assert codes.dtype == torch.int8
            assert codes.abs().max() <= 127
        w = port.flat_params()["h.0.fc1.weight"]
        codes = packed["h.0.fc1.weight::w8c"].float()
        scales = packed["h.0.fc1.weight::w8s"].float()
        assert (codes * scales[None, :] - w).abs().max() <= \
            scales.max() * 0.51
        ids = np.array([[7, 8, 9]], np.int64)
        before = port.generate(ids, 4, weight_quant="int8").numpy()
        with torch.no_grad():  # an in-place edit, as the reference's
            port.wte.weight.mul_(-1.0)
        packed2 = port.quantize_weights()
        assert not torch.equal(packed2["wte.weight::w8c"],
                               packed["wte.weight::w8c"])
        after = port.generate(ids, 4, weight_quant="int8").numpy()
        # a model built from the edited weights packs them afresh
        fresh = from_reference_params(
            tiny[3], {k: v.numpy() for k, v in port.flat_params().items()},
            device="cpu").generate(ids, 4, weight_quant="int8").numpy()
        np.testing.assert_array_equal(after, fresh)
        assert not np.array_equal(after, before)

    def test_unknown_weight_quant_raises(self, tiny):
        with pytest.raises(ValueError, match="int8"):
            tiny[2].generate(np.zeros((1, 8), np.int32), 2,
                             weight_quant="int4")


class TestInt8KVCache:
    def test_kv8_greedy_parity(self, tiny):
        ids = np.random.RandomState(5).randint(5, 200, (2, 12)).astype(
            np.int32)
        a = tiny[2].generate(ids, 16).numpy()
        ref, b = _both(tiny, ids, 16, kv_quant="int8")
        np.testing.assert_array_equal(b, ref)
        assert (a == b).mean() > 0.9
        # stacks with weight-only int8
        ref, c = _both(tiny, ids, 16, kv_quant="int8", weight_quant="int8")
        np.testing.assert_array_equal(c, ref)
        assert (c[:, :12] == ids).all()

    def test_kv8_left_padded(self, tiny):
        p = np.array([[0, 0, 7, 9], [3, 5, 7, 9]], np.int32)
        ref, o = _both(tiny, p, 6, kv_quant="int8", pad_token_id=0)
        assert o.shape == (2, 10) and (o[:, :4] == p).all()
        np.testing.assert_array_equal(o, ref)

    def test_unknown_kv_quant_raises(self, tiny):
        for cache in ("dense", "paged"):
            with pytest.raises(ValueError, match="int8"):
                tiny[2].generate(np.zeros((1, 8), np.int32), 2,
                                 kv_quant="fp4", kv_cache=cache)


# ---- the paged path ---------------------------------------------------------

def test_uniform_batch_greedy_matches_dense(tiny):
    rs = np.random.RandomState(0)
    ids = rs.randint(1, 1024, (3, 9)).astype(np.int32)
    dense = tiny[2].generate(ids, 6).numpy()
    ref, paged = _both(tiny, ids, 6, kv_cache="paged", block_size=4)
    np.testing.assert_array_equal(paged, ref)
    np.testing.assert_array_equal(dense, paged)


def test_mixed_length_matches_dense_leftpad(tiny):
    """Dense decodes LEFT-padded rows (value masking); paged decodes
    RIGHT-padded rows with explicit lengths: the generated suffixes
    agree, and each side equals the reference's."""
    rs = np.random.RandomState(1)
    s0, new = 8, 5
    lens = np.array([3, 8, 5], np.int32)
    rows = [rs.randint(1, 1024, (n,)).astype(np.int32) for n in lens]
    left = np.zeros((3, s0), np.int32)
    right = np.zeros((3, s0), np.int32)
    for i, r in enumerate(rows):
        left[i, s0 - lens[i]:] = r
        right[i, :lens[i]] = r
    ref_d, dense = _both(tiny, left, new, pad_token_id=0)
    ref_p, paged = _both(tiny, right, new, kv_cache="paged",
                         prompt_lens=lens, block_size=4, pad_token_id=0)
    np.testing.assert_array_equal(dense, ref_d)
    np.testing.assert_array_equal(paged, ref_p)
    for i in range(3):
        np.testing.assert_array_equal(
            dense[i, s0:], paged[i, lens[i]:lens[i] + new],
            err_msg=f"row {i} (len {lens[i]})")
    with pytest.raises(ValueError, match="prompt_lens"):
        tiny[2].generate(left, new, prompt_lens=lens)


@pytest.mark.parametrize("kw", [
    dict(kv_quant="int8"), dict(weight_quant="int8"),
    dict(temperature=0.9, top_k=40, top_p=0.95, seed=3, eos_token_id=17)],
    ids=["kv8", "w8a16", "sampled"])
def test_paged_generate_matches_reference(tiny, kw):
    ids = np.random.RandomState(2).randint(1, 1024, (3, 9)).astype(np.int32)
    ref, out = _both(tiny, ids, 6, kv_cache="paged", block_size=4, **kw)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
def test_paged_prefill_matches_reference(tiny, kv_dtype):
    """`PagedDecoder.prefill` on right-padded rows against the
    reference's: float32 logits within 1e-4, the same first tokens, and
    the pools equal to the reference's at every written position."""
    from paddle_tpu.inference.kv_cache import PagedKVCache as JCache
    from paddle_tpu.nn.decode import PagedDecoder as JDecoder
    from paddle_tpu.sampling import greedy_args as j_greedy

    from paddle_tpu_torch.inference.kv_cache import PagedKVCache
    from paddle_tpu_torch.nn.decode import PagedDecoder
    from paddle_tpu_torch.sampling import greedy_args

    model, cfg, port, tcfg = tiny
    s0, bs, m = 7, 4, 3
    lens = np.array([4, 7], np.int32)
    ids = np.zeros((2, s0), np.int32)
    rs = np.random.RandomState(2)
    for i, n in enumerate(lens):
        ids[i, :n] = rs.randint(1, cfg.vocab_size, (n,))
    shape = (cfg.num_layers, cfg.num_heads, cfg.hidden_size // cfg.num_heads)
    jc = JCache(*shape, block_size=bs, num_blocks=2 * m + 1,
                kv_dtype=kv_dtype)
    tc = PagedKVCache(*shape, block_size=bs, num_blocks=2 * m + 1,
                      kv_dtype=kv_dtype, device="cpu")
    for b in range(2):
        jc.allocate(b, int(lens[b]) + 2)
        tc.allocate(b, int(lens[b]) + 2)
    tables = jc.table_array([0, 1], m)
    np.testing.assert_array_equal(tables, tc.table_array([0, 1], m))
    params, _ = model.functional_state()
    jdec = JDecoder.for_config(cfg, bs, return_logits=True,
                               kv_dtype=kv_dtype)
    jt, _js, jk, _jv, _jc, jl = jdec.prefill(
        params, jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(tables),
        jc.k_blocks, jc.v_blocks, j_greedy(2))
    tdec = PagedDecoder.for_config(tcfg, bs, return_logits=True,
                                   kv_dtype=kv_dtype)
    tt, ts, tk, _tv, counts, tl = tdec.prefill(
        port.flat_params(), t(ids), t(lens), t(tables), tc.k_blocks,
        tc.v_blocks, greedy_args(2, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert counts is None and not ts.any()
    for b in range(2):  # every written position (trash excluded)
        for p in range(int(lens[b])):
            blk, off = tables[b, p // bs], p % bs
            if kv_dtype is None:
                np.testing.assert_allclose(
                    tk[:, blk, off].numpy(), np.asarray(jk)[:, blk, off],
                    atol=1e-5)
            else:
                assert (np.abs(tk.codes[:, blk, off].numpy().astype(int)
                               - np.asarray(jk.codes)[:, blk, off]) <= 1).all()


# ---- twins of tests/test_sampling.py ----------------------------------------

def test_offline_generate_penalties(tiny):
    from paddle_tpu.sampling import SamplingParams as JParams

    from paddle_tpu_torch.sampling import SamplingParams

    model, _cfg, port, _tcfg = tiny
    rs = np.random.RandomState(14)
    ids = rs.randint(1, 1024, (1, 5)).astype(np.int32)
    out = port.generate(ids, 6, kv_cache="paged", block_size=4,
                        sampling=SamplingParams(
                            presence_penalty=1e9)).numpy()[0]
    ref = np.asarray(model.generate(ids, 6, kv_cache="paged", block_size=4,
                                    sampling=JParams(
                                        presence_penalty=1e9)).numpy())[0]
    np.testing.assert_array_equal(out, ref)
    gen = out[5:].tolist()
    assert len(set(gen)) == len(gen)
    assert not set(gen) & set(ids[0].tolist())


def test_offline_paged_matches_dense_greedy(tiny):
    from paddle_tpu_torch.sampling import SamplingParams

    port = tiny[2]
    rs = np.random.RandomState(1)
    ids = rs.randint(1, 1024, (2, 9)).astype(np.int32)
    ref = port.generate(ids, 6).numpy()
    out = port.generate(ids, 6, kv_cache="paged", block_size=4).numpy()
    np.testing.assert_array_equal(out, ref)
    # an explicit SamplingParams(temperature=0) takes the same path
    out2 = port.generate(ids, 6, kv_cache="paged", block_size=4,
                         sampling=SamplingParams()).numpy()
    np.testing.assert_array_equal(out2, ref)


def test_dense_sampling_subset_is_validated(tiny):
    """The dense path takes SamplingParams' program-level subset and
    rejects the per-slot fields with the reference's messages."""
    from paddle_tpu_torch.sampling import SamplingParams

    port = tiny[2]
    ids = np.array([[1, 2, 3]], np.int64)
    for kw, field in ((dict(min_p=0.1), "min_p"),
                      (dict(repetition_penalty=1.2), "repetition_penalty"),
                      (dict(stop_token_ids=(1, 2)), "stop token")):
        with pytest.raises(ValueError, match=field):
            port.generate(ids, 2, sampling=SamplingParams(**kw))
    with pytest.raises(TypeError, match="SamplingParams"):
        port.generate(ids, 2, sampling={"temperature": 1.0})
    with pytest.raises(ValueError, match="kv_cache"):
        port.generate(ids, 2, kv_cache="ring")
    a = port.generate(ids, 4, sampling=SamplingParams(
        temperature=0.8, seed=7, stop_token_ids=(5,))).numpy()
    b = port.generate(ids, 4, temperature=0.8, seed=7,
                      eos_token_id=5).numpy()
    np.testing.assert_array_equal(a, b)
