"""The port's PagedGenerationServer (paddle_tpu_torch/inference/serving.py)
on the CPU — twins of the core of tests/test_serving_paged.py: mixed
lengths, EOS frees and refills, admission reservation, multistep ==
single step, a burst in one packed prefill dispatch, chunked prefill
across dispatches, ITL stats, concurrent clients, stop and validation —
plus greedy output equal, token for token, to the reference
`PagedGenerationServer` on pinned prompts with the same float32 weights.

Where the reference tests compare with the reference's own solo
`generate`, these compare with `dense_greedy` (torch_twin_util): a plain
full-recompute greedy decode of the same weights that shares no code
with the paged engine. Token identity is exact (greedy, float32)."""
import threading

import numpy as np
import pytest
import torch

from torch_twin_util import dense_greedy, reference_tiny_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    model, cfg, port, tcfg = reference_tiny_model(11)
    return model, cfg, port, tcfg, port.flat_params()


def _server(port, **kw):
    from paddle_tpu_torch.inference import PagedGenerationServer

    kw.setdefault("device", "cpu")
    return PagedGenerationServer(port, **kw)


def _prompts(seed, lens, vocab):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, (n,)).astype(np.int32) for n in lens]


def test_smoke_mixed_lengths_match_dense_greedy(tiny):
    _m, _c, port, tcfg, params = tiny
    srv = _server(port, max_slots=2, block_size=4, max_prompt_len=16,
                  max_new_tokens=5).start()
    try:
        prompts = _prompts(1, (3, 7, 5, 9, 16), tcfg.vocab_size)
        outs = [f.result(timeout=120) for f in
                [srv.submit(p) for p in prompts]]
        for p, o in zip(prompts, outs):
            np.testing.assert_array_equal(o, dense_greedy(params, tcfg, p,
                                                          5))
        st = srv.stats()
        assert st["requests"] == 5 and st["new_tokens"] == 25
        assert st["prefills"] == 5
        assert st["slot_fill"] > 0.5       # slots were refilled
        assert st["kv_cache"]["used_blocks"] == 0
        assert st["kv_cache"]["peak_used_blocks"] >= 2
    finally:
        srv.stop()


def test_eos_frees_slot_early_and_refills(tiny):
    _m, _c, port, tcfg, params = tiny
    prompts = _prompts(2, (4, 6), tcfg.vocab_size)
    first = int(dense_greedy(params, tcfg, prompts[0], 1)[-1])
    srv = _server(port, max_slots=1, block_size=4, max_prompt_len=8,
                  max_new_tokens=5, eos_token_id=first).start()
    try:
        out = srv.submit(prompts[0]).result(timeout=120)
        assert out.shape[0] == prompts[0].size + 1 and out[-1] == first
        st = srv.stats()
        assert st["new_tokens"] == 1 and st["stop_reasons"]["eos"] == 1
        out2 = srv.submit(prompts[1]).result(timeout=120)
        assert out2.shape[0] >= prompts[1].size + 1
    finally:
        srv.stop()


def test_request_stop_token_ids_end_generation(tiny):
    from paddle_tpu_torch.sampling import SamplingParams

    _m, _c, port, tcfg, params = tiny
    p = _prompts(3, (6,), tcfg.vocab_size)[0]
    ref = dense_greedy(params, tcfg, p, 4)
    stop_at = int(ref[p.size + 1])      # the second generated token
    srv = _server(port, max_slots=1, block_size=4, max_prompt_len=8,
                  max_new_tokens=4).start()
    try:
        out = srv.submit(p, sampling=SamplingParams(
            stop_token_ids=(stop_at,))).result(timeout=120)
        np.testing.assert_array_equal(out, ref[:p.size + 2])
        assert srv.stats()["stop_reasons"]["stop_token"] == 1
    finally:
        srv.stop()


def test_admission_respects_block_reservation(tiny):
    """Worst case per request: ceil((8 + 4)/4) = 3 blocks; a pool of 4
    usable blocks serves the requests one at a time."""
    _m, _c, port, tcfg, params = tiny
    srv = _server(port, max_slots=2, block_size=4, max_prompt_len=8,
                  max_new_tokens=4, num_blocks=5).start()
    try:
        prompts = _prompts(3, (8, 8, 8), tcfg.vocab_size)
        outs = [f.result(timeout=120) for f in
                [srv.submit(p) for p in prompts]]
        for p, o in zip(prompts, outs):
            np.testing.assert_array_equal(o, dense_greedy(params, tcfg, p,
                                                          4))
        st = srv.stats()
        assert st["kv_cache"]["used_blocks"] == 0
        assert st["kv_cache"]["peak_used_blocks"] <= 4
    finally:
        srv.stop()


def test_multistep_dispatch_matches_single_step(tiny):
    _m, _c, port, tcfg, _p = tiny
    prompts = _prompts(4, (3, 9, 6), tcfg.vocab_size)
    outs = {}
    for k in (1, 4):
        srv = _server(port, max_slots=2, block_size=4, max_prompt_len=12,
                      max_new_tokens=6, steps_per_dispatch=k).start()
        try:
            outs[k] = [f.result(timeout=120)
                       for f in [srv.submit(p) for p in prompts]]
            if k == 4:
                # 6 tokens per request at 4 per dispatch: 2 dispatches
                # per residency, far fewer than the 5 of k=1
                assert srv.stats()["decode_steps"] <= 4
        finally:
            srv.stop()
    for a, b in zip(outs[1], outs[4]):
        np.testing.assert_array_equal(a, b)


def test_admission_burst_is_one_packed_prefill_dispatch(tiny):
    _m, _c, port, tcfg, params = tiny
    prompts = _prompts(7, (3, 5, 4, 6), tcfg.vocab_size)
    srv = _server(port, max_slots=4, block_size=4, max_prompt_len=8,
                  max_new_tokens=3, prefill_chunk_tokens=64)
    futs = [srv.submit(p) for p in prompts]  # burst BEFORE start
    srv.start()
    try:
        for p, f in zip(prompts, futs):
            np.testing.assert_array_equal(f.result(timeout=120),
                                          dense_greedy(params, tcfg, p, 3))
        st = srv.stats()
        assert st["prefills"] == 4 and st["prefill_dispatches"] == 1
    finally:
        srv.stop()


def test_chunked_prefill_spans_multiple_dispatches(tiny):
    _m, _c, port, tcfg, params = tiny
    long_p, short_p = _prompts(8, (15, 3), tcfg.vocab_size)
    srv = _server(port, max_slots=2, block_size=4, max_prompt_len=16,
                  max_new_tokens=4, prefill_chunk_tokens=5).start()
    try:
        futs = [srv.submit(long_p), srv.submit(short_p)]
        for p, f in zip((long_p, short_p), futs):
            np.testing.assert_array_equal(f.result(timeout=120),
                                          dense_greedy(params, tcfg, p, 4))
        st = srv.stats()
        assert st["prefill_dispatches"] >= 3 and st["prefills"] == 2
    finally:
        srv.stop()


def test_prompt_ending_on_block_edge(tiny):
    """Prompts of exactly 1 and 2 blocks: the first decode write opens a
    new block, and the packed prefill's table width ends on the edge."""
    _m, _c, port, tcfg, params = tiny
    prompts = _prompts(12, (4, 8), tcfg.vocab_size)
    srv = _server(port, max_slots=2, block_size=4, max_prompt_len=8,
                  max_new_tokens=5).start()
    try:
        for p, f in zip(prompts, [srv.submit(p) for p in prompts]):
            np.testing.assert_array_equal(f.result(timeout=120),
                                          dense_greedy(params, tcfg, p, 5))
    finally:
        srv.stop()


def test_itl_stats_populated(tiny):
    _m, _c, port, tcfg, _p = tiny
    srv = _server(port, max_slots=2, block_size=4, max_prompt_len=8,
                  max_new_tokens=6).start()
    try:
        srv.submit(_prompts(9, (4,), tcfg.vocab_size)[0]).result(
            timeout=120)
        st = srv.stats()
        assert 0 < st["itl_p50_ms"] <= st["itl_p99_ms"]
        assert 0 < st["ttft_p50_ms"] <= st["ttft_p99_ms"]
        assert st["tokens_per_sec"] > 0 and st["decode_steps"] == 5
        srv.reset_stats()
        st = srv.stats()
        assert st["itl_p99_ms"] == 0.0 and st["requests"] == 0
    finally:
        srv.stop()


def test_failed_prefill_cleans_up_and_serves_on(tiny, monkeypatch):
    """A packed prefill that raises fails exactly the chunk's requests,
    returns their blocks, and the server serves later requests."""
    _m, _c, port, tcfg, params = tiny
    srv = _server(port, max_slots=2, block_size=4, max_prompt_len=8,
                  max_new_tokens=3)
    boom = {"armed": True}
    real = srv._decoder.packed_prefill

    def flaky(*a, **kw):
        if boom.pop("armed", False):
            raise RuntimeError("injected prefill failure")
        return real(*a, **kw)

    monkeypatch.setattr(srv._decoder, "packed_prefill", flaky)
    srv.start()
    try:
        bad = srv.submit(_prompts(10, (5,), tcfg.vocab_size)[0])
        with pytest.raises(RuntimeError, match="injected"):
            bad.result(timeout=120)
        assert srv.cache.stats()["used_blocks"] == 0
        p = _prompts(11, (4,), tcfg.vocab_size)[0]
        np.testing.assert_array_equal(srv.submit(p).result(timeout=120),
                                      dense_greedy(params, tcfg, p, 3))
    finally:
        srv.stop()


def test_concurrent_clients(tiny):
    _m, _c, port, tcfg, params = tiny
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, tcfg.vocab_size,
                          (int(rs.randint(2, 12)),)).astype(np.int32)
               for _ in range(6)]
    srv = _server(port, max_slots=3, block_size=4, max_prompt_len=12,
                  max_new_tokens=4).start()
    results = [None] * len(prompts)
    try:
        def client(i):
            results[i] = srv.submit(prompts[i]).result(timeout=120)

        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(prompts))]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=150)
            assert not th.is_alive()
        for i, p in enumerate(prompts):
            np.testing.assert_array_equal(results[i],
                                          dense_greedy(params, tcfg, p, 4))
    finally:
        srv.stop()


def test_stop_and_validation(tiny):
    _m, _c, port, _t, _p = tiny
    srv = _server(port, max_slots=1, block_size=4, max_prompt_len=8,
                  max_new_tokens=4)
    with pytest.raises(ValueError):
        srv.submit([])
    with pytest.raises(ValueError):
        srv.submit(list(range(9)))          # > max_prompt_len
    with pytest.raises(ValueError):
        srv.submit([1, 2], max_new_tokens=99)
    queued = srv.submit([1, 2, 3])          # never started: fails on stop
    srv.start()
    srv.stop()
    with pytest.raises(RuntimeError):
        srv.submit([1, 2, 3])
    assert queued.done()


def test_default_device_is_cuda_or_raises(tiny):
    """Without device=, the server runs on CUDA — and where there is no
    card it raises, naming the fix, instead of running on the CPU."""
    from paddle_tpu_torch.inference import PagedGenerationServer

    _m, _c, port, _t, _p = tiny
    if torch.cuda.is_available():
        srv = PagedGenerationServer(port, max_slots=1, block_size=4,
                                    max_new_tokens=2)
        assert srv.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PagedGenerationServer(port, max_slots=1, block_size=4,
                                  max_new_tokens=2)


def test_greedy_output_equals_reference_server(tiny):
    """Token for token against the JAX PagedGenerationServer on pinned
    prompts, same float32 weights, same scheduler settings (chunked
    prefill across dispatches, slot refill, multi-step decode)."""
    from paddle_tpu.inference import PagedGenerationServer as JServer

    model, cfg, port, tcfg, _p = tiny
    prompts = _prompts(21, (3, 12, 7, 16, 5, 9), tcfg.vocab_size)
    kw = dict(max_slots=3, block_size=4, max_prompt_len=16,
              max_new_tokens=6, prefill_chunk_tokens=10,
              steps_per_dispatch=2)
    jsrv = JServer(model, **kw).start()
    try:
        ref = [f.result(timeout=300) for f in
               [jsrv.submit(p) for p in prompts]]
    finally:
        jsrv.stop()
    srv = _server(port, **kw).start()
    try:
        outs = [f.result(timeout=120) for f in
                [srv.submit(p) for p in prompts]]
    finally:
        srv.stop()
    for r, o in zip(ref, outs):
        np.testing.assert_array_equal(o, np.asarray(r))
