"""The decode graph cache's CPU side (`paddle_tpu_torch/nn/decode_graph.py`):
`graph_key` is plain Python over tensor metadata, so what makes a new
capture is held here; the graphs themselves run on the card only
(`tests/test_torch_cuda.py`, marker `cuda`). Also: the cache refuses CPU
tensors rather than running the eager loop, the CPU server runs no graph,
and a replay's launch counts go through `kernels.add_launches`."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _parts(kv_dtype=None, stop_width=1, rows=4, sampled=False):
    from paddle_tpu_torch.inference.kv_cache import PagedKVCache
    from paddle_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from paddle_tpu_torch.sampling import SamplingParams, SlotParamStore

    cfg = GPT2Config(vocab_size=64, hidden_size=16, num_layers=1,
                     num_heads=2, max_position=32)
    params = GPT2(cfg, device="cpu").flat_params()
    cache = PagedKVCache(1, 2, 8, block_size=4, num_blocks=9,
                         kv_dtype=kv_dtype, device="cpu")
    store = SlotParamStore(rows, cfg.vocab_size, "cpu")
    stops = tuple(range(1, stop_width + 1)) if stop_width > 1 else ()
    store.set_slot(0, SamplingParams(temperature=0.7 if sampled else 0.0,
                                     stop_token_ids=stops), 3)
    sp, mode = store.step_args(np.zeros(rows, np.int32))
    inputs = (torch.zeros(rows, dtype=torch.int32),
              torch.zeros(rows, dtype=torch.int32),
              torch.ones(rows, dtype=torch.bool),
              torch.zeros(rows, 2, dtype=torch.int32))
    return params, inputs, cache, sp, mode


def _key(k, parts, kv_dtype=None):
    from paddle_tpu_torch.nn.decode_graph import graph_key

    params, inputs, cache, sp, mode = parts
    return graph_key(k, mode, kv_dtype, params, inputs, cache.k_blocks,
                     cache.v_blocks, sp)


def test_graph_key_is_stable_across_dispatches():
    """Fresh input tensors with other values (every dispatch builds its
    own) give the same key: the graph copies them into its buffers."""
    params, inputs, cache, sp, mode = _parts()
    a = _key(4, (params, inputs, cache, sp, mode))
    other = tuple(t.clone() + 1 for t in inputs[:2]) + inputs[2:]
    sp2 = {n: v.clone() for n, v in sp.items()}
    b = _key(4, (params, other, cache, sp2, mode))
    assert a == b
    assert hash(a) == hash(b)


def test_graph_key_tracks_what_fixes_the_program():
    params, inputs, cache, sp, mode = parts = _parts()
    base = _key(4, parts)
    assert _key(8, parts) != base                          # k
    assert _key(4, (params, inputs, cache, sp, (True, False))) != base
    # the stop matrix's width is a power of two over the longest stop list
    wide = _parts(stop_width=3)
    assert tuple(wide[3]["stop"].shape) == (4, 4)
    assert _key(4, (params, inputs, cache, wide[3], mode)) != base
    # a sampled dispatch carries more sp entries
    samp = _parts(sampled=True)
    assert samp[4] == (True, False)
    assert _key(4, (params, inputs, cache, samp[3], samp[4])) != base
    # a replaced param (same shape, new storage) or a replaced pool
    swapped = dict(params, **{"ln_f.weight": params["ln_f.weight"].clone()})
    assert _key(4, (swapped, inputs, cache, sp, mode)) != base
    fresh = _parts()[2]
    assert _key(4, (params, inputs, fresh, sp, mode)) != base
    # the batch width and the table width are shapes
    wider = inputs[:3] + (torch.zeros(4, 3, dtype=torch.int32),)
    assert _key(4, (params, wider, cache, sp, mode)) != base
    # W8A16 params are other entries; an int8 pool other leaves
    from paddle_tpu_torch.models.gpt2 import GPT2Config, \
        quantize_decode_weights_int8
    cfg = GPT2Config(vocab_size=64, hidden_size=16, num_layers=1,
                     num_heads=2, max_position=32)
    wq = quantize_decode_weights_int8(params, cfg)
    assert _key(4, (wq, inputs, cache, sp, mode)) != base
    q = _parts(kv_dtype="int8")
    assert _key(4, (params, inputs, q[2], sp, mode), "int8") != base


def test_graphs_refuse_cpu_tensors_and_mismatched_pools():
    """No fallback: the cache never runs the eager loop for a CPU call,
    and the decoder's pool pairing check comes first."""
    from paddle_tpu_torch.nn.decode import PagedDecoder

    params, inputs, cache, sp, mode = _parts()
    dec = PagedDecoder((1, 2, 8, 16, 1e-5, True), 4)
    with pytest.raises(ValueError, match="on the card"):
        dec.graphs(2, mode, params, *inputs, cache.k_blocks,
                   cache.v_blocks, sp)
    assert dec.graphs.captures == 0 and len(dec.graphs) == 0
    q = PagedDecoder((1, 2, 8, 16, 1e-5, True), 4, kv_dtype="int8")
    assert q.graphs is q.graphs  # one cache per decoder, made once


def test_add_launches_adds_and_takes_back():
    from paddle_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    kernels.add_launches({"paged_decode_dense": 24, "ragged_stream_int8": 2})
    got = kernels.launch_counts()
    assert got["paged_decode_dense"] == 24
    assert got["ragged_stream_int8"] == 2
    kernels.add_launches({"paged_decode_dense": -24,
                          "ragged_stream_int8": -2})
    assert set(kernels.launch_counts().values()) == {0}


def test_cpu_server_runs_no_graph():
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.models.gpt2 import GPT2, GPT2Config

    cfg = GPT2Config(vocab_size=64, hidden_size=16, num_layers=1,
                     num_heads=2, max_position=32)
    srv = PagedGenerationServer(GPT2(cfg, device="cpu"), max_slots=2,
                                block_size=4, max_new_tokens=4,
                                steps_per_dispatch=2, device="cpu").start()
    try:
        out = srv.submit(np.arange(1, 6, dtype=np.int32)).result(timeout=60)
        st = srv.stats()
    finally:
        srv.stop()
    assert out.shape == (9,)
    assert st["decode_steps"] >= 2
    assert st["decode_graph_replays"] == 0
    assert st["decode_graph_captures"] == 0


def test_graph_key_separates_the_programs():
    """The program's name is part of the key: a verify dispatch and a
    window round never replay a multistep graph (or each other's), even
    where every tensor argument has the same shape; the name defaults to
    multistep."""
    from paddle_tpu_torch.nn.decode_graph import graph_key

    params, inputs, cache, sp, mode = _parts()
    args = (1, mode, None, params, inputs, cache.k_blocks, cache.v_blocks,
            sp)
    keys = {name: graph_key(*args, program=name)
            for name in ("multistep", "packed_verify", "unified_window")}
    assert len(set(keys.values())) == 3
    assert graph_key(*args) == keys["multistep"]


def test_verify_and_window_graphs_refuse_cpu_tensors():
    """No fallback for the new programs either."""
    from paddle_tpu_torch.nn.decode import PagedDecoder

    params, inputs, cache, sp, mode = _parts()
    dec = PagedDecoder((1, 2, 8, 16, 1e-5, True), 4)
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        dec.graphs.verify(mode, params, z, z, z, inputs[3],
                          torch.zeros(4, 2, dtype=torch.int32),
                          torch.zeros(4, dtype=torch.int32), cache.k_blocks,
                          cache.v_blocks, sp)
    c = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        dec.graphs.unified(mode, params, z, z, z, inputs[3],
                           torch.zeros(4, 2, dtype=torch.int32), c, c, z, z,
                           c, c, c, c, cache.k_blocks, cache.v_blocks, sp)
    assert dec.graphs.captures == 0 and len(dec.graphs) == 0
