"""The port's sampling subset (paddle_tpu_torch/sampling/): SamplingParams
validation twins of tests/test_sampling.py, greedy readout and
check_stops parity with the reference processors, and the server
refusing a sampled or penalized request at submit."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.sampling import (SamplingParams, SlotParamStore,
                                       check_greedy)
from paddle_tpu_torch.sampling import processors as proc

torch.set_num_threads(1)


@pytest.mark.parametrize("kw,field", [
    (dict(temperature=-0.1), "temperature"),
    (dict(temperature=math.nan), "temperature"),
    (dict(temperature=math.inf), "temperature"),
    (dict(top_k=-1), "top_k"),
    (dict(top_k=1.5), "top_k"),
    (dict(top_p=0.0), "top_p"),
    (dict(top_p=1.5), "top_p"),
    (dict(min_p=1.0), "min_p"),
    (dict(min_p=-0.1), "min_p"),
    (dict(repetition_penalty=0.0), "repetition_penalty"),
    (dict(presence_penalty=math.nan), "presence_penalty"),
    (dict(frequency_penalty=math.inf), "frequency_penalty"),
    (dict(stop_token_ids=(3, -1)), "stop_token_ids"),
    (dict(stop_strings=("",)), "stop_strings"),
    (dict(max_new_tokens=0), "max_new_tokens"),
    (dict(seed="x"), "seed"),
])
def test_params_validation_names_field(kw, field):
    """Every bad value fails at construction, naming the field — the
    reference's eager-validation contract, on the port's copy."""
    from paddle_tpu.sampling import SamplingParams as JParams

    with pytest.raises(ValueError, match=field):
        SamplingParams(**kw)
    with pytest.raises(ValueError, match=field):
        JParams(**kw)


def test_params_normalization_matches_reference():
    from paddle_tpu.sampling import SamplingParams as JParams

    kw = dict(temperature=0, top_k=3.0, seed=-1, stop_token_ids=[5, 2],
              max_new_tokens=4.0)
    a, b = SamplingParams(**kw), JParams(**kw)
    for f in ("temperature", "top_k", "seed", "stop_token_ids",
              "max_new_tokens", "is_greedy", "uses_penalties"):
        assert getattr(a, f) == getattr(b, f), f


def test_greedy_readout_and_stops_match_reference():
    """argmax with ties to the FIRST maximum, and the stop matrix check,
    on the same logits as the reference pipeline."""
    from paddle_tpu.sampling import processors as jproc

    rs = np.random.RandomState(0)
    logits = rs.randn(6, 50).astype(np.float32)
    logits[1, [7, 30]] = 9.0           # a tie: the first index wins
    logits[4, :] = 0.0                 # all equal: index 0
    stop = np.full((6, 2), -1, np.int32)
    stop[0, 0] = int(np.argmax(logits[0]))
    stop[2] = [int(np.argmax(logits[2])), 3]
    active = np.array([1, 1, 0, 1, 1, 1], bool)
    tok = proc.sample_tokens(torch.from_numpy(logits))
    jtok = jproc.sample_tokens(jnp.asarray(logits), {"stop": None},
                               sampled=False, penalties=False)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert tok.dtype == torch.int32 and tok[1] == 7 and tok[4] == 0
    st = proc.check_stops(tok, torch.from_numpy(stop),
                          torch.from_numpy(active))
    jst = jproc.check_stops(jtok, jnp.asarray(stop), jnp.asarray(active))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    assert st.tolist() == [True, False, False, False, False, False]


def test_update_counts_matches_reference():
    from paddle_tpu.sampling import processors as jproc

    counts = np.zeros((3, 10), np.int32)
    rows = np.array([0, 2, 0], np.int32)
    tok = np.array([4, 4, 4], np.int32)
    inc = np.array([True, True, False])
    got = proc.update_counts(torch.from_numpy(counts), torch.from_numpy(rows),
                             torch.from_numpy(tok), torch.from_numpy(inc))
    ref = jproc.update_counts(jnp.asarray(counts), jnp.asarray(rows),
                              jnp.asarray(tok), jnp.asarray(inc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_stop_matrix_matches_reference_store():
    """The slot store's stop-id matrix (EOS joined, -1 padded, pow2
    width) equals the reference SlotParamStore's for the same slots."""
    from paddle_tpu.sampling import SamplingParams as JParams
    from paddle_tpu.sampling import SlotParamStore as JStore

    ts = SlotParamStore(4, "cpu")
    js = JStore(4, 100)
    for i, ids in ((0, (5, 9, 2)), (2, ())):
        ts.set_slot(i, SamplingParams(stop_token_ids=ids), eos=7)
        js.set_slot(i, JParams(stop_token_ids=ids), seed=0, eos=7)
    sp = ts.step_args()
    jsp, jmode = js.step_args(np.zeros(4, np.int32))
    assert jmode == (False, False)     # the reference's greedy variant
    np.testing.assert_array_equal(sp["stop"].numpy(),
                                  np.asarray(jsp["stop"]))
    sp = ts.packed_args([2, None, 0])
    jsp, _ = js.packed_args([2, None, 0], [True, False, True])
    np.testing.assert_array_equal(sp["stop"].numpy(),
                                  np.asarray(jsp["stop"]))
    ts.clear_slot(0)
    assert ts._stop_ids[0] == ()


@pytest.mark.parametrize("kw", [dict(temperature=0.7),
                                dict(repetition_penalty=1.2),
                                dict(presence_penalty=0.5),
                                dict(frequency_penalty=0.1)])
def test_sampled_or_penalized_request_refused(kw):
    with pytest.raises(ValueError, match="greedy"):
        check_greedy(SamplingParams(**kw))


def test_server_refuses_sampled_request_at_submit():
    from paddle_tpu_torch.inference import PagedGenerationServer
    from paddle_tpu_torch.models import GPT2, GPT2Config

    cfg = GPT2Config(vocab_size=64, hidden_size=32, num_layers=1,
                     num_heads=2, max_position=32)
    srv = PagedGenerationServer(GPT2(cfg, device="cpu"), max_slots=1,
                                block_size=4, max_new_tokens=4,
                                device="cpu")
    with pytest.raises(ValueError, match="sampling slice"):
        srv.submit([1, 2, 3], sampling=SamplingParams(temperature=0.8))
    with pytest.raises(ValueError, match="detokenizer"):
        srv.submit([1, 2], sampling=SamplingParams(stop_strings=("x",)))
    with pytest.raises(TypeError):
        srv.submit([1, 2], sampling={"temperature": 0.0})
    assert not srv._queue                # nothing was enqueued
