"""`GenerationServer`, the port's dynamic batcher over one fixed-shape
decode program, held to the JAX reference on the CPU with the same
weights: twins of the 8 tests of `tests/test_serving.py::
TestGenerationServer` (over the port's `export_generator` artifact
loaded by `jit.load`, every row equal to the reference's `generate` of
that prompt), of `tests/test_sampling.py::TestDenseServerSampling`'s 3
(over a program that calls the port's `generate`), and of
`tests/test_quantized_serving.py::TestQuantStatsSchema::
test_dense_server_block_is_congruent` (the port's block equals the
reference server's).

No test depends on wall-clock margins: the concurrent clients queue
their requests before the batcher starts, so the batches they form are
fixed, and the offered-load harness is held to what it submitted."""
import threading

import numpy as np
import pytest
import torch

from torch_twin_util import reference_tiny_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the port's loaded artifact, reference model, port model): B 4,
    prompt_len 6, 4 new tokens, tests/test_serving.py's weights
    (paddle.seed(11))."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt2 import export_generator

    model, _cfg, port, _tcfg = reference_tiny_model(11)
    prefix = str(tmp_path_factory.mktemp("srv") / "gen")
    export_generator(port, prefix, prompt_len=6, max_new_tokens=4,
                     batch_size=4)
    return jit.load(prefix, device="cpu"), model, port


def _ref(model, ids, n, **kw):
    return np.asarray(model.generate(np.asarray(ids), n, **kw).numpy())


class TestGenerationServer:
    def test_infers_shape_from_artifact(self, served):
        from paddle_tpu_torch.inference import GenerationServer

        prog, _, _ = served
        srv = GenerationServer(prog, pad_token_id=0)
        assert srv.batch_size == 4
        assert srv.prompt_len == 6
        # attribution keeps a ledger from construction; without it the
        # cost report is None
        assert GenerationServer(prog, attribution=True).cost_report() \
            is not None
        assert srv.cost_report() is None

    def test_single_request_matches_generate(self, served):
        from paddle_tpu_torch.inference import GenerationServer

        prog, model, port = served
        srv = GenerationServer(prog, pad_token_id=0, max_wait_ms=1).start()
        try:
            ids = np.random.RandomState(0).randint(1, 1024, (6,)).astype(
                np.int32)
            out = srv.submit(ids).result(timeout=120)
            np.testing.assert_array_equal(out, _ref(model, ids[None], 4)[0])
            np.testing.assert_array_equal(
                out, port.generate(ids[None], 4).numpy()[0])
        finally:
            srv.stop()

    def test_short_prompt_left_padded(self, served):
        from paddle_tpu_torch.inference import GenerationServer

        prog, model, _ = served
        srv = GenerationServer(prog, pad_token_id=0, max_wait_ms=1).start()
        try:
            ids = np.array([5, 9, 3], np.int32)  # 3 < prompt_len 6
            out = srv.submit(ids).result(timeout=120)
            padded = np.concatenate([np.zeros(3, np.int32), ids])[None]
            np.testing.assert_array_equal(
                out, _ref(model, padded, 4, pad_token_id=0)[0])
        finally:
            srv.stop()

    def test_concurrent_clients_batch_together(self, served):
        """8 clients on 8 threads queue their prompts, then the batcher
        starts: a B 4 program serves them in exactly 2 batches, every row
        the reference's generate of its prompt."""
        from paddle_tpu_torch.inference import GenerationServer

        prog, model, _ = served
        srv = GenerationServer(prog, pad_token_id=0, max_wait_ms=200)
        rng = np.random.RandomState(3)
        prompts = [rng.randint(1, 1024, (6,)).astype(np.int32)
                   for _ in range(8)]
        futs = [None] * 8

        def client(i):
            futs[i] = srv.submit(prompts[i])

        ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        srv.start()
        try:
            results = [f.result(timeout=120) for f in futs]
            ref = _ref(model, np.stack(prompts), 4)
            for i in range(8):
                np.testing.assert_array_equal(results[i], ref[i])
            st = srv.stats()
            assert st["requests"] == 8
            assert st["batches"] == 2, st
            assert st["batch_fill"] == 1.0
            assert st["new_tokens"] == 8 * 4
            assert st["p99_ms"] >= st["p50_ms"] > 0
        finally:
            srv.stop()

    def test_offered_load_harness(self, served):
        from paddle_tpu_torch.inference import (GenerationServer,
                                                measure_offered_load)

        prog, _, _ = served
        srv = GenerationServer(prog, pad_token_id=0, max_wait_ms=20).start()
        try:
            prompts = [list(range(1, 7)), [3, 4, 5]]
            out = measure_offered_load(srv, prompts, offered_rps=50,
                                       duration_s=0.5)
            # every submitted request was answered inside the window
            assert out["requests"] >= 1
            assert out["new_tokens"] == 4 * out["requests"]
            assert out["tokens_per_sec"] > 0
            assert 0 < out["batch_fill"] <= 1.0
            assert out["offered_rps"] == 50 and out["achieved_rps"] > 0
        finally:
            srv.stop()

    def test_stop_rejects_new_and_fails_queued(self, served):
        from paddle_tpu_torch.inference import GenerationServer

        prog, _, _ = served
        srv = GenerationServer(prog, pad_token_id=0)
        queued = srv.submit([1, 2, 3])  # never started: stays queued
        srv.stop()
        with pytest.raises(RuntimeError, match="stopped"):
            queued.result(timeout=10)
        with pytest.raises(RuntimeError):
            srv.submit([1, 2, 3])
        with pytest.raises(RuntimeError, match="new GenerationServer"):
            srv.start()

    def test_bad_prompt_length_rejected(self, served):
        from paddle_tpu_torch.inference import GenerationServer

        prog, _, _ = served
        srv = GenerationServer(prog, pad_token_id=0)
        with pytest.raises(ValueError):
            srv.submit([])
        with pytest.raises(ValueError):
            srv.submit(list(range(7)))  # > prompt_len

    def test_full_length_prompt_with_pad_token_guarded(self, served,
                                                       monkeypatch):
        """A full-length prompt containing pad_token_id is warned about
        at submit (it would be masked in a batch with a padded row), or
        rejected under strict_pad_check=True; a short prompt containing
        it, or a full-length one without it, passes silently."""
        from paddle_tpu_torch.inference import GenerationServer
        from paddle_tpu_torch.inference import serving as serving_mod

        prog, _, _ = served
        warnings = []
        monkeypatch.setattr(
            serving_mod._logger, "warning",
            lambda msg, *a: warnings.append(msg % a if a else msg))
        srv = GenerationServer(prog, pad_token_id=0)
        tricky = np.array([5, 9, 0, 3, 7, 2], np.int32)  # pad mid-prompt
        fut = srv.submit(tricky)                         # warns, queues
        assert len(warnings) == 1
        assert "pad_token_id=0" in warnings[0]
        assert "positions [2]" in warnings[0]
        srv.submit(np.array([5, 0, 3], np.int32))        # short: fine
        srv.submit(np.array([5, 9, 1, 3, 7, 2], np.int32))  # no pad id
        assert len(warnings) == 1
        assert not fut.done()                            # queued
        strict = GenerationServer(prog, pad_token_id=0,
                                  strict_pad_check=True)
        with pytest.raises(ValueError, match="pad_token_id=0"):
            strict.submit(tricky)
        strict.submit(np.array([5, 0, 3], np.int32))     # short still ok
        srv.stop()
        strict.stop()


# ---- twins of tests/test_sampling.py::TestDenseServerSampling ---------------

class TestDenseServerSampling:
    @staticmethod
    def _server(port, batch_size=2, prompt_len=8, new=3):
        from paddle_tpu_torch.inference import GenerationServer

        def prog(ids, seed, temp, eos, top_p, pad):
            return port.generate(
                ids, new, temperature=float(temp), seed=int(seed),
                eos_token_id=None if int(eos) < 0 else int(eos),
                top_p=float(top_p),
                pad_token_id=None if int(pad) < 0 else int(pad)).numpy()

        return GenerationServer(prog, batch_size=batch_size,
                                prompt_len=prompt_len, pad_token_id=0)

    def test_accepts_program_level_subset(self, served):
        from paddle_tpu_torch.sampling import SamplingParams

        _, model, port = served
        rs = np.random.RandomState(15)
        p = rs.randint(1, 1024, (8,)).astype(np.int32)
        srv = self._server(port).start()
        try:
            sp = SamplingParams(temperature=0.8, top_p=0.9, seed=4)
            a = srv.submit(p, sampling=sp).result(timeout=300)
            b = srv.submit(p, sampling=sp).result(timeout=300)
            # an explicit seed reproduces across batches
            np.testing.assert_array_equal(a, b)
            # the batch's program call: the row and its repeat, seed 4
            ref = _ref(model, np.stack([p, p]), 3, temperature=0.8,
                       top_p=0.9, seed=4)
            np.testing.assert_array_equal(a, ref[0])
        finally:
            srv.stop()

    def test_rejects_per_slot_fields_eagerly(self, served):
        from paddle_tpu_torch.sampling import SamplingParams

        srv = self._server(served[2])
        for kw, field in [(dict(top_k=5), "top_k"),
                          (dict(min_p=0.2), "min_p"),
                          (dict(repetition_penalty=1.2),
                           "repetition_penalty"),
                          (dict(stop_strings=("x",)), "stop_strings"),
                          (dict(max_new_tokens=2), "max_new_tokens"),
                          (dict(stop_token_ids=(1, 2)), "stop")]:
            with pytest.raises(ValueError) as ei:
                srv.submit([1, 2, 3], sampling=SamplingParams(**kw))
            assert field in str(ei.value)
        with pytest.raises(TypeError, match="SamplingParams"):
            srv.submit([1, 2, 3], sampling={"temperature": 1.0})

    def test_mixed_signatures_batch_separately_and_stats_congruent(
            self, served):
        """stats() carries the paged server's stop-reason schema; requests
        of different signatures never share a program call."""
        from paddle_tpu_torch.inference import PagedGenerationServer
        from paddle_tpu_torch.sampling import SamplingParams

        _, model, port = served
        rs = np.random.RandomState(16)
        p1 = rs.randint(1, 1024, (8,)).astype(np.int32)
        p2 = rs.randint(1, 1024, (8,)).astype(np.int32)
        srv = self._server(port)
        f1 = srv.submit(p1)
        f2 = srv.submit(p2, sampling=SamplingParams(temperature=1.0,
                                                    seed=8))
        srv.start()
        try:
            g = f1.result(timeout=300)
            f2.result(timeout=300)
            np.testing.assert_array_equal(g, _ref(model, p1[None], 3)[0])
            st = srv.stats()
            assert st["batches"] == 2  # signatures cannot share a batch
            dense_reasons = st["stop_reasons"]
        finally:
            srv.stop()
        psrv = PagedGenerationServer(port, max_slots=1, block_size=4,
                                     max_prompt_len=8, max_new_tokens=3,
                                     device="cpu")
        paged_reasons = psrv.stats()["stop_reasons"]
        assert set(dense_reasons) == set(paged_reasons)
        assert sum(dense_reasons.values()) == 2
        assert dense_reasons["budget"] == 2
        srv.reset_stats()
        psrv.reset_stats()
        assert sum(srv.stats()["stop_reasons"].values()) == 0
        assert sum(psrv.stats()["stop_reasons"].values()) == 0


def test_eos_and_stop_token_reasons(served):
    """The eos block of stats: a row whose output holds the batch's eos
    counts as eos, or as stop_token when the id came from the request's
    stop_token_ids."""
    from paddle_tpu_torch.inference import GenerationServer
    from paddle_tpu_torch.sampling import SamplingParams

    prog, _, port = served
    ids = np.random.RandomState(0).randint(1, 1024, (6,)).astype(np.int32)
    first = int(port.generate(ids[None], 1).numpy()[0, -1])
    srv = GenerationServer(prog, pad_token_id=0, eos_token_id=first)
    a = srv.submit(ids)
    b = srv.submit(ids, sampling=SamplingParams(stop_token_ids=(first,)))
    srv.start()
    try:
        for f in (a, b):
            out = f.result(timeout=120)
            assert (out[6:] == first).all()
        reasons = srv.stats()["stop_reasons"]
        assert reasons["eos"] == 1 and reasons["stop_token"] == 1
    finally:
        srv.stop()


# ---- twin of TestQuantStatsSchema::test_dense_server_block_is_congruent -----

def test_dense_server_block_is_congruent():
    from paddle_tpu.inference import GenerationServer as JServer

    from paddle_tpu_torch.inference import GenerationServer

    def prog(ids, *a):
        return np.zeros((ids.shape[0], ids.shape[1] + 1), np.int32)

    blocks = []
    for Server in (JServer, GenerationServer):
        srv = Server(prog, batch_size=2, prompt_len=4)
        st = srv.stats()["quantization"]
        assert st["enabled"] is False and st["mode"] == "none"
        prog2 = lambda ids, *a: prog(ids)  # noqa: E731
        prog2._meta = {"prompt_len": 4, "batch_size": 2,
                       "weight_quant": "int8", "kv_quant": "int8"}
        st2 = Server(prog2).stats()["quantization"]
        assert st2["enabled"] is True
        assert st2["mode"] == "w8a16"
        assert st2["kv_dtype"] == "int8"
        blocks.append((st, st2))
    assert blocks[0] == blocks[1]
