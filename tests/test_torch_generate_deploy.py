"""The port's deployment artifact (`models.gpt2.export_generator` ->
`jit.load`), held to the JAX reference on the CPU with the same weights:
twins of `tests/test_generate_deploy.py`'s 4 tests (the served tokens
equal the port's in-process `generate` and the reference's served
tokens), batch polymorphism, int8 codes in the npz, a bfloat16 round
trip through the `dt:` sidecar, the meta's keys, and the loader's
refusals (the reference's StableHLO artifact, a wrong batch shape,
`jit.save` of an arbitrary layer)."""
import json

import numpy as np
import pytest
import torch

from torch_twin_util import reference_tiny_model

torch.set_num_threads(1)

REFERENCE_META_KEYS = {"kind", "weight_quant", "kv_quant", "prompt_len",
                       "max_new_tokens", "top_k", "top_p_enabled",
                       "batch_size", "inputs"}


@pytest.fixture(scope="module")
def tiny():
    # tests/test_generate_deploy.py's first weights: paddle.seed(8)
    return reference_tiny_model(8)


@pytest.fixture(scope="module")
def tiny0():
    # the W8A16 round trips' weights: paddle.seed(0)
    return reference_tiny_model(0)


def _serve(served, ids, seed=0, temp=0.0, eos=-1, top_p=1.0, pad=-1):
    out = served(ids, np.uint32(seed), np.float32(temp), np.int32(eos),
                 np.float32(top_p), np.int32(pad))
    return np.asarray(out.numpy() if hasattr(out, "numpy") else out)


def _pair(tmp_path, tiny, **kw):
    """(reference served, port served) for one export configuration."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt2 import export_generator as j_export

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt2 import export_generator

    model, _cfg, port, _tcfg = tiny
    j_export(model, str(tmp_path / "ref"), **kw)
    export_generator(port, str(tmp_path / "port"), **kw)
    return (paddle.jit.load(str(tmp_path / "ref")),
            jit.load(str(tmp_path / "port"), device="cpu"))


def test_exported_generator_matches_generate(tmp_path, tiny):
    ref_served, served = _pair(tmp_path, tiny, prompt_len=5,
                               max_new_tokens=6)
    port = tiny[2]
    ids = np.random.RandomState(0).randint(0, 1024, (2, 5)).astype(np.int32)
    out = _serve(served, ids)
    assert out.dtype == np.int32 and out.shape == (2, 11)
    np.testing.assert_array_equal(out, port.generate(ids, 6).numpy())
    np.testing.assert_array_equal(out, _serve(ref_served, ids))
    # batch-polymorphic: another batch size runs on the same artifact
    ids3 = np.random.RandomState(1).randint(0, 1024, (3, 5)).astype(
        np.int32)
    out3 = _serve(served, ids3)
    np.testing.assert_array_equal(out3, port.generate(ids3, 6).numpy())
    np.testing.assert_array_equal(out3, _serve(ref_served, ids3))
    assert served._meta["batch_size"] is None
    with pytest.raises(ValueError, match=r"\[B, 5\]"):
        served(ids[:, :4], 0, 0.0, -1, 1.0, -1)


def test_exported_generator_sampling_reproducible(tmp_path, tiny):
    ref_served, served = _pair(tmp_path, tiny, prompt_len=4,
                               max_new_tokens=5, top_k=20)
    ids = np.array([[1, 2, 3, 4]], np.int32)
    a = _serve(served, ids, seed=7, temp=0.9)
    b = _serve(served, ids, seed=7, temp=0.9)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1, 9)
    np.testing.assert_array_equal(a, _serve(ref_served, ids, seed=7,
                                            temp=0.9))
    np.testing.assert_array_equal(
        a, tiny[2].generate(ids, 5, temperature=0.9, top_k=20,
                            seed=7).numpy())


def test_w8a16_artifact_roundtrip(tmp_path, tiny0):
    """int8 codes and scales ride the npz; the served program equals the
    in-process W8A16 greedy exactly, and the reference's artifact."""
    ids = np.random.RandomState(0).randint(5, 200, (2, 10)).astype(np.int32)
    ref_served, served = _pair(tmp_path, tiny0, prompt_len=10,
                               max_new_tokens=8, batch_size=2,
                               weight_quant="int8")
    out = _serve(served, ids)
    np.testing.assert_array_equal(
        out, tiny0[2].generate(ids, 8, weight_quant="int8").numpy())
    np.testing.assert_array_equal(out, _serve(ref_served, ids))
    z = np.load(str(tmp_path / "port") + ".pdiparams")
    assert sum(1 for k in z.files if z[k].dtype == np.int8) > 0, \
        "artifact should carry int8 weight codes"
    # the codes are the reference artifact's, bit for bit
    zr = np.load(str(tmp_path / "ref") + ".pdiparams")
    for k in z.files:
        if k.endswith("::w8c"):
            np.testing.assert_array_equal(z[k], zr[k])
    with pytest.raises(ValueError, match=r"\[2, 10\]"):
        served(ids[:1], 0, 0.0, -1, 1.0, -1)


def test_kv8_w8_artifact_roundtrip(tmp_path, tiny0):
    ids = np.random.RandomState(1).randint(5, 200, (2, 10)).astype(np.int32)
    ref_served, served = _pair(tmp_path, tiny0, prompt_len=10,
                               max_new_tokens=8, batch_size=2,
                               weight_quant="int8", kv_quant="int8")
    out = _serve(served, ids)
    np.testing.assert_array_equal(
        out, tiny0[2].generate(ids, 8, weight_quant="int8",
                               kv_quant="int8").numpy())
    np.testing.assert_array_equal(out, _serve(ref_served, ids))


def test_left_padded_artifact_matches_generate(tmp_path, tiny):
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt2 import export_generator

    port = tiny[2]
    export_generator(port, str(tmp_path / "g"), prompt_len=6,
                     max_new_tokens=4, top_p_enabled=True)
    served = jit.load(str(tmp_path / "g"), device="cpu")
    ids = np.array([[0, 0, 0, 5, 9, 3], [4, 8, 15, 16, 23, 42]], np.int32)
    for kw in (dict(), dict(temperature=0.8, top_p=0.9, seed=3)):
        out = _serve(served, ids, seed=kw.get("seed", 0),
                     temp=kw.get("temperature", 0.0),
                     top_p=kw.get("top_p", 1.0), pad=0)
        np.testing.assert_array_equal(
            out, port.generate(ids, 4, pad_token_id=0, **kw).numpy())


def test_bf16_artifact_roundtrip_through_sidecar(tmp_path, tiny):
    """A bfloat16 model's params go through the npz as uint8 views with
    `dt:` sidecars and come back bit for bit; the served tokens equal the
    bf16 model's in-process generate."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt2 import export_generator

    port = tiny[2]
    port16 = type(port)(tiny[3], device="cpu", init=False)
    with torch.no_grad():
        for (_, p16), (_, p) in zip(port16.named_parameters(),
                                    port.named_parameters()):
            p16.data = p.detach().to(torch.bfloat16)
    prefix = str(tmp_path / "bf16")
    export_generator(port16, prefix, prompt_len=5, max_new_tokens=4)
    z = np.load(prefix + ".pdiparams")
    assert bytes(z["dt:p:wte.weight"]).decode() == "bfloat16"
    assert z["p:wte.weight"].dtype == np.uint8
    assert z["p:wte.weight"].shape == (1024, 128, 2)
    served = jit.load(prefix, device="cpu")
    for name, want in port16.flat_params().items():
        got = served._params[name]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want), name
    ids = np.random.RandomState(4).randint(1, 1024, (2, 5)).astype(np.int32)
    np.testing.assert_array_equal(_serve(served, ids),
                                  port16.generate(ids, 4).numpy())


def test_meta_keys_and_format(tmp_path, tiny):
    """The .pdmodel is the port's magic, an 8-byte length and the JSON
    meta, with no program body; the meta holds the reference's keys plus
    the format and the config the loader rebuilds the program from."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt2 import export_generator

    prefix = str(tmp_path / "m")
    path = export_generator(tiny[2], prefix, prompt_len=5, max_new_tokens=3,
                            top_k=7, batch_size=2)
    assert path == prefix + ".pdmodel"
    raw = open(path, "rb").read()
    assert raw[:8] == jit.MAGIC
    n = int.from_bytes(raw[8:16], "little")
    assert len(raw) == 16 + n  # no program body
    meta = json.loads(raw[16:].decode())
    assert REFERENCE_META_KEYS <= set(meta)
    assert set(meta) - REFERENCE_META_KEYS == {"format", "config"}
    assert meta["format"] == jit.FORMAT
    assert meta["kind"] == "gpt2_generator"
    assert (meta["prompt_len"], meta["max_new_tokens"], meta["top_k"],
            meta["batch_size"]) == (5, 3, 7, 2)
    assert meta["config"] == {k: getattr(tiny[3], k)
                              for k in jit.CONFIG_FIELDS}
    assert jit.load(prefix, device="cpu")._meta == meta


def test_loader_refusals(tmp_path, tiny):
    from paddle_tpu.models.gpt2 import export_generator as j_export

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt2 import export_generator

    j_export(tiny[0], str(tmp_path / "ref"), prompt_len=4, max_new_tokens=2)
    with pytest.raises(ValueError, match="StableHLO"):
        jit.load(str(tmp_path / "ref"), device="cpu")
    with pytest.raises(ValueError, match="input_spec"):
        jit.save(tiny[2], str(tmp_path / "x"))  # the reference's refusal
    with pytest.raises(ValueError, match=">= 1"):
        export_generator(tiny[2], str(tmp_path / "y"), prompt_len=4,
                         max_new_tokens=0)
    with pytest.raises(ValueError, match="max_position"):
        export_generator(tiny[2], str(tmp_path / "y"), prompt_len=250,
                         max_new_tokens=8)
    for kw in (dict(weight_quant="int4"), dict(kv_quant="fp8")):
        with pytest.raises(ValueError, match="int8"):
            export_generator(tiny[2], str(tmp_path / "y"), prompt_len=4,
                             max_new_tokens=2, **kw)
