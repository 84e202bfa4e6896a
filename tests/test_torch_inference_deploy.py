"""CPU twins of the port's deployment path (`jit.save` / `jit.load` of
any layer, `inference.Config` / `create_predictor` / `PredictorPool`,
`Model.save(training=False)`, `slim`'s save) against the reference's:
the fourteen cases of test_inference_deploy.py, on the same weights
(`load_reference_state`, `from_reference_params`) and numpy inputs.

The port's artifact is its own (`jit`'s module docstring): `MAGIC`, the
JSON meta and a serialized `torch.export` program in the `.pdmodel`, the
reference's npz in the `.pdiparams`. A fresh process that imports only
`paddle_tpu_torch.inference` serves it. Tolerances: float32 outputs
1e-5 (the reference's own), GPT-2 tiny logits 2e-4 (the reference's),
bf16 outputs 1e-2 absolute (the reference's).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.nn as rnn
from paddle_tpu.core.tensor import Tensor as RT

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch import jit
from paddle_tpu_torch.inference import Config, PredictorPool, create_predictor
from paddle_tpu_torch.nn.layer.layers import load_reference_state
from paddle_tpu_torch.static import InputSpec

from torch_twin_util import reference_tiny_model

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


class _RNet(rnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = rnn.Linear(4, 16)
        self.fc2 = rnn.Linear(16, 3)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


class _PNet(pnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = pnn.Linear(4, 16)
        self.fc2 = pnn.Linear(16, 3)

    def forward(self, x):
        return self.fc2(ptt.nn.functional.relu(self.fc1(x)))


def carry(ref, port):
    assert load_reference_state(port, {
        k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}) == []


def pair(seed, rcls=_RNet, pcls=_PNet):
    paddle.seed(seed)
    ref, port = rcls(), pcls()
    carry(ref, port)
    ref.eval()
    port.eval()
    return ref, port


def rout(ref, x):
    return np.asarray(ref(RT(jnp.asarray(x))).numpy())


def cpu_config(prefix):
    cfg = Config(prefix + ".pdmodel", prefix + ".pdiparams")
    cfg.disable_gpu()
    return cfg


def _save_net(tmp_path):
    ref, port = pair(11)
    prefix = str(tmp_path / "deploy" / "inference")
    jit.save(port, prefix, input_spec=[InputSpec([None, 4], "float32")])
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    return prefix, x, rout(ref, x)


class TestJitSaveLoad:
    def test_artifacts_exist_and_model_is_stablehlo(self, tmp_path):
        """The reference's name; the port's .pdmodel is its magic, the
        meta and a torch.export archive that holds no weight (the npz
        holds each one, once, under p: keys)."""
        import io
        import json
        prefix, _, _ = _save_net(tmp_path)
        assert os.path.exists(prefix + ".pdiparams")
        raw = open(prefix + ".pdmodel", "rb").read()
        assert raw[:8] == jit.MAGIC
        n = int.from_bytes(raw[8:16], "little")
        meta = json.loads(raw[16:16 + n])
        assert (meta["format"], meta["kind"], meta["class_name"]) == \
            (jit.LAYER_FORMAT, "layer", "_PNet")
        assert meta["in_specs"] == [[[None, 4], "float32"]]
        ep = torch.export.load(io.BytesIO(raw[16 + n:]))
        assert not ep.state_dict and not ep.constants
        assert ep.example_inputs is None
        with open(prefix + ".pdiparams", "rb") as f:
            npz = np.load(f, allow_pickle=False)
            assert sorted(npz.files) == sorted(
                "p:" + k for k in ("fc1.weight", "fc1.bias", "fc2.weight",
                                   "fc2.bias"))

    def test_load_runs_without_model_class(self, tmp_path):
        prefix, x, ref = _save_net(tmp_path)
        loaded = jit.load(prefix, device="cpu")
        np.testing.assert_allclose(loaded(torch.from_numpy(x)).numpy(), ref,
                                   rtol=1e-5, atol=1e-5)
        x2 = np.random.RandomState(1).randn(9, 4).astype(np.float32)
        assert tuple(loaded(torch.from_numpy(x2)).shape) == (9, 3)

    def test_multiple_dynamic_dims_share_one_scope(self, tmp_path):
        ref, port = pair(5)
        prefix = str(tmp_path / "dyn2")
        jit.save(port, prefix,
                 input_spec=[InputSpec([None, None, 4], "float32")])
        loaded = jit.load(prefix, device="cpu")
        for b, s in ((2, 3), (5, 7), (1, 1)):
            x = np.random.rand(b, s, 4).astype(np.float32)
            out = loaded(torch.from_numpy(x))
            assert tuple(out.shape) == (b, s, 3)
            np.testing.assert_allclose(out.numpy(), rout(ref, x),
                                       rtol=1e-5, atol=1e-5)

    def test_save_load_with_buffers_batchnorm(self, tmp_path):
        """BatchNorm's running statistics ship as `b:` buffers and drive
        the loaded eval-mode normalization; trained on both sides with
        the same batches, the loaded outputs are the reference's."""
        paddle.seed(6)
        ref = rnn.Sequential(rnn.Linear(4, 8), rnn.BatchNorm1D(8),
                             rnn.Linear(8, 2))
        port = pnn.Sequential(pnn.Linear(4, 8), pnn.BatchNorm1D(8),
                              pnn.Linear(8, 2))
        carry(ref, port)
        rng = np.random.RandomState(3)
        ref.train()
        port.train()
        for _ in range(4):
            xb = (rng.randn(16, 4) * 3 + 1).astype(np.float32)
            ref(RT(jnp.asarray(xb)))
            port(torch.from_numpy(xb))
        ref.eval()
        port.eval()
        prefix = str(tmp_path / "bn")
        jit.save(port, prefix, input_spec=[InputSpec([None, 4], "float32")])
        x = rng.randn(5, 4).astype(np.float32)
        out = jit.load(prefix, device="cpu")(torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), rout(ref, x), rtol=1e-5,
                                   atol=1e-5)
        assert port.training is False

    def test_save_requires_input_spec(self, tmp_path):
        with pytest.raises(ValueError, match="input_spec"):
            jit.save(_PNet(), str(tmp_path / "m"))

    def test_cross_process_predictor_no_model_import(self, tmp_path):
        """A fresh process with only the artifact files rebuilds and runs
        the model: no test module, no model or layer class, no JAX."""
        prefix, x, ref = _save_net(tmp_path)
        np.save(str(tmp_path / "x.npy"), x)
        script = textwrap.dedent(f"""
            import sys
            import numpy as np
            from paddle_tpu_torch.inference import Config, create_predictor
            cfg = Config({prefix!r} + ".pdmodel", {prefix!r} + ".pdiparams")
            cfg.disable_gpu()
            pred = create_predictor(cfg)
            out = pred.run([np.load({str(tmp_path / "x.npy")!r})])
            leaked = [m for m in sys.modules if "test_torch" in m
                      or m.startswith(("paddle_tpu_torch.models",
                                       "paddle_tpu_torch.nn", "jax"))
                      or m == "paddle_tpu" or m.startswith("paddle_tpu.")]
            assert not leaked, leaked
            np.save({str(tmp_path / "out.npy")!r}, out.numpy())
            print("CROSS_PROCESS_OK")
        """)
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH",)}
        env["PYTHONPATH"] = REPO
        r = subprocess.run([sys.executable, "-c", script], text=True,
                           capture_output=True, timeout=240, env=env,
                           cwd=REPO)
        assert "CROSS_PROCESS_OK" in r.stdout, (r.stdout, r.stderr[-2000:])
        np.testing.assert_allclose(np.load(str(tmp_path / "out.npy")), ref,
                                   rtol=1e-5, atol=1e-5)

    def test_handle_based_predictor_flow(self, tmp_path):
        prefix, x, ref = _save_net(tmp_path)
        pred = create_predictor(cpu_config(prefix))
        names = pred.get_input_names()
        assert names == ["input_0"]
        pred.get_input_handle(names[0]).copy_from_cpu(x)
        assert pred.run()
        out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    def test_a_predictor_without_a_card_raises(self, tmp_path):
        """Config's default is the card: with none, create_predictor
        raises (the port never drops quietly to the CPU)."""
        prefix, _, _ = _save_net(tmp_path)
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device works")
        with pytest.raises(RuntimeError, match="CUDA"):
            create_predictor(Config(prefix + ".pdmodel",
                                    prefix + ".pdiparams"))


class TestHapiDeploy:
    def test_model_save_training_false_is_deployable(self, tmp_path):
        ref, port = pair(8)
        model = ptt.Model(port, inputs=[InputSpec([None, 4], "float32")])
        prefix = str(tmp_path / "hapi_deploy")
        model.save(prefix, training=False)
        x = np.random.RandomState(4).randn(3, 4).astype(np.float32)
        out = create_predictor(cpu_config(prefix)).run([x])
        np.testing.assert_allclose(out.numpy(), rout(ref, x), rtol=1e-5,
                                   atol=1e-5)

    def test_model_save_training_false_requires_inputs(self, tmp_path):
        model = ptt.Model(_PNet())
        with pytest.raises(ValueError, match="inputs"):
            model.save(str(tmp_path / "x"), training=False)


class TestFlagshipDeploy:
    def test_gpt2_tiny_save_load_parity(self, tmp_path):
        """GPT-2 tiny (embeddings, causal flash attention — one
        `paddle_tpu_torch::flash_attn` node a layer — and the tied head)
        through the artifact, batch-polymorphic: the reference's logits."""
        model, _cfg, port, tcfg = reference_tiny_model(13)
        port.eval()
        prefix = str(tmp_path / "gpt2")
        jit.save(port, prefix, input_spec=[InputSpec([None, 64], "int64")])
        ids = np.random.RandomState(6).randint(0, 1024, (2, 64)) \
            .astype(np.int64)
        ref = np.asarray(model(RT(jnp.asarray(ids))).numpy())
        loaded = jit.load(prefix, device="cpu")
        flash = [n for n in loaded.program.graph.nodes
                 if "paddle_tpu_torch.flash_attn" in str(n.target)]
        assert len(flash) == tcfg.num_layers
        np.testing.assert_allclose(loaded(torch.from_numpy(ids)).numpy(),
                                   ref, rtol=2e-4, atol=2e-4)
        out5 = loaded(torch.from_numpy(np.tile(ids, (3, 1))[:5]))
        assert tuple(out5.shape)[0] == 5


class TestQuantizedDeploy:
    def test_save_quantized_model_roundtrip(self, tmp_path):
        """QAT's save_quantized_model on the same weights and ranges: the
        loaded int8 program is the port's eager int8 model bit for bit and
        the reference's within 1e-4 (the reference's own tolerance)."""
        from paddle_tpu.slim import ImperativeQuantAware as RQAT
        from paddle_tpu_torch.slim import ImperativeQuantAware
        ref, port = pair(3)
        rq, pq = RQAT(), ImperativeQuantAware()
        rq.quantize(ref)
        pq.quantize(port)
        ref.train()
        port.train()
        x = np.random.RandomState(2).randn(6, 4).astype(np.float32)
        ref(RT(jnp.asarray(x)))
        port(torch.from_numpy(x))
        prefix = str(tmp_path / "quant")
        pq.save_quantized_model(port, prefix, input_spec=[
            InputSpec([None, 4], "float32")])
        rq.convert(ref)
        ref.eval()
        port.eval()
        out = jit.load(prefix, device="cpu")(torch.from_numpy(x))
        assert torch.equal(out, port(torch.from_numpy(x)))
        np.testing.assert_allclose(out.numpy(), rout(ref, x), rtol=1e-4,
                                   atol=1e-4)


class TestInferenceAuxSurface:
    def test_enums_helpers_and_pool(self, tmp_path):
        from paddle_tpu import inference as rinfer
        from paddle_tpu_torch import inference as infer
        for dt in ("float32", "bfloat16", "int8"):
            assert infer.get_num_bytes_of_data_type(dt) == \
                rinfer.get_num_bytes_of_data_type(dt)
        assert "paddle_tpu_torch" in infer.get_version()
        assert infer.PrecisionType.Int8 == rinfer.PrecisionType.Int8 == 2
        assert infer.DataType.FLOAT32 == rinfer.DataType.FLOAT32
        prefix, x, ref = _save_net(tmp_path)
        pool = PredictorPool(cpu_config(prefix), 2)
        assert len(pool) == 2
        assert pool.retrive(0)._translated is pool.retrive(1)._translated
        for i in range(2):
            p = pool.retrive(i)  # the reference's spelling
            p.get_input_handle(p.get_input_names()[0]).copy_from_cpu(x)
            p.run()
            out = p.get_output_handle(p.get_output_names()[0]).copy_to_cpu()
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError):
            PredictorPool(cpu_config(prefix), 0)


def test_bf16_artifact_roundtrip(tmp_path):
    """A bfloat16 model: its weights go through the npz as uint8 views
    with a `dt:` sidecar and come back bit for bit; the served output is
    the eager bf16 model's and the reference's within 1e-2."""
    paddle.seed(0)
    ref = rnn.Sequential(rnn.Linear(4, 8), rnn.ReLU(), rnn.Linear(8, 2))
    port = pnn.Sequential(pnn.Linear(4, 8), pnn.ReLU(), pnn.Linear(8, 2))
    carry(ref, port)
    ref.eval()
    ref.to(dtype="bfloat16")
    port.eval()
    port.to(dtype="bfloat16")
    prefix = str(tmp_path / "m_bf16")
    jit.save(port, prefix, input_spec=[InputSpec([-1, 4], "bfloat16")])
    served = jit.load(prefix, device="cpu")
    for k, v in port.named_parameters():
        assert torch.equal(served._params[k], v.detach())
    x = torch.ones(2, 4, dtype=torch.bfloat16)
    out = served(x)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, port(x))
    want = np.asarray(ref(paddle.to_tensor(x.float().numpy()).astype(
        "bfloat16")).numpy()).astype(np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, atol=1e-2)


def test_loaded_artifact_weights_are_device_committed(tmp_path):
    """jit.load puts the weights on the device ONCE: the loaded layer's
    parameters are tensors there, and calls reuse the same tensors."""
    net = pnn.Sequential(pnn.Linear(4, 8), pnn.ReLU(), pnn.Linear(8, 2))
    net.eval()
    prefix = str(tmp_path / "m")
    jit.save(net, prefix, input_spec=[InputSpec([None, 4], "float32")])
    loaded = jit.load(prefix, device="cpu")
    leaves = list(loaded._params.values())
    assert leaves and all(torch.is_tensor(v) and v.device.type == "cpu"
                          for v in leaves)
    ptrs = [v.data_ptr() for v in leaves]
    loaded(torch.zeros(3, 4))
    loaded(torch.zeros(5, 4))
    assert [v.data_ptr() for v in loaded._params.values()] == ptrs


def test_inputs_the_model_makes_equal_share_one_dim(tmp_path):
    """ROADMAP §C 52: two free batch dims the model forces equal (ids and
    mask of a padded encoder) export with Dim.AUTO as one symbol, and the
    loaded program takes any batch. The reference gives each free dim
    its own symbol in one scope (`_symbolic_dims`)."""
    class Enc(pnn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = pnn.Embedding(50, 32)
            self.enc = pnn.TransformerEncoder(pnn.TransformerEncoderLayer(
                32, 1, 64, dropout=0.0), 1)

        def forward(self, ids, mask):
            h = self.embed(ids)
            bias = (1.0 - ptt.cast(mask, "float32"))[:, None, None, :] * -1e4
            return self.enc(h, bias).mean(1)

    net = Enc().eval()
    prefix = str(tmp_path / "enc")
    jit.save(net, prefix, input_spec=[InputSpec([None, 32], "int64"),
                                      InputSpec([None, 32], "int64")])
    loaded = jit.load(prefix, device="cpu")
    for b in (1, 3, 8):
        rs = np.random.RandomState(b)
        ids = torch.from_numpy(rs.randint(1, 50, (b, 32)))
        mask = (torch.arange(32)[None] < torch.from_numpy(
            rs.randint(4, 33, (b, 1)))).long()
        np.testing.assert_allclose(loaded(ids, mask).numpy(),
                                   net(ids, mask).detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
