"""CPU twins of the port's `paddle.save` / `paddle.load`
(`paddle_tpu_torch.framework.io`) against the reference's: every case of
`test_io_checkpoint.py::TestCheckpoint`, and the reference's own files
read by the port — a layer's state_dict, an optimizer's (with its
scheduler and step), nested containers, and bfloat16 tensors (written
by the reference as ml_dtypes arrays) — bit for bit (a forward on the
loaded weights within 1e-6: the two matmuls round differently). The port's
bfloat16 files round-trip bit for bit and load as numpy without
ml_dtypes. ROADMAP §C 36 pins the one-way compatibility: the reference
does not read the port's files (it returns the port's payload objects
as they are).
"""
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as rnn
import paddle_tpu.optimizer as ropt

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.framework import io as pio
from paddle_tpu_torch.nn.layer.layers import load_reference_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _seq(mod):
    return mod.Sequential(mod.Linear(4, 8), mod.ReLU(), mod.Linear(8, 2))


def test_save_load_state_dict(tmp_path):
    net = _seq(pnn)
    path = str(tmp_path / "model.pdparams")
    ptt.save(net.state_dict(), path)
    net2 = _seq(pnn)
    net2.set_state_dict(ptt.load(path))
    x = torch.from_numpy(np.random.rand(2, 4).astype(np.float32))
    np.testing.assert_array_equal(net(x).detach().numpy(),
                                  net2(x).detach().numpy())


def test_save_load_optimizer(tmp_path):
    p = torch.nn.Parameter(torch.ones(3))
    o = ptt.optimizer.Adam(learning_rate=0.1, parameters=[p])
    (p * p).sum().backward()
    o.step()
    path = str(tmp_path / "opt.pdopt")
    ptt.save(o.state_dict(), path)
    loaded = ptt.load(path)
    assert loaded["@step"] == 1
    assert set(loaded) == set(o.state_dict())
    for k, v in o.state_dict().items():
        if torch.is_tensor(v):
            assert torch.equal(loaded[k], v)


def test_full_train_state_resume(tmp_path):
    """params + optimizer + scheduler + rng, saved and restored."""
    net = pnn.Linear(2, 2)
    sched = ptt.optimizer.lr.StepDecay(0.1, step_size=10)
    o = ptt.optimizer.Momentum(learning_rate=sched,
                               parameters=net.named_parameters())
    x = torch.from_numpy(np.random.rand(4, 2).astype(np.float32))
    for _ in range(3):
        net(x).sum().backward()
        o.step()
        o.clear_grad()
        sched.step()
    state = {"model": net.state_dict(), "opt": o.state_dict(),
             "rng": ptt.get_rng_state()}
    ptt.save(state, str(tmp_path / "ckpt"))
    restored = ptt.load(str(tmp_path / "ckpt"))
    net2 = pnn.Linear(2, 2)
    net2.set_state_dict(restored["model"])
    o2 = ptt.optimizer.Momentum(
        learning_rate=ptt.optimizer.lr.StepDecay(0.1, step_size=10),
        parameters=net2.named_parameters())
    o2.set_state_dict(restored["opt"])
    ptt.set_rng_state(restored["rng"])
    assert o2._step_count == 3
    assert o2.get_lr() == o.get_lr()
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)


def test_jit_save_of_a_layer_raises(tmp_path):
    """The twin of test_io_checkpoint.py::TestIO::test_jit_save_load
    (it pinned a raise until jit.save of any layer was ported): a Linear
    saved with InputSpec([None, 3]) loads with no model class and gives
    the reference layer's outputs on the same weights (1e-6), at two
    batch sizes."""
    from paddle_tpu_torch.static import InputSpec
    paddle.seed(2)
    ref = rnn.Linear(3, 2)
    net = pnn.Linear(3, 2)
    load_reference_state(net, {k: np.asarray(v.numpy())
                               for k, v in ref.state_dict().items()})
    path = str(tmp_path / "jit_model")
    ptt.jit.save(net, path, input_spec=[InputSpec([None, 3])])
    loaded = ptt.jit.load(path, device="cpu")
    for n in (4, 9):
        x = np.random.RandomState(n).randn(n, 3).astype(np.float32)
        want = np.asarray(ref(paddle.to_tensor(x)).numpy())
        np.testing.assert_allclose(loaded(torch.from_numpy(x)).numpy(),
                                   want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64"])
def test_reads_the_reference_state_dict(tmp_path, dtype):
    paddle.seed(4)
    ref = _seq(rnn)
    state = {k: (v.astype(dtype) if dtype != "float32" else v)
             for k, v in ref.state_dict().items()}
    path = str(tmp_path / "ref.pdparams")
    paddle.save({"net": state, "meta": ["x", 3, (1.5, None)],
                 "step": 7}, path)
    got = ptt.load(path)
    assert got["meta"] == ["x", 3, (1.5, None)] and got["step"] == 7
    for k, v in state.items():
        t = got["net"][k]
        want = np.asarray(v.numpy())
        # the reference holds int64 as int32 (JAX without x64)
        assert str(t.dtype) == "torch." + str(want.dtype)
        if dtype == "bfloat16":  # bits: numpy here has ml_dtypes
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), want.astype(
                t.numpy().dtype))
    as_np = ptt.load(path, return_numpy=True)["net"]
    for k, v in state.items():
        a = as_np[k]
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(
            a, np.asarray(v.numpy()).astype(a.dtype))


def test_reads_the_reference_model_and_optimizer(tmp_path):
    paddle.seed(5)
    ref = _seq(rnn)
    sched = ropt.lr.StepDecay(0.1, step_size=2)
    o = ropt.Adam(sched, parameters=ref.parameters())
    x = paddle.to_tensor(f32(3, 4))
    for _ in range(2):
        ref(x).sum().backward()
        o.step()
        o.clear_grad()
        sched.step()
    paddle.save(ref.state_dict(), str(tmp_path / "m.pdparams"))
    paddle.save(o.state_dict(), str(tmp_path / "m.pdopt"))
    port = _seq(pnn)
    port.set_state_dict(ptt.load(str(tmp_path / "m.pdparams")))
    for (k, a), b in zip(port.state_dict().items(),
                         ref.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()), k)
    np.testing.assert_allclose(
        port(torch.from_numpy(f32(3, 4))).detach().numpy(),
        np.asarray(ref(x).numpy()), rtol=1e-6, atol=1e-7)
    opt_state = ptt.load(str(tmp_path / "m.pdopt"))
    want = o.state_dict()
    assert opt_state["@step"] == want["@step"] == 2
    assert opt_state["LR_Scheduler"] == want["LR_Scheduler"]
    for k, v in want.items():
        if hasattr(v, "numpy") and not isinstance(v, dict):
            np.testing.assert_array_equal(opt_state[k].numpy(),
                                          np.asarray(v.numpy()))


def test_model_load_reads_a_reference_checkpoint(tmp_path):
    paddle.seed(6)
    ref = _seq(rnn)
    rmodel = paddle.Model(ref)
    rmodel.prepare(ropt.Adam(0.01, parameters=ref.parameters()),
                   rnn.CrossEntropyLoss())
    rmodel.save(str(tmp_path / "ck"))
    port = _seq(pnn)
    pmodel = ptt.Model(port)
    pmodel.prepare(ptt.optimizer.Adam(0.01, parameters=port.parameters()),
                   pnn.CrossEntropyLoss())
    pmodel.load(str(tmp_path / "ck"))
    for a, b in zip(port.parameters(), ref.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      np.asarray(b.numpy()))
    x = f32(5, 4)
    np.testing.assert_allclose(
        pmodel.predict_batch([torch.from_numpy(x)]).numpy(),
        np.asarray(rmodel.predict_batch([paddle.to_tensor(x)]).numpy()),
        rtol=1e-6, atol=1e-7)


def test_bfloat16_round_trip_and_numpy_without_ml_dtypes(tmp_path):
    t = torch.from_numpy(f32(3, 5)).to(torch.bfloat16)
    path = str(tmp_path / "bf.pdparams")
    ptt.save({"w": t, "n": np.arange(3)}, path)
    with open(path, "rb") as f:
        raw = f.read()
    assert b"ml_dtypes" not in raw
    got = ptt.load(path)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)
    np.testing.assert_array_equal(got["n"], np.arange(3))
    as_np = ptt.load(path, return_numpy=True)["w"]
    assert as_np.dtype == np.float32
    np.testing.assert_array_equal(as_np, t.float().numpy())


def test_reference_does_not_read_the_port_files(tmp_path):
    """ROADMAP §C 36: one-way compatibility, pinned."""
    path = str(tmp_path / "port.pdparams")
    ptt.save({"w": torch.ones(2)}, path)
    got = paddle.load(path)["w"]
    assert type(got) is pio._TensorPayload
    assert not isinstance(got, paddle.Tensor)


def test_async_save(tmp_path):
    path = str(tmp_path / "a" / "async.pdparams")
    t = torch.arange(6.0)
    pio.async_save({"t": t}, path)
    t.add_(1.0)  # the snapshot was taken at the call
    pio.wait_save()
    assert not os.path.exists(path + ".tmp")
    assert torch.equal(ptt.load(path)["t"], torch.arange(6.0))


def test_load_lands_on_the_default_device(tmp_path, monkeypatch):
    path = str(tmp_path / "d.pdparams")
    ptt.save({"w": torch.ones(2)}, path)
    assert ptt.load(path)["w"].device.type == "cpu"
    with pdevice.device_guard("gpu"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ptt.load(path)
        assert ptt.load(path, return_numpy=True)["w"].tolist() == [1, 1]


def test_unreadable_ml_dtype_raises(tmp_path):
    """A pickle naming ml_dtypes.int4 (no bits mapping) is refused."""
    path = str(tmp_path / "bad")
    with open(path, "wb") as f:
        f.write(b"\x80\x04\x95\x13\x00\x00\x00\x00\x00\x00\x00\x8c\tml_dtypes"
                b"\x94\x8c\x04int4\x94\x93\x94.")
    with pytest.raises(pickle.UnpicklingError, match="int4"):
        ptt.load(path)
