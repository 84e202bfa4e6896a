"""CPU twins of the port's `paddle.Model` and its callbacks
(`paddle_tpu_torch.hapi`) against the reference's `paddle_tpu.Model`:
the twin of `test_io_checkpoint.py::TestHapiModel::test_fit_evaluate` and
of `test_observability.py::TestTelemetryCallback::
test_fit_populates_step_histograms`.

Both sides train the same network (the reference's weights carried over
by `load_reference_state`) on the same numpy data, batched by each
side's DataLoader under one `np.random.seed` (so the same shuffle):
`fit` / `evaluate` / `predict` against the reference's fused (jit) step,
for the port's fused step (`jit=True`) and its eager loop (`jit=False`);
the gradients of one step (SGD at lr 1: the update is the gradient); the
port's two paths against each other; every callback against the
reference's callback on the same run; the fused step's fallback
warning; `save(training=False)` raising.

Tolerances (PERF.md §2's parity policy): each step's loss relative
1e-4; gradients 1e-3 of their largest magnitude; parameters 2 · lr ·
steps absolute; accuracies equal unless a sample's two logits lie within
1e-4 of each other on either side; predictions 1e-4. The port's fused
and eager paths: 1e-6 relative.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as rnn
import paddle_tpu.optimizer as ropt
from paddle_tpu.hapi import callbacks as rcb
from paddle_tpu.io import TensorDataset as RTensorDataset
from paddle_tpu.metric import Accuracy as RAccuracy

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.hapi import callbacks as pcb
from paddle_tpu_torch.io import TensorDataset as PTensorDataset
from paddle_tpu_torch.metric import Accuracy as PAccuracy
from paddle_tpu_torch.nn.layer.layers import load_reference_state

torch.set_num_threads(1)

LR = 0.01
LOSS_REL, GRAD_REL, TIE = 1e-4, 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def data(n=64, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    y = (x.sum(1, keepdims=True) > 0).astype(np.int64)
    return x, y


def nets():
    """(reference net, port net) with the same weights."""
    paddle.seed(3)
    ref = rnn.Sequential(rnn.Linear(4, 16), rnn.ReLU(), rnn.Linear(16, 2))
    port = pnn.Sequential(pnn.Linear(4, 16), pnn.ReLU(), pnn.Linear(16, 2))
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


class Recorder:
    """Each train step's loss, accuracy and parameters."""

    def __init__(self, cb_base):
        rec = self

        class _Cb(cb_base):
            def on_batch_end(self, mode, step, logs=None):
                loss, metrics = logs if isinstance(logs, tuple) \
                    else (logs, None)
                rec.losses.append(loss[0])
                rec.accs.append(None if metrics is None else metrics["acc"])
                rec.params.append([np.array(p.numpy() if not
                                            torch.is_tensor(p) else
                                            p.detach().numpy())
                                   for p in self.model.parameters()])

        self.cb = _Cb()
        self.losses, self.accs, self.params = [], [], []


def fit_ref(ref, x, y, epochs=2, opt="adam", **kw):
    model = paddle.Model(ref)
    o = ropt.Adam(LR, parameters=ref.parameters()) if opt == "adam" \
        else ropt.SGD(1.0, parameters=ref.parameters())
    model.prepare(o, rnn.CrossEntropyLoss(), RAccuracy())
    rec = Recorder(rcb.Callback)
    np.random.seed(7)
    model.fit(RTensorDataset([x, y]), batch_size=16, epochs=epochs,
              verbose=0, callbacks=[rec.cb], **kw)
    return model, rec


def fit_port(port, x, y, jit, epochs=2, opt="adam", **kw):
    model = ptt.Model(port)
    o = ptt.optimizer.Adam(LR, parameters=port.parameters()) \
        if opt == "adam" else ptt.optimizer.SGD(1.0,
                                                parameters=port.parameters())
    model.prepare(o, pnn.CrossEntropyLoss(), PAccuracy(), jit=jit)
    rec = Recorder(pcb.Callback)
    np.random.seed(7)
    model.fit(PTensorDataset([x, y]), batch_size=16, epochs=epochs,
              verbose=0, callbacks=[rec.cb], **kw)
    return model, rec


def near_tie(*logit_sets):
    return any(np.min(np.abs(lg[:, 0] - lg[:, 1])) < TIE
               for lg in logit_sets)


def check_steps(r, p, steps):
    assert len(r.losses) == len(p.losses) == steps
    for i, (a, b) in enumerate(zip(r.losses, p.losses)):
        assert abs(a - b) <= LOSS_REL * abs(a), (i, a, b)
    for i, (pa, pb) in enumerate(zip(r.params, p.params)):
        for a, b in zip(pa, pb):
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=2 * LR * (i + 1) + 1e-6)


@pytest.mark.parametrize("jit", [True, False], ids=["fused", "eager"])
def test_fit_evaluate_predict_match_reference(jit):
    x, y = data()
    ref, port = nets()
    rmodel, r = fit_ref(ref, x, y)
    pmodel, p = fit_port(port, x, y, jit)
    check_steps(r, p, 8)
    for a, b in zip(r.accs, p.accs):
        if a != b:
            assert near_tie(np.asarray(ref(paddle.to_tensor(x)).numpy()))
    rres = rmodel.evaluate(RTensorDataset([x, y]), batch_size=16, verbose=0)
    pres = pmodel.evaluate(PTensorDataset([x, y]), batch_size=16, verbose=0)
    assert abs(rres["loss"][0] - pres["loss"][0]) <= LOSS_REL * abs(
        rres["loss"][0])
    rout = rmodel.predict(RTensorDataset([x]), batch_size=16,
                          stack_outputs=True)[0]
    pout = pmodel.predict(PTensorDataset([x]), batch_size=16,
                          stack_outputs=True)[0]
    np.testing.assert_allclose(pout, rout, rtol=1e-4, atol=1e-4)
    if rres["acc"] != pres["acc"]:
        assert near_tie(np.asarray(rout), pout)
    assert pres["acc"] > 0.8  # the reference test's bar


@pytest.mark.parametrize("jit", [True, False], ids=["fused", "eager"])
def test_one_step_gradients_match_reference(jit):
    """SGD at lr 1 over one batch: p0 - p1 is the gradient."""
    x, y = data(16, seed=1)
    ref, port = nets()
    p0 = [p.detach().numpy().copy() for p in port.parameters()]
    _, r = fit_ref(ref, x, y, epochs=1, opt="sgd")
    _, p = fit_port(port, x, y, jit, epochs=1, opt="sgd")
    assert abs(r.losses[0] - p.losses[0]) <= LOSS_REL * abs(r.losses[0])
    g_ref = [a - b for a, b in zip(p0, r.params[0])]
    g_port = [a - b for a, b in zip(p0, p.params[0])]
    scale = max(np.abs(g).max() for g in g_ref)
    for a, b in zip(g_ref, g_port):
        assert np.abs(a - b).max() <= GRAD_REL * scale


def test_fused_step_equals_eager_loop():
    x, y = data()
    _, port_a = nets()
    _, port_b = nets()
    _, a = fit_port(port_a, x, y, True)
    _, b = fit_port(port_b, x, y, False)
    np.testing.assert_allclose(b.losses, a.losses, rtol=1e-6)
    for pa, pb in zip(a.params, b.params):
        for u, v in zip(pa, pb):
            np.testing.assert_allclose(v, u, rtol=1e-6, atol=1e-7)


def test_fit_with_worker_processes_equals_in_process():
    """fit(num_workers=2) over one epoch: the same batches, so the same
    steps. (Starting workers draws their base seed from numpy's global
    generator, as the reference does, so a later epoch's shuffle
    differs from the in-process loader's.)"""
    x, y = data()
    _, port_a = nets()
    _, port_b = nets()
    _, a = fit_port(port_a, x, y, True, epochs=1)
    _, b = fit_port(port_b, x, y, True, epochs=1, num_workers=2)
    assert a.losses == b.losses
    for pa, pb in zip(a.params, b.params):
        for u, v in zip(pa, pb):
            np.testing.assert_array_equal(u, v)


def test_fused_step_fallback_warns_once(monkeypatch):
    """An optimizer the fused step cannot drive: one warning naming the
    exception, then the eager loop (equal to jit=False)."""
    x, y = data()
    _, port_a = nets()
    _, port_b = nets()

    def no_functional(self, params):
        raise NotImplementedError("no functional rule for this optimizer")

    monkeypatch.setattr(ptt.optimizer.Adam, "functional_init",
                        no_functional)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, a = fit_port(port_a, x, y, True)
    msgs = [str(w.message) for w in caught
            if "fused train step" in str(w.message)]
    assert msgs == ["Model: the fused train step failed, training eagerly "
                    "from now on: NotImplementedError: no functional rule "
                    "for this optimizer"]
    assert model._use_jit is False
    _, b = fit_port(port_b, x, y, False)
    np.testing.assert_allclose(a.losses, b.losses, rtol=0)


def test_save_training_false_raises(tmp_path):
    """save(training=False) needs Model(inputs=...); with them it writes
    the jit.save artifact (it raised until jit.save of any layer was
    ported), which predicts as the network does."""
    from paddle_tpu_torch.static import InputSpec
    _, port = nets()
    model = ptt.Model(port)
    with pytest.raises(ValueError, match="needs Model"):
        model.save("unused", training=False)
    model = ptt.Model(port, inputs=[InputSpec([None, 4], "float32")])
    model.save(str(tmp_path / "deploy"), training=False)
    x = torch.from_numpy(data(5)[0])
    loaded = ptt.jit.load(str(tmp_path / "deploy"), device="cpu")
    assert torch.equal(loaded(x), port(x))


def test_save_load_round_trip_predicts_bitwise(tmp_path):
    x, y = data()
    _, port = nets()
    model, _ = fit_port(port, x, y, True, epochs=1)
    model.save(str(tmp_path / "ck"))
    assert sorted(os.listdir(tmp_path)) == ["ck.pdopt", "ck.pdparams"]
    _, fresh = nets()
    other = ptt.Model(fresh)
    other.prepare(ptt.optimizer.Adam(LR, parameters=fresh.parameters()),
                  pnn.CrossEntropyLoss())
    other.load(str(tmp_path / "ck"))
    a = model.predict(PTensorDataset([x]), batch_size=16,
                      stack_outputs=True)[0]
    b = other.predict(PTensorDataset([x]), batch_size=16,
                      stack_outputs=True)[0]
    np.testing.assert_array_equal(a, b)


# ---- callbacks: the same run with the same callback on both sides ------

def _run_with(cb_ref, cb_port, epochs=4, **kw):
    """No metrics: an epoch's logs are then {"loss": float}, which every
    callback reads (with metrics the reference's EarlyStopping and
    VisualDL cannot read them)."""
    x, y = data()
    ref, port = nets()
    rm = paddle.Model(ref)
    rm.prepare(ropt.Adam(kw.pop("lr_ref", LR), parameters=ref.parameters()),
               rnn.CrossEntropyLoss())
    pm = ptt.Model(port)
    pm.prepare(ptt.optimizer.Adam(kw.pop("lr_port", LR),
                                  parameters=port.parameters()),
               pnn.CrossEntropyLoss())
    np.random.seed(7)
    hr = rm.fit(RTensorDataset([x, y]), batch_size=16, epochs=epochs,
                verbose=0, callbacks=[cb_ref])
    np.random.seed(7)
    hp = pm.fit(PTensorDataset([x, y]), batch_size=16, epochs=epochs,
                verbose=0, callbacks=[cb_port])
    return (rm, hr), (pm, hp)


def test_callback_early_stopping():
    """min_delta 1.0 never improves after the first epoch: both stop
    after patience + 1 epochs."""
    (rm, hr), (pm, hp) = _run_with(
        rcb.EarlyStopping("loss", patience=1, min_delta=1.0),
        pcb.EarlyStopping("loss", patience=1, min_delta=1.0), epochs=5)
    assert len(hr) == len(hp) == 2
    assert rm.stop_training and pm.stop_training


def test_callback_reduce_lr_on_plateau():
    (rm, _), (pm, _) = _run_with(
        rcb.ReduceLROnPlateau("loss", factor=0.5, patience=1,
                              min_delta=10.0, verbose=0),
        pcb.ReduceLROnPlateau("loss", factor=0.5, patience=1,
                              min_delta=10.0, verbose=0))
    # best at epoch 0, then a reduction at each of epochs 1, 2, 3
    assert float(rm._optimizer.get_lr()) == pm._optimizer.get_lr() == \
        LR * 0.125


def test_callback_lr_scheduler():
    paddle.seed(3)
    rs = ropt.lr.StepDecay(0.01, step_size=3, gamma=0.5)
    ps = ptt.optimizer.lr.StepDecay(0.01, step_size=3, gamma=0.5)
    (rm, _), (pm, _) = _run_with(rcb.LRScheduler(), pcb.LRScheduler(),
                                 epochs=2, lr_ref=rs, lr_port=ps)
    assert rs.last_epoch == ps.last_epoch == 8
    assert float(rs()) == pytest.approx(ps(), rel=1e-7)


def test_callback_model_checkpoint(tmp_path):
    _run_with(rcb.ModelCheckpoint(2, str(tmp_path / "r")),
              pcb.ModelCheckpoint(2, str(tmp_path / "p")))
    assert sorted(os.listdir(tmp_path / "r")) == \
        sorted(os.listdir(tmp_path / "p")) == [
            "0.pdopt", "0.pdparams", "2.pdopt", "2.pdparams"]
    got = ptt.load(str(tmp_path / "p" / "2.pdparams"))
    want = ptt.load(str(tmp_path / "r" / "2.pdparams"))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=2 * LR * 12 + 1e-6)


def test_callback_visualdl(tmp_path):
    _run_with(rcb.VisualDL(str(tmp_path / "r")),
              pcb.VisualDL(str(tmp_path / "p")), epochs=3)
    rows = {}
    for side in "rp":
        with open(tmp_path / side / "scalars.jsonl") as f:
            rows[side] = [json.loads(line) for line in f]
    assert [(r["tag"], r["step"]) for r in rows["r"]] == \
        [(r["tag"], r["step"]) for r in rows["p"]] == [
            ("train", 10), ("train", 12)]
    assert rows["r"][0]["value"] == pytest.approx(rows["p"][0]["value"],
                                                  rel=LOSS_REL)


def test_callback_progbar_logger():
    import logging

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__()
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    kept = {}
    for root in ("paddle_tpu", "paddle_tpu_torch"):
        kept[root] = Keep()
        logging.getLogger(root).addHandler(kept[root])
    try:
        _run_with(rcb.ProgBarLogger(log_freq=2, verbose=2),
                  pcb.ProgBarLogger(log_freq=2, verbose=2), epochs=1)
    finally:
        for root, h in kept.items():
            logging.getLogger(root).removeHandler(h)
    ref, port = kept["paddle_tpu"].messages, kept["paddle_tpu_torch"].messages
    assert len(ref) == len(port) == 3  # steps 0 and 2, the epoch line
    def head(m):  # the step line up to the loss, the epoch line's start
        return m.split(":")[0].split(" done in")[0]

    assert [head(m) for m in ref] == [head(m) for m in port]


def test_fit_populates_step_histograms():
    """The twin of the reference's TelemetryCallback case."""
    from paddle_tpu_torch.observability import metrics as M
    from paddle_tpu_torch.observability import tracing as T

    M.enable()
    T.enable()
    M.reset()
    T.reset()
    try:
        x = np.random.RandomState(0).rand(8, 4).astype(np.float32)
        y = (x @ np.ones((4, 1), np.float32)).astype(np.float32)
        model = ptt.Model(pnn.Linear(4, 1))
        model.prepare(ptt.optimizer.SGD(
            0.01, parameters=model.parameters()), pnn.MSELoss())
        model.fit(list(zip(x, y)), batch_size=4, epochs=1, verbose=0,
                  callbacks=[pcb.TelemetryCallback()])
        snap = M.snapshot()
        assert snap["train_steps_total"]["series"][0]["value"] == 2
        assert snap["train_step_seconds"]["series"][0]["count"] == 2
        assert snap["train_loss"]["series"][0]["count"] == 2
        steps = [e for e in T.events() if e["name"] == "train_step"]
        assert len(steps) == 2
    finally:
        M.disable()
        T.disable()
        M.reset()
        T.reset()


def test_fit_attaches_telemetry_when_enabled():
    from paddle_tpu_torch.observability import metrics as M
    M.enable()
    M.reset()
    try:
        x, y = data(32)
        _, port = nets()
        fit_port(port, x, y, True, epochs=1)
        assert M.snapshot()["train_steps_total"]["series"][0]["value"] == 2
    finally:
        M.disable()
        M.reset()


def test_high_level_names_bind_lazily():
    """`import paddle_tpu_torch` and its serving path load none of this
    slice's namespaces; each binds at first use."""
    import subprocess
    import sys
    lazy = ["io", "hapi", "metric", "framework", "distribution", "compat"]
    code = ("import sys, paddle_tpu_torch as p\n"
            "import paddle_tpu_torch.inference\n"
            f"loaded = [m for m in {lazy!r}\n"
            "          if 'paddle_tpu_torch.' + m in sys.modules]\n"
            "assert not loaded, loaded\n"
            "assert p.Model and p.save and p.load and p.flops and p.summary\n"
            "assert p.io.DataLoader and p.metric.Accuracy and p.callbacks\n"
            "assert p.distribution.Normal and p.regularizer.L2Decay\n"
            "assert p.hapi.Model is p.Model and p.framework.save is p.save\n"
            "assert p.elementwise_add and p.reduce_sum and p.rank\n"
            "assert p.in_dynamic_mode() and p.cond and p.L1Decay\n"
            "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.startswith("OK"), r.stderr
