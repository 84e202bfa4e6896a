"""CPU twins of the port's `paddle.metric` (`paddle_tpu_torch.metric`)
against the reference's `paddle_tpu.metric`: every metric class and
function on the same seeded arrays — counts and accumulations exactly
(they are host numpy on both sides), the float results within 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.metric as rm

import paddle_tpu_torch as ptt
import paddle_tpu_torch.metric as pm
from paddle_tpu_torch import device as pdevice

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x.numpy())


def batches(seed, n=3, b=16, c=5):
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, c).astype(np.float32),
             rs.randint(0, c, (b, 1)).astype(np.int64)) for _ in range(n)]


@pytest.mark.parametrize("topk", [1, (1, 3)])
def test_accuracy_metric(topk):
    r, p = rm.Accuracy(topk=topk), pm.Accuracy(topk=topk)
    assert r.name() == p.name() == "acc"
    for x, y in batches(0):
        cr = r.compute(paddle.to_tensor(x), paddle.to_tensor(y))
        cp = p.compute(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_array_equal(np.asarray(cp), np.asarray(cr))
        assert p.update(cp) == r.update(cr)
    assert p.accumulate() == r.accumulate()
    assert (p.total, p.count) == (r.total, r.count)
    p.reset()
    assert p.count == [0] * len(p.count)


@pytest.mark.parametrize("name", ["Precision", "Recall"])
def test_precision_recall(name):
    rs = np.random.RandomState(1)
    r, p = getattr(rm, name)(), getattr(pm, name)()
    for _ in range(3):
        preds = rs.rand(32, 1).astype(np.float32)
        labels = rs.randint(0, 2, (32, 1)).astype(np.int64)
        r.update(paddle.to_tensor(preds), paddle.to_tensor(labels))
        p.update(torch.from_numpy(preds), labels)
    assert p.accumulate() == r.accumulate()
    assert p.name() == r.name()


@pytest.mark.parametrize("two_col", [False, True])
def test_auc(two_col):
    rs = np.random.RandomState(2)
    r, p = rm.Auc(num_thresholds=255), pm.Auc(num_thresholds=255)
    for _ in range(3):
        score = rs.rand(64).astype(np.float32)
        preds = np.stack([1 - score, score], 1) if two_col else score
        labels = (rs.rand(64) < score).astype(np.int64)
        r.update(paddle.to_tensor(preds), paddle.to_tensor(labels))
        p.update(torch.from_numpy(preds), torch.from_numpy(labels))
    np.testing.assert_array_equal(p._stat_pos, r._stat_pos)
    np.testing.assert_array_equal(p._stat_neg, r._stat_neg)
    assert abs(p.accumulate() - r.accumulate()) <= 1e-6
    assert pm.Auc().accumulate() == 0.0


@pytest.mark.parametrize("k", [1, 2, 4])
def test_accuracy_function(k):
    for x, y in batches(3):
        got = pm.accuracy(torch.from_numpy(x), torch.from_numpy(y), k=k)
        want = rm.accuracy(paddle.to_tensor(x), paddle.to_tensor(y), k=k)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - float(want.numpy())) <= 1e-6


@pytest.mark.parametrize("scheme,types", [("IOB", 3), ("IOE", 2),
                                          ("IOBES", 2), ("plain", 4)])
def test_chunk_eval(scheme, types):
    rs = np.random.RandomState(4)
    n_states = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    hi = n_states * types + 1  # one tag past the chunks: outside
    pred = rs.randint(0, hi, (3, 12))
    gold = np.where(rs.rand(3, 12) < 0.7, pred, rs.randint(0, hi, (3, 12)))
    lens = np.array([12, 9, 5])
    for kw in ({}, {"seq_length": lens}, {"excluded_chunk_types": [0]}):
        want = rm.chunk_eval(paddle.to_tensor(pred), paddle.to_tensor(gold),
                             scheme, types, **{
                                 k: (paddle.to_tensor(v) if k == "seq_length"
                                     else v) for k, v in kw.items()})
        got = pm.chunk_eval(torch.from_numpy(pred), torch.from_numpy(gold),
                            scheme, types, **{
                                k: (torch.from_numpy(v) if k == "seq_length"
                                    else v) for k, v in kw.items()})
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)
        assert [a.dtype for a in got] == [torch.float32] * 3 + \
            [torch.int64] * 3


def test_mean_iou():
    rs = np.random.RandomState(5)
    pred = rs.randint(0, 4, (2, 8, 8))
    label = rs.randint(0, 5, (2, 8, 8))
    got = pm.mean_iou(torch.from_numpy(pred), torch.from_numpy(label), 5)
    want = rm.mean_iou(paddle.to_tensor(pred), paddle.to_tensor(label), 5)
    assert abs(float(got[0]) - float(want[0].numpy())) <= 1e-6
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_metric_base_and_namespace():
    class Mine(pm.Metric):
        pass

    assert Mine().name() == "mine"
    assert pm.Metric(name="x").compute(1, 2) == (1, 2)
    assert ptt.metric.metrics is pm
    assert sorted(pm.__all__) == sorted(
        ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
         "chunk_eval", "mean_iou"])
