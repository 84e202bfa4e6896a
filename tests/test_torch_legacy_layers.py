"""CPU twins of the port's fluid-era layers and decoding
(`paddle_tpu_torch.nn.layer.legacy`, `nn.functional.legacy`), its compat
names (`paddle_tpu_torch.compat` and the `tensor` namespace) and
`flops` / `summary`, against the reference's.

Every layer class runs on the reference's weights (carried by
`load_reference_state`) and the same seeded inputs; `NCELoss`'s
negatives are the port's draws, handed to the reference in place of
its own. `BeamSearchDecoder` + `dynamic_decode` over an `LSTMCell`
(beam 4) give the reference's tokens exactly. The compat names give
the reference's values on the same arrays, `flops` and `summary` its
totals.

Tolerances: outputs rtol 1e-5, atol 1e-6 (float32); ids, counts and
totals exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as rnn
import paddle_tpu.nn.functional as RF

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.core import rng as prng
from paddle_tpu_torch.nn.layer.layers import load_reference_state

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def pair(name, *args, **kw):
    """(reference layer, port layer) with the reference's weights."""
    paddle.seed(1)
    ref = getattr(rnn, name)(*args, **kw)
    port = getattr(pnn, name)(*args, **kw)
    assert list(port.state_dict()) == list(ref.state_dict())
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    return ref, port


def run(ref, port, *inputs, ints=()):
    r_in = [paddle.to_tensor(a) for a in inputs]
    p_in = [torch.from_numpy(a) for a in inputs]
    return ref(*r_in), port(*p_in)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kw", [
    dict(pool_size=2, pool_type="max", pool_stride=2),
    dict(pool_size=3, pool_type="avg", pool_stride=1, pool_padding=1),
    dict(pool_type="avg", global_pooling=True),
    dict(pool_type="max", global_pooling=True)],
    ids=["max", "avg_pad", "global_avg", "global_max"])
def test_pool2d(kw):
    close(*reversed(run(*pair("Pool2D", **kw), f32(2, 3, 6, 6))))


def test_adaptive_max_pool3d():
    close(*reversed(run(*pair("AdaptiveMaxPool3D", (2, 3, 2)),
                        f32(2, 3, 4, 6, 5))))


@pytest.mark.parametrize("act", [None, "tanh"])
def test_bilinear_tensor_product(act):
    ref, port = pair("BilinearTensorProduct", 5, 4, 3, act=act)
    want, got = run(ref, port, f32(6, 5), f32(6, 4, seed=1))
    close(got, want)
    close(PF.bilinear(torch.from_numpy(f32(6, 5)),
                      torch.from_numpy(f32(6, 4, seed=1)), port.weight),
          RF.bilinear(paddle.to_tensor(f32(6, 5)),
                      paddle.to_tensor(f32(6, 4, seed=1)), ref.weight))


def test_row_conv():
    close(*reversed(run(*pair("RowConv", 6, 2, act="sigmoid"),
                        f32(3, 7, 6))))


def test_tree_conv():
    ref, port = pair("TreeConv", 4, 3, num_filters=2, max_depth=2)
    nodes = f32(2, 6, 4)
    edges = np.array([[[0, 1], [0, 2], [1, 3], [1, 4], [2, 5]],
                      [[0, 1], [1, 2], [2, 3], [3, 4], [4, 5]]], np.int64)
    want = ref(paddle.to_tensor(nodes), paddle.to_tensor(edges))
    got = port(torch.from_numpy(nodes), torch.from_numpy(edges))
    assert tuple(got.shape) == (2, 6, 3, 2)
    close(got, want)


def test_nce_loss(monkeypatch):
    ref, port = pair("NCELoss", 20, 8, num_neg_samples=5)
    x, y = f32(6, 8), np.random.RandomState(2).randint(0, 20, (6, 1))
    ptt.seed(5)
    neg = torch.randint(0, 20, (6, 5), generator=prng.generator("cpu"))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(neg.numpy()))
    ptt.seed(5)
    got = port(torch.from_numpy(x), torch.from_numpy(y))
    want = ref(paddle.to_tensor(x), paddle.to_tensor(y))
    assert tuple(got.shape) == (6, 1)
    close(got, want)


@pytest.mark.parametrize("custom", [False, True])
def test_hsigmoid_loss(custom):
    ref, port = pair("HSigmoidLoss", 8, 6)
    x, y = f32(5, 8), np.random.RandomState(3).randint(0, 6, (5, 1))
    extra_r, extra_p = (), ()
    if custom:
        table = np.array([[0, 1, -1], [0, 2, 4], [0, 1, 3], [0, 2, -1],
                          [0, 2, 4]], np.int64)
        code = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 0],
                         [0, 1, 0]], np.float32)
        extra_r = (paddle.to_tensor(table), paddle.to_tensor(code))
        extra_p = (torch.from_numpy(table), torch.from_numpy(code))
    want = ref(paddle.to_tensor(x), paddle.to_tensor(y), *extra_r)
    got = port(torch.from_numpy(x), torch.from_numpy(y), *extra_p)
    close(got, want)


def test_gather_tree():
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 9, (5, 2, 3))
    parents = rs.randint(0, 3, (5, 2, 3))
    want = RF.gather_tree(paddle.to_tensor(ids), paddle.to_tensor(parents))
    got = PF.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("lengths", [None, [7, 4, 1]])
def test_ctc_greedy_decoder(lengths):
    x = f32(3, 7, 5, seed=5)
    kw_r = kw_p = {}
    if lengths is not None:
        kw_r = {"input_length": paddle.to_tensor(np.array(lengths))}
        kw_p = {"input_length": torch.tensor(lengths)}
    want = rnn.ctc_greedy_decoder(paddle.to_tensor(x), 0, padding_value=-1,
                                  **kw_r)
    got = pnn.ctc_greedy_decoder(torch.from_numpy(x), 0, padding_value=-1,
                                 **kw_p)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_static_and_dynamic_rnn():
    for mod in (rnn, pnn):
        for cls in (mod.StaticRNN, mod.DynamicRNN):
            r = cls()
            x = torch.zeros(3, 4) if mod is pnn else paddle.to_tensor(
                np.zeros((3, 4), np.float32))
            with r.step():
                inp = r.step_input(x)
                mem = r.memory(shape=[5], batch_ref=x, value=0.5)
                r.update_memory(mem, x)
                r.output(x)
            assert inp == ("input", 0) and mem == ("mem", 0)
            init = r._memories[0]["init"]
            np.testing.assert_array_equal(_np(init),
                                          np.full((3, 5), 0.5, np.float32))
            with pytest.raises(NotImplementedError):
                r()


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_search_dynamic_decode(beam):
    V, E, H, B = 11, 8, 16, 3
    paddle.seed(7)
    r_cell, r_emb, r_out = rnn.LSTMCell(E, H), rnn.Embedding(V, E), \
        rnn.Linear(H, V)
    p_cell, p_emb, p_out = pnn.LSTMCell(E, H), pnn.Embedding(V, E), \
        pnn.Linear(H, V)
    for r, p in ((r_cell, p_cell), (r_emb, p_emb), (r_out, p_out)):
        load_reference_state(p, {k: np.asarray(v.numpy()) * 3.0
                                 for k, v in r.state_dict().items()})
        r.set_state_dict({k: paddle.to_tensor(np.asarray(v.numpy()) * 3.0)
                          for k, v in r.state_dict().items()})
    h0 = f32(B, H, seed=8)
    c0 = f32(B, H, seed=9)
    rdec = rnn.BeamSearchDecoder(r_cell, 1, 2, beam, embedding_fn=r_emb,
                                 output_fn=r_out)
    pdec = pnn.BeamSearchDecoder(p_cell, 1, 2, beam, embedding_fn=p_emb,
                                 output_fn=p_out)
    want = rnn.dynamic_decode(rdec, (paddle.to_tensor(h0),
                                     paddle.to_tensor(c0)), max_step_num=10,
                              return_length=True)
    got = pnn.dynamic_decode(pdec, (torch.from_numpy(h0),
                                    torch.from_numpy(c0)), max_step_num=10,
                             return_length=True)
    assert tuple(got[0].shape) == tuple(np.asarray(want[0].numpy()).shape)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    close(got[1][1], want[1][1], rtol=1e-4, atol=1e-5)  # final scores


# ---- compat and tensor names -----------------------------------------------

@pytest.mark.parametrize("name", [
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_mod", "elementwise_pow",
    "elementwise_floordiv", "elementwise_max", "elementwise_min"])
def test_elementwise_names(name):
    x = np.abs(f32(3, 4)) + 1.0
    y = np.abs(f32(3, 4, seed=1)) + 0.5
    close(getattr(ptt, name)(torch.from_numpy(x), torch.from_numpy(y)),
          getattr(paddle, name)(paddle.to_tensor(x), paddle.to_tensor(y)))
    assert getattr(ptt.tensor, name) is getattr(ptt, name)


@pytest.mark.parametrize("name", ["reduce_sum", "reduce_mean", "reduce_max",
                                  "reduce_min", "reduce_prod", "reduce_all",
                                  "reduce_any"])
@pytest.mark.parametrize("dim,keep", [(None, False), (1, True), (0, False)])
def test_reduce_names(name, dim, keep):
    x = f32(3, 4)
    if name in ("reduce_all", "reduce_any"):
        x = x > 0
    close(getattr(ptt, name)(torch.from_numpy(x), dim=dim, keep_dim=keep),
          getattr(paddle, name)(paddle.to_tensor(x), dim=dim,
                                keep_dim=keep), rtol=1e-5)


def test_shape_queries_and_small_ops():
    x = f32(2, 3, 4)
    px, rx = torch.from_numpy(x), paddle.to_tensor(x)
    for name in ("numel", "rank", "shape", "is_empty", "has_inf",
                 "has_nan"):
        got, want = getattr(ptt, name)(px), getattr(paddle, name)(rx)
        np.testing.assert_array_equal(_np(got), _np(want))
    assert ptt.numel(px).dtype == torch.int64
    assert ptt.rank(px).dtype == ptt.shape(px).dtype == torch.int32
    inf = x.copy()
    inf[0, 0, 0] = np.inf
    assert bool(ptt.has_inf(torch.from_numpy(inf)))
    assert bool(ptt.is_empty(torch.zeros(0, 3)))
    a, b, c = f32(3, 4), f32(3, 4, seed=1), f32(3, 4, seed=2)
    close(ptt.addcmul(*map(torch.from_numpy, (a, b, c)), value=0.5),
          paddle.addcmul(*map(paddle.to_tensor, (a, b, c)), value=0.5))
    idx = np.array([[1], [0], [2]], np.int32)
    close(ptt.multiplex([torch.from_numpy(v) for v in (a, b, c)],
                        torch.from_numpy(idx)),
          paddle.multiplex([paddle.to_tensor(v) for v in (a, b, c)],
                           paddle.to_tensor(idx)))
    close(ptt.tensordot(torch.from_numpy(x), torch.from_numpy(f32(4, 5)),
                        axes=1),
          paddle.tensordot(rx, paddle.to_tensor(f32(4, 5)), axes=1),
          rtol=1e-5, atol=1e-5)
    assert ptt.broadcast_shape([2, 1, 4], [3, 1]) == \
        paddle.broadcast_shape([2, 1, 4], [3, 1])
    close(ptt.crop_tensor(px, [1, 2, 2], [1, 0, 1]),
          paddle.crop_tensor(rx, [1, 2, 2], [1, 0, 1]))
    close(ptt.tensor.reverse(px, [0, 2]), paddle.tensor.reverse(rx, [0, 2]))
    assert ptt.VarBase is ptt.LoDTensor is torch.Tensor
    assert ptt.in_dynamic_mode() is paddle.in_dynamic_mode() is True
    from paddle_tpu_torch.tensor import attribute, stat
    assert stat.numel is ptt.numel and attribute.rank is ptt.rank


def test_rng_state_names_and_printoptions():
    ptt.seed(3)
    state = ptt.get_cuda_rng_state()
    a = torch.rand(4, generator=prng.generator("cpu"))
    ptt.set_cuda_rng_state(state)
    b = torch.rand(4, generator=prng.generator("cpu"))
    assert torch.equal(a, b)
    ptt.set_printoptions(precision=3)
    assert "1.235" in str(torch.tensor([1.23456]))
    ptt.set_printoptions(precision=4)


def test_regularizer_namespace():
    from paddle_tpu_torch.optimizer import optimizer as popt
    assert ptt.regularizer.L2Decay is ptt.L2Decay is popt.L2Decay
    assert repr(ptt.regularizer.L1Decay(0.5)) == repr(
        paddle.regularizer.L1Decay(0.5))
    assert ptt.regularizer.L2DecayRegularizer is ptt.regularizer.L2Decay


# ---- flops and summary -----------------------------------------------------

def _nets(mod):
    return mod.Sequential(mod.Conv2D(3, 8, 3, padding=1), mod.BatchNorm2D(8),
                          mod.ReLU(), mod.MaxPool2D(2, 2), mod.Flatten(),
                          mod.Linear(8 * 4 * 4, 10), mod.GELU(),
                          mod.Linear(10, 2))


def test_flops_and_summary_totals(capsys):
    paddle.seed(0)
    ref, port = _nets(rnn), _nets(pnn)
    want = paddle.flops(ref, [2, 3, 8, 8], print_detail=True)
    got = ptt.flops(port, [2, 3, 8, 8], print_detail=True)
    assert got == want > 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == [ln for ln in out if ln.startswith("Total Flops")][0]
    assert ptt.summary(port) == paddle.summary(ref)
    assert ptt.hapi.summary(port, (2, 3, 8, 8)) == paddle.summary(ref)
    assert ptt.Model(port).summary() == paddle.Model(ref).summary()
    assert port.training  # flops leaves the mode as it found it
    assert not port._forward_hooks and all(
        not m._forward_hooks for m in port.sublayers())
