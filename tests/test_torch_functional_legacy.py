"""CPU twins of the port's fluid-era functional ops
(`paddle_tpu_torch.nn.functional`: `sequence`, `legacy`, `detection`,
the fused transformer ops) against the reference's
(`paddle_tpu.nn.functional`).

Every case of `test_functional_legacy.py` runs here on the port, with
its own assertions, and each is also held to the reference function's
output on the same seeded numpy inputs. The cases of
`test_fluid_legacy.py` whose functions live in these modules (bpr,
space_to_depth / shuffle_channel, add_position_encoding /
affine_channel, pad2d / hash, the tensor arrays and the step counter)
run through `paddle_tpu_torch.nn.functional`. The op table then holds
every other op of the three modules to the reference.

Random parameters are carried across: the reference's initializer draws
(Uniform, Normal, XavierUniform, KaimingUniform) are recorded and the port's
initializers return them in the same order, so unnamed `fc`, `nce`,
`deformable_conv`, `row_conv`, `multi_box_head`'s convolutions and the
RNN layer functions run on the
reference's weights; `nce`'s negatives are the port's draws, handed to
the reference's `jax.random.randint`.

Tolerances: float outputs rtol 1e-5, atol 1e-5 (float32); indices,
classes, ids and counts exactly.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
import paddle_tpu.nn.functional.transformer  # noqa: F401  (RF.transformer)
import paddle_tpu.nn.initializer as RI

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.functional as F
import paddle_tpu_torch.nn.initializer as PI
from paddle_tpu_torch import device as pdevice

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


def f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def T(a):
    return torch.from_numpy(np.asarray(a))


def R(a):
    return paddle.to_tensor(np.asarray(a))


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if torch.is_tensor(x):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def same(got, want, rtol=RTOL, atol=ATOL):
    """got (port) against want (reference), tuples and lists elementwise;
    integers and booleans exactly."""
    g, w = _np(got), _np(want)
    if isinstance(g, list):
        assert isinstance(w, list) and len(g) == len(w)
        for a, b in zip(g, w):
            same(a, b, rtol, atol)
        return
    assert tuple(g.shape) == tuple(w.shape), (g.shape, w.shape)
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    else:
        np.testing.assert_array_equal(g, w)


def both(name, *args, **kw):
    """(port's output, reference's output) of F.name / RF.name (a dotted
    name reaches into a submodule) on the same arguments (numpy arrays
    become each side's tensors)."""
    def conv(a, to):
        if isinstance(a, np.ndarray):
            return to(a)
        if isinstance(a, (list, tuple)) and a and all(
                isinstance(v, np.ndarray) for v in a):
            return [to(v) for v in a]
        return a
    def fn(mod):
        for part in name.split("."):
            mod = getattr(mod, part)
        return mod
    want = fn(RF)(*[conv(a, R) for a in args],
                  **{k: conv(v, R) for k, v in kw.items()})
    got = fn(F)(*[conv(a, T) for a in args],
                **{k: conv(v, T) for k, v in kw.items()})
    return got, want


@pytest.fixture
def carried(monkeypatch):
    """The reference's initializer draws, replayed by the port's."""
    draws = []
    for name in ("Uniform", "Normal", "XavierUniform", "KaimingUniform"):
        rc, pc = getattr(RI, name), getattr(PI, name)

        def rcall(self, shape, dtype=None, _orig=rc.__call__):
            v = _orig(self, shape, dtype)
            draws.append(np.asarray(v))
            return v

        def pcall(self, shape, dtype=None, device=None, generator=None):
            v = draws.pop(0)
            assert v.shape == tuple(shape), (v.shape, shape)
            return torch.from_numpy(v.copy()).to(device or "cpu")
        monkeypatch.setattr(rc, "__call__", rcall)
        monkeypatch.setattr(pc, "__call__", pcall)
    yield draws
    assert not draws, f"{len(draws)} reference draws not replayed"


@pytest.fixture
def fresh_store():
    F.legacy_param_store().clear()
    RF.legacy_param_store().clear()
    yield
    F.legacy_param_store().clear()
    RF.legacy_param_store().clear()


def _negatives(monkeypatch, n, k, classes, seed=5):
    """The port's negatives for the next nce call (generator seeded
    `seed`), handed to the reference's draw."""
    g = torch.Generator().manual_seed(seed)
    neg = torch.randint(0, classes, (n, k), generator=g)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(neg.numpy()))
    return torch.Generator().manual_seed(seed)


# ---- test_functional_legacy.py: TestSequenceOps ------------------------------

def test_sequence_pool_masked():
    x = np.arange(12, dtype=np.float32).reshape(2, 3, 2)
    lens = np.array([2, 3])
    s = F.sequence_pool(T(x), "sum", seq_len=T(lens)).numpy()
    np.testing.assert_allclose(s[0], x[0, :2].sum(0))
    np.testing.assert_allclose(s[1], x[1].sum(0))
    m = F.sequence_pool(T(x), "average", seq_len=T(lens)).numpy()
    np.testing.assert_allclose(m[0], x[0, :2].mean(0))
    mx = F.sequence_pool(T(x), "max", seq_len=T(lens)).numpy()
    np.testing.assert_allclose(mx[0], x[0, :2].max(0))
    last = F.sequence_last_step(T(x), seq_len=T(lens)).numpy()
    np.testing.assert_allclose(last[0], x[0, 1])
    np.testing.assert_allclose(last[1], x[1, 2])
    for kind in ("sum", "average", "sqrt", "max", "min", "first", "last"):
        same(*both("sequence_pool", x, kind, seq_len=lens))


def test_sequence_softmax_excludes_padding():
    x = np.zeros((1, 4, 1), np.float32)
    out = F.sequence_softmax(T(x), seq_len=T(np.array([2]))).numpy()
    np.testing.assert_allclose(out[0, :2, 0], [0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(out[0, 2:, 0], [0.0, 0.0])
    same(*both("sequence_softmax", f32(3, 5, 2), seq_len=np.array([5, 2, 1])))


def test_sequence_reverse():
    x = np.arange(8, dtype=np.float32).reshape(1, 8, 1)
    out = F.sequence_reverse(T(x), seq_len=T(np.array([5]))).numpy()
    np.testing.assert_allclose(out[0, :5, 0], [4, 3, 2, 1, 0])
    np.testing.assert_allclose(out[0, 5:, 0], [5, 6, 7])
    same(*both("sequence_reverse", x, seq_len=np.array([5])))


def test_sequence_pad_and_conv():
    x = np.ones((2, 4, 3), np.float32)
    padded, lens = F.sequence_pad(T(x), pad_value=-1,
                                  seq_len=T(np.array([2, 4])))
    assert padded.numpy()[0, 3, 0] == -1
    assert lens.numpy().tolist() == [2, 4]
    w = np.ones((9, 5), np.float32)
    out = F.sequence_conv(T(x), T(w), context_length=3)
    assert list(out.shape) == [2, 4, 5]
    np.testing.assert_allclose(out.numpy()[0, 1], 9.0)
    same(*both("sequence_pad", x, pad_value=-1, seq_len=np.array([2, 4])))
    same(*both("sequence_conv", f32(2, 4, 3), f32(9, 5, seed=1),
               bias=f32(5, seed=2), context_length=3,
               seq_len=np.array([4, 3])))


def test_sequence_enumerate():
    x = np.array([[1, 2, 3, 4]], np.int64)
    out = F.sequence_enumerate(T(x), win_size=2, pad_value=0).numpy()
    np.testing.assert_array_equal(out[0, 0], [1, 2])
    np.testing.assert_array_equal(out[0, 3], [4, 0])
    same(*both("sequence_enumerate", x, win_size=3, pad_value=9))


# ---- TestLegacyFunctional ----------------------------------------------------

def test_fc_and_erf(carried):
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    got, want = both("fc", x, 3)
    assert list(got.shape) == [4, 3]
    same(got, want)
    e = F.erf(T(np.array([0.0, 1.0], np.float32))).numpy()
    np.testing.assert_allclose(e, [0.0, 0.8427], atol=1e-3)
    same(*both("erf", f32(3, 4)))


def test_space_to_depth_shuffle_channel():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    out = F.space_to_depth(T(x), 2)
    assert list(out.shape) == [1, 4, 2, 2]
    same(out, RF.space_to_depth(R(x), 2))
    y = np.random.rand(1, 4, 2, 2).astype(np.float32)
    sc = F.shuffle_channel(T(y), 2).numpy()
    np.testing.assert_allclose(sc[0, 1], y[0, 2])
    same(sc, RF.shuffle_channel(R(y), 2))


def test_add_position_encoding():
    x = np.zeros((1, 4, 6), np.float32)
    out = F.add_position_encoding(T(x), alpha=1.0, beta=1.0).numpy()
    np.testing.assert_allclose(out[0, 0, :3], [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(out[0, 0, 3:], [1, 1, 1], atol=1e-6)
    same(*both("add_position_encoding", f32(2, 5, 7), alpha=0.5, beta=2.0))


def test_gather_tree():
    ids = np.array([[[2, 2]], [[6, 1]]], np.int64)
    parents = np.array([[[0, 0]], [[1, 0]]], np.int64)
    out = F.gather_tree(T(ids), T(parents)).numpy()
    np.testing.assert_array_equal(out[:, 0, 0], [2, 6])
    same(*both("gather_tree", ids, parents))


def test_losses_shapes_and_values(carried, fresh_store, monkeypatch):
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    lbl = np.array([[1], [2], [0], [3], [1]], np.int64)
    bpr, want = both("bpr_loss", x, lbl)
    assert list(bpr.shape) == [5, 1] and np.isfinite(bpr.numpy()).all()
    same(bpr, want)
    cl, want = both("center_loss", x, lbl, num_classes=4, alpha=0.1)
    assert list(cl.shape) == [5, 1] and (cl.numpy() >= 0).all()
    same(cl, want)
    same(*both("center_loss", x, lbl, num_classes=4, alpha=0.1))  # moved
    w = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    hs, want = both("hsigmoid_loss", x, lbl, 4, w)
    assert list(hs.shape) == [5, 1] and (hs.numpy() > 0).all()
    same(hs, want)
    g = _negatives(monkeypatch, 5, 3, 10)
    want = RF.nce(R(x), R(lbl), num_total_classes=10, num_neg_samples=3)
    n = F.nce(T(x), T(lbl), num_total_classes=10, num_neg_samples=3,
              generator=g)
    assert list(n.shape) == [5, 1] and np.isfinite(n.numpy()).all()
    same(n, want)
    d, want = both("dice_loss", np.abs(x) / 4, lbl)
    assert np.isfinite(float(d))
    same(d, want)


def test_linear_chain_crf_matches_bruteforce(fresh_store):
    rng = np.random.RandomState(0)
    emis = rng.randn(1, 3, 2).astype(np.float32)
    label = np.array([[0, 1, 1]], np.int64)
    got, want = both("linear_chain_crf", emis, label)
    nll = float(got[0, 0])
    scores = [sum(emis[0, t, y] for t, y in enumerate(path))
              for path in itertools.product([0, 1], repeat=3)]
    gold = sum(emis[0, t, label[0, t]] for t in range(3))
    np.testing.assert_allclose(nll, np.log(np.sum(np.exp(scores))) - gold,
                               rtol=1e-4)
    same(got, want)


def test_crf_decoding_zero_transitions_is_argmax(fresh_store):
    emis = np.array([[[0.1, 2.0], [3.0, 0.2], [0.0, 1.0]]], np.float32)
    path, want = both("crf_decoding", emis)
    np.testing.assert_array_equal(path.numpy()[0], [1, 0, 1])
    same(path, want)


def _crf_pair(n, seed):
    trans = f32(n + 2, n, seed=seed)
    F.legacy_param_store().set_buffer(f"crf_transition_{n}", T(trans))
    RF.legacy_param_store().set_buffer(f"crf_transition_{n}",
                                       jnp.asarray(trans))


def test_crf_with_transitions_lengths_and_ties(fresh_store):
    """Trained transitions, ragged lengths: the forward recursion and the
    gold path equal the reference's; Viterbi equals it, ties (integer
    potentials) to the first index."""
    _crf_pair(4, 3)
    emis = f32(3, 6, 4, seed=4)
    lab = np.random.RandomState(5).randint(0, 4, (3, 6))
    same(*both("linear_chain_crf", emis, lab, length=np.array([6, 3, 1])))
    same(*both("crf_decoding", emis))
    _crf_pair(3, 0)
    RF.legacy_param_store().set_buffer("crf_transition_3",
                                       jnp.zeros((5, 3), jnp.float32))
    F.legacy_param_store().set_buffer("crf_transition_3", torch.zeros(5, 3))
    ties = np.random.RandomState(6).randint(0, 2, (4, 5, 3)).astype(
        np.float32)
    same(*both("crf_decoding", ties))


def test_deformable_conv_zero_offsets_matches_conv(fresh_store):
    rng = np.random.RandomState(0)
    x = rng.randn(1, 2, 5, 5).astype(np.float32)
    off = np.zeros((1, 2 * 9, 5, 5), np.float32)
    want = RF.deformable_conv(R(x), R(off), None, num_filters=3,
                              filter_size=3, padding=1, modulated=False,
                              name="dcn_t")
    w = RF.legacy_param_store()._params["deformable_conv/dcn_t"].numpy()
    F.legacy_param_store().parameter("deformable_conv/dcn_t", w.shape) \
        .data.copy_(T(w))
    out = F.deformable_conv(T(x), T(off), None, num_filters=3,
                            filter_size=3, padding=1, modulated=False,
                            name="dcn_t")
    assert list(out.shape) == [1, 3, 5, 5]
    ref = torch.nn.functional.conv2d(T(x), T(w), padding=1)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), atol=1e-3)
    same(out, want)


def test_deformable_conv_offsets_and_mask(carried):
    """Non-zero offsets (samples between and outside the pixels), a
    stride, and the modulation mask; unnamed weights carried."""
    x = f32(2, 3, 6, 7)
    off = f32(2, 2 * 4, 3, 3, seed=1) * 1.5
    mask = np.abs(f32(2, 4, 3, 3, seed=2))
    same(*both("deformable_conv", x, off, mask, num_filters=4,
               filter_size=2, stride=2, padding=0, modulated=True))


def test_fc_same_shape_calls_are_independent():
    x = np.ones((2, 6), np.float32)
    a = F.fc(T(x), 3).detach().numpy()
    b = F.fc(T(x), 3).detach().numpy()
    assert not np.allclose(a, b)


def test_fc_named_reuses_and_is_trainable(fresh_store):
    import paddle_tpu_torch.optimizer as opt
    x = np.ones((2, 6), np.float32)
    a = F.fc(T(x), 3, name="shared_fc").detach().numpy()
    b = F.fc(T(x), 3, name="shared_fc").detach().numpy()
    np.testing.assert_allclose(a, b)
    params = F.legacy_param_store().parameters()
    assert len(params) >= 1
    sgd = opt.SGD(learning_rate=0.5, parameters=params)
    out = F.fc(T(x), 3, name="shared_fc")
    (out * out).mean().backward()
    sgd.step()
    c = F.fc(T(x), 3, name="shared_fc").detach().numpy()
    assert not np.allclose(a, c)


def test_named_nce_weights_receive_gradients(fresh_store):
    x = T(np.random.RandomState(0).randn(5, 4).astype(np.float32))
    lbl = T(np.array([[1], [2], [0], [3], [1]], np.int64))
    F.nce(x, lbl, num_total_classes=6, num_neg_samples=2,
          name="nce_t").mean().backward()
    w = F.legacy_param_store()._params["nce/nce_t.w"]
    assert w.grad is not None and float(w.grad.abs().sum()) > 0


def test_named_nce_matches_reference(fresh_store, monkeypatch):
    x, lbl = f32(5, 4), np.array([[1], [2], [0], [3], [1]], np.int64)
    g = _negatives(monkeypatch, 5, 2, 6)
    want = RF.nce(R(x), R(lbl), num_total_classes=6, num_neg_samples=2,
                  name="nce_r")
    store = F.legacy_param_store()
    for s in ("w", "b"):
        v = RF.legacy_param_store()._params[f"nce/nce_r.{s}"].numpy()
        store.parameter(f"nce/nce_r.{s}", v.shape).data.copy_(T(v))
    same(F.nce(T(x), T(lbl), num_total_classes=6, num_neg_samples=2,
               name="nce_r", generator=g), want)


def test_center_loss_buffer_persists(fresh_store):
    """The twin of the reference's jit-safety case: the centers are a
    store buffer that each eager call moves (update_center), and a call
    without the update leaves it."""
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    lbl = np.array([[0], [1]], np.int64)
    first = F.center_loss(T(x), T(lbl), num_classes=4, alpha=0.1)
    buf = F.legacy_param_store()._buffers["center_loss_4_4"].clone()
    assert float(buf.abs().sum()) > 0
    second = F.center_loss(T(x), T(lbl), num_classes=4, alpha=0.1,
                           update_center=False)
    assert torch.equal(F.legacy_param_store()._buffers["center_loss_4_4"],
                       buf)
    assert float(second.sum()) < float(first.sum())
    RF.center_loss(R(x), R(lbl), num_classes=4, alpha=0.1)
    np.testing.assert_allclose(
        buf.numpy(),
        np.asarray(RF.legacy_param_store()._buffers["center_loss_4_4"]),
        rtol=RTOL, atol=ATOL)


def test_rnn_layer_functions(carried):
    x = np.random.RandomState(0).randn(2, 5, 4).astype(np.float32)
    z = np.zeros((1, 2, 8), np.float32)
    got, want = both("lstm", x, z, z, hidden_size=8)
    assert list(got[0].shape) == [2, 5, 8]
    same(got, want)
    g, want = both("dynamic_gru", x, 6)
    assert list(g.shape) == [2, 5, 6]
    same(g, want)


@pytest.mark.parametrize("name,args,kw", [
    ("dynamic_lstm", lambda: (f32(2, 5, 4), 24), {}),
    ("dynamic_lstmp", lambda: (f32(2, 5, 4), 24, 3), {}),
    ("gru_unit", lambda: (f32(3, 4), np.zeros((3, 5), np.float32), 15), {}),
    ("lstm_unit", lambda: (f32(3, 4), f32(3, 5, seed=1), f32(3, 5, seed=2)),
     {}),
    ("lstm", lambda: (f32(2, 5, 4), np.zeros((4, 2, 6), np.float32),
                      np.zeros((4, 2, 6), np.float32)),
     dict(hidden_size=6, num_layers=2, is_bidirec=True)),
], ids=["dynamic_lstm", "dynamic_lstmp", "gru_unit", "lstm_unit",
        "lstm_bidirect_2layers"])
def test_rnn_layer_function_cases(carried, name, args, kw):
    same(*both(name, *args(), **kw))


# ---- TestDetection -----------------------------------------------------------

def test_box_coder_roundtrip():
    priors = np.array([[0., 0., 10., 10.], [5., 5., 15., 15.]], np.float32)
    gt = np.array([[1., 1., 9., 9.]], np.float32)
    enc, want = both("box_coder", priors, None, gt,
                     code_type="encode_center_size")
    same(enc, want)
    dec = F.box_coder(T(priors), None, enc, code_type="decode_center_size")
    np.testing.assert_allclose(dec.numpy()[0, 0], gt[0], atol=1e-4)
    np.testing.assert_allclose(dec.numpy()[0, 1], gt[0], atol=1e-4)
    same(dec, RF.box_coder(R(priors), None, want,
                           code_type="decode_center_size"))


def test_anchor_and_prior_shapes():
    fm = np.zeros((1, 8, 4, 4), np.float32)
    img = np.zeros((1, 3, 64, 64), np.float32)
    (a, v), want = both("anchor_generator", fm, anchor_sizes=[32.],
                        aspect_ratios=[1.0], stride=[16., 16.])
    assert list(a.shape) == [4, 4, 1, 4] and list(v.shape) == [4, 4, 1, 4]
    same((a, v), want)
    (p, pv), want = both("prior_box", fm, img, min_sizes=[16.],
                         aspect_ratios=[1.0])
    assert list(p.shape) == [4, 4, 1, 4]
    same((p, pv), want)
    (d, dv), want = both("density_prior_box", fm, img, densities=[2],
                         fixed_sizes=[16.], fixed_ratios=[1.0])
    assert list(d.shape) == [4, 4, 4, 4]
    same((d, dv), want)


def test_bipartite_match():
    sim = np.array([[0.9, 0.1], [0.2, 0.8]], np.float32)
    (rows, dist), want = both("bipartite_match", sim)
    np.testing.assert_array_equal(rows.numpy()[0], [0, 1])
    np.testing.assert_allclose(dist.numpy()[0], [0.9, 0.8])
    same((rows, dist), want)


def test_multiclass_nms_static_shape():
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10.1, 10.1],
                      [20, 20, 30, 30]], np.float32)
    scores = np.array([[0.0, 0.0, 0.0], [0.9, 0.85, 0.6]], np.float32)
    out, want = both("multiclass_nms", boxes, scores, score_threshold=0.5,
                     keep_top_k=3, nms_threshold=0.5)
    out = out.numpy()
    assert out.shape == (3, 6)
    assert len(out[out[:, 0] >= 0]) == 2
    same(out, want)


def test_box_clip():
    b = np.array([[-5., -5., 200., 50.]], np.float32)
    im = np.array([[100., 100., 1.0]], np.float32)
    out, want = both("box_clip", b, im)
    np.testing.assert_allclose(out.numpy()[0], [0, 0, 99, 50])
    same(out, want)


def test_generate_proposals_static():
    rng = np.random.RandomState(0)
    scores = rng.rand(1, 3, 4, 4).astype(np.float32)
    deltas = (rng.rand(1, 12, 4, 4).astype(np.float32) - 0.5) * 0.1
    fm = np.zeros((1, 8, 4, 4), np.float32)
    anchors, var = F.anchor_generator(T(fm), anchor_sizes=[16.],
                                      aspect_ratios=[0.5, 1.0, 2.0],
                                      stride=[16., 16.])
    im_info = np.array([[64., 64., 1.0]], np.float32)
    got, want = both("generate_proposals", scores, deltas, im_info,
                     anchors.numpy(), var.numpy(), pre_nms_top_n=30,
                     post_nms_top_n=10, return_rois_num=True)
    assert list(got[0].shape) == [10, 4]
    same(got, want)


def test_roi_pool_and_yolo_box():
    x = np.random.RandomState(0).rand(1, 2, 8, 8).astype(np.float32)
    rois = np.array([[0., 0., 4., 4.], [1.5, 2.5, 7., 6.]], np.float32)
    out, want = both("roi_pool", x, rois, output_size=2)
    assert list(out.shape) == [2, 2, 2, 2]
    same(out, want)
    ylo = np.random.RandomState(1).rand(1, 2 * 7, 4, 4).astype(np.float32)
    (boxes, sc), want = both("yolo_box", ylo, np.array([[64, 64]], np.int32),
                             anchors=[10, 13, 16, 30], class_num=2)
    assert boxes.shape[0] == 1 and boxes.shape[-1] == 4
    same((boxes, sc), want)


def test_distribute_and_collect_fpn():
    rois = np.array([[0, 0, 16, 16], [0, 0, 100, 100]], np.float32)
    (outs, restore), want = both("distribute_fpn_proposals", rois, 2, 5, 4,
                                 224)
    assert len(outs) == 4
    same((outs, restore), want)
    col, want = both("collect_fpn_proposals", [rois],
                     [np.array([0.9, 0.8], np.float32)], 2, 5,
                     post_nms_top_n=2)
    assert list(col.shape) == [2, 4]
    same(col, want)


def test_yolov3_loss_finite():
    rng = np.random.RandomState(0)
    x = rng.randn(1, 3 * 7, 4, 4).astype(np.float32)
    gt_box = np.array([[[0.5, 0.5, 0.3, 0.4]]], np.float32)
    gt_lbl = np.array([[1]], np.int64)
    loss, want = both("yolov3_loss", x, gt_box, gt_lbl,
                      anchors=[10, 13, 16, 30, 33, 23],
                      anchor_mask=[0, 1, 2], class_num=2)
    assert np.isfinite(float(loss.reshape(-1)[0]))
    same(loss, want, rtol=1e-5, atol=1e-4)


# ---- test_fluid_legacy.py: the cases in these modules ------------------------

def test_fluid_bpr_loss():
    scores = np.random.RandomState(0).randn(4, 5)
    lbl = np.asarray([[0], [1], [2], [3]], np.int64)
    got, want = both("bpr_loss", scores, lbl)
    assert got.shape == (4, 1) and (got.numpy() > 0).all()
    same(got, want)


def test_fluid_space_to_depth_and_shuffle_channel():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    assert tuple(F.space_to_depth(T(x), 2).shape) == (1, 4, 2, 2)
    x2 = np.random.rand(1, 4, 2, 2).astype(np.float32)
    sc, want = both("shuffle_channel", x2, 2)
    assert tuple(sc.shape) == (1, 4, 2, 2)
    same(sc, want)


def test_fluid_add_position_encoding_and_affine_channel():
    x = np.zeros((1, 4, 8), np.float32)
    pe, want = both("add_position_encoding", x, 1.0, 1.0)
    assert not np.allclose(pe.numpy(), 0)
    same(pe, want)
    img = np.ones((1, 2, 3, 3), np.float32)
    out, want = both("affine_channel", img, np.asarray([2.0, 3.0],
                                                       np.float32),
                     np.asarray([1.0, -1.0], np.float32))
    np.testing.assert_allclose(out.numpy()[0, 0], 3.0)
    np.testing.assert_allclose(out.numpy()[0, 1], 2.0)
    same(out, want)


def test_fluid_single_source_of_truth():
    """The 1.x names are the canonical `legacy` functions."""
    import paddle_tpu_torch.nn.functional.legacy as canon
    for name in ("pad2d", "hash", "smooth_l1", "dynamic_lstm",
                 "array_write", "center_loss", "add_position_encoding",
                 "affine_channel", "autoincreased_step_counter"):
        assert getattr(F, name) is getattr(canon, name), name


def test_fluid_pad2d_orientation_and_hash_run():
    out, want = both("pad2d", np.ones((1, 1, 2, 2), np.float32),
                     (1, 0, 0, 0))
    assert tuple(out.shape) == (1, 1, 3, 2)
    same(out, want)
    h, want = both("hash", np.asarray([[3, 7]], np.int64), 100)
    assert (0 <= h.numpy()).all() and (h.numpy() < 100).all()
    same(h, want)


def test_fluid_arrays_and_counters():
    arr = F.array_write(T(np.asarray([1.0])), T(np.asarray(0)))
    F.array_write(T(np.asarray([2.0])), T(np.asarray(1)), arr)
    assert int(F.array_length(arr)) == 2
    np.testing.assert_allclose(F.array_read(arr, T(np.asarray(1))).numpy(),
                               [2.0])
    c1 = int(F.autoincreased_step_counter("t_c"))
    c2 = int(F.autoincreased_step_counter("t_c"))
    assert c2 == c1 + 1
    ref = [int(np.asarray(RF.autoincreased_step_counter("t_r").numpy())[0])
           for _ in range(2)]
    assert [c1 - c1 + ref[0], c2 - c1 + ref[0]] == ref
    (out, sizes), want = both("tensor_array_to_tensor",
                              [f32(2, 3), f32(2, 1, seed=1)], axis=1)
    same((out, sizes), want)


# ---- every other op of the three modules against the reference ---------------

def _boxes(n, seed, size=32.0):
    rs = np.random.RandomState(seed)
    xy = rs.rand(n, 2).astype(np.float32) * size
    wh = rs.rand(n, 2).astype(np.float32) * size / 2 + 1
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


OPS = [
    ("sequence_unpad", lambda: (f32(3, 4, 2), np.array([1, 4, 2])), {}),
    ("sequence_first_step", lambda: (f32(3, 4, 2),), {}),
    ("sequence_last_step", lambda: (f32(3, 4, 2),), {}),
    ("sequence_concat", lambda: ([f32(2, 3, 4), f32(2, 1, 4, seed=1)],), {}),
    ("sequence_expand", lambda: (f32(2, 1, 3), f32(2, 5, 3)), {}),
    ("sequence_expand_as", lambda: (f32(2, 1, 3), f32(2, 4, 3)), {}),
    ("sequence_reshape", lambda: (f32(2, 4, 6), 3), {}),
    ("sequence_slice", lambda: (f32(3, 6, 2), np.array([0, 2, 4]),
                                np.array([3, 2, 1])), {}),
    ("sequence_scatter", lambda: (f32(2, 5, 3), np.array([[0, 2], [4, 4]]),
                                  f32(2, 2, 3, seed=1)), {}),
    ("soft_relu", lambda: (f32(3, 4) * 30,), dict(threshold=20.0)),
    ("smooth_l1", lambda: (f32(3, 4), f32(3, 4, seed=1)),
     dict(inside_weight=np.abs(f32(3, 4, seed=2)),
          outside_weight=np.abs(f32(3, 4, seed=3)), sigma=2.0)),
    ("pad2d", lambda: (f32(1, 2, 3, 4), (1, 2, 0, 1)),
     dict(mode="reflect")),
    ("pad2d", lambda: (f32(1, 3, 4, 2), (2, 0, 1, 1)),
     dict(mode="edge", data_format="NHWC")),
    ("pad2d", lambda: (f32(1, 3, 4, 2), (1, 0, 0, 2)),
     dict(pad_value=-3.0, data_format="NHWC")),
    ("pad_constant_like", lambda: (f32(3, 5, 4), f32(2, 3, 4, seed=1)),
     dict(pad_value=7.0)),
    ("affine_channel", lambda: (f32(2, 3, 2, 2), f32(3, seed=1),
                                f32(3, seed=2)),
     dict(data_format="NHWC" and "NCHW", act="relu")),
    ("data_norm", lambda: (f32(6, 4),), dict(act="tanh")),
    ("similarity_focus", lambda: (f32(2, 3, 4, 5), 1, [0, 2]), {}),
    ("fsp_matrix", lambda: (f32(2, 3, 4, 4), f32(2, 5, 4, 4, seed=1)), {}),
    ("im2sequence", lambda: (f32(1, 2, 5, 5),),
     dict(filter_size=2, stride=1, padding=0)),
    ("continuous_value_model", lambda: (f32(3, 5), None), dict(use_cvm=False)),
    ("filter_by_instag", lambda: (f32(5, 2), np.array([1, 3, 2, 3, 5]),
                                  np.array([3, 5])), {}),
    ("polygon_box_transform", lambda: (f32(1, 8, 3, 4),), {}),
    ("image_resize", lambda: (f32(1, 2, 4, 5),), dict(out_shape=[7, 3])),
    ("resize_bilinear", lambda: (f32(1, 2, 4, 5),), dict(out_shape=[8, 10])),
    ("resize_nearest", lambda: (f32(1, 2, 4, 5),), dict(out_shape=[2, 3])),
    ("resize_trilinear", lambda: (f32(1, 2, 3, 4, 5),),
     dict(out_shape=[4, 6, 3])),
    ("image_resize_short", lambda: (f32(1, 2, 6, 9), 4), {}),
    ("teacher_student_sigmoid_loss",
     lambda: (f32(6, 1) * 10, np.array([[-1.], [0.], [1.], [0.3], [0.9],
                                        [2.]], np.float32)), {}),
    ("warpctc", lambda: (np.log(np.random.RandomState(0).dirichlet(
        np.ones(5), (6, 2)).astype(np.float32)),
        np.array([[1, 2, 0], [3, 3, 4]], np.int32), 0, False,
        np.array([6, 5], np.int32), np.array([2, 3], np.int32)), {}),
    ("bilinear", lambda: (f32(4, 3), f32(4, 2, seed=1), f32(5, 3, 2, seed=2),
                          f32(5, seed=3)), {}),
    ("box_coder", lambda: (_boxes(5, 0), np.abs(f32(5, 4, seed=1)) + 0.1,
                           f32(3, 5, 4, seed=2) * 0.2),
     dict(code_type="decode_center_size", box_normalized=False)),
    ("box_coder", lambda: (_boxes(4, 0), None, f32(4, 4, 4, seed=2) * 0.2),
     dict(code_type="decode_center_size", axis=1)),
    ("box_coder", lambda: (_boxes(4, 0), np.abs(f32(4, 4, seed=1)) + 0.1,
                           _boxes(3, 5)),
     dict(code_type="encode_center_size", box_normalized=False)),
    ("box_decoder_and_assign", lambda: (
        _boxes(6, 0), np.abs(f32(6, 4, seed=1)) + 0.1, f32(6, 12, seed=2),
        np.abs(f32(6, 3, seed=3))), {}),
    ("bipartite_match", lambda: (np.random.RandomState(4).rand(4, 6)
                                 .astype(np.float32),),
     dict(match_type="per_prediction", dist_threshold=0.3)),
    ("target_assign", lambda: (f32(2, 3, 4), np.array([[0, -1, 2, 1],
                                                       [2, 2, -1, 0]])),
     dict(mismatch_value=-5)),
    ("detection_output", lambda: (
        f32(6, 4, seed=1) * 0.1,
        np.random.RandomState(2).rand(1, 6, 3).astype(np.float32),
        _boxes(6, 0) / 40, np.full((6, 4), 0.1, np.float32)),
     dict(score_threshold=0.1, nms_top_k=5, keep_top_k=4)),
    ("psroi_pool", lambda: (f32(1, 8, 6, 6), _boxes(3, 1, 5)),
     dict(output_channels=2, pooled_height=2, pooled_width=2)),
    ("prroi_pool", lambda: (f32(1, 3, 8, 8), _boxes(3, 1, 6)),
     dict(output_size=2)),
    ("deformable_roi_pooling", lambda: (f32(1, 3, 8, 8), _boxes(3, 1, 6),
                                        f32(3, 2, 2, 2, seed=5)),
     dict(pooled_height=2, pooled_width=2)),
    ("roi_perspective_transform", lambda: (
        f32(1, 2, 8, 8), np.random.RandomState(3).rand(2, 8).astype(
            np.float32) * 7, 3, 4), {}),
    ("rpn_target_assign", lambda: (None, None, _boxes(20, 0),
                                   None, _boxes(3, 1)),
     dict(rpn_batch_size_per_im=8)),
    ("retinanet_target_assign", lambda: (
        None, None, _boxes(20, 0), None, _boxes(3, 1),
        np.array([1, 2, 3])), {}),
    ("retinanet_detection_output", lambda: (
        [_boxes(5, 0), _boxes(4, 1)],
        [np.random.RandomState(2).rand(5, 3).astype(np.float32),
         np.random.RandomState(3).rand(4, 3).astype(np.float32)],
        np.array([[64., 64., 1.]], np.float32)),
     dict(keep_top_k=6)),
    ("generate_proposal_labels", lambda: (
        _boxes(12, 0), np.array([1, 2]), None, _boxes(2, 1), None),
     dict(batch_size_per_im=8, class_nums=4)),
    ("generate_mask_labels", lambda: (
        None, None, None,
        (np.random.RandomState(6).rand(2, 16, 16) > 0.5).astype(np.int32),
        _boxes(4, 0, 12), np.array([1, 0, 2, 1], np.int32), 3, 4), {}),
    ("distribute_fpn_proposals", lambda: (_boxes(6, 2, 200), 2, 5, 4, 64),
     dict(rois_num=np.array([6]))),
    ("detection.iou_similarity", lambda: (_boxes(4, 0), _boxes(3, 1)), {}),
    ("detection.ssd_loss", lambda: (
        f32(2, 6, 4) * 0.1, f32(2, 6, 3, seed=1),
        np.stack([_boxes(2, 0) / 40, np.array([[0.1, 0.1, 0.6, 0.5],
                                               [0, 0, 0, 0]], np.float32)]),
        np.array([[1, 2], [2, 0]]), _boxes(6, 3) / 40),
     dict(neg_pos_ratio=2.0, overlap_threshold=0.3)),
]


@pytest.mark.parametrize("name,args,kw", OPS,
                         ids=[f"{o[0]}-{i}" for i, o in enumerate(OPS)])
def test_op_against_reference(name, args, kw):
    same(*both(name, *args(), **kw))


def test_multi_box_head_on_carried_convs(carried):
    F.multi_box_head._cache.clear()
    RF.multi_box_head._cache.clear()
    feats = [f32(1, 4, 4, 4), f32(1, 6, 2, 2, seed=1)]
    img = np.zeros((1, 3, 32, 32), np.float32)
    kw = dict(base_size=32, num_classes=3, aspect_ratios=[[2.0], [2.0, 3.0]],
              min_sizes=[4.0, 8.0], max_sizes=[8.0, 16.0], flip=True)
    want = RF.multi_box_head([R(f) for f in feats], R(img), **kw)
    got = F.multi_box_head([T(f) for f in feats], T(img), **kw)
    same(got, want)


@pytest.mark.parametrize("case", ["named", "unnamed"])
def test_param_shims(carried, fresh_store, case):
    """row_conv and bilinear_tensor_product on carried weights, unnamed
    (fresh each call) and named (made once in the store, reused)."""
    x, y = f32(2, 5, 3), f32(2, 4, seed=1)
    if case == "named":
        from paddle_tpu.core.param_attr import ParamAttr as RAttr

        from paddle_tpu_torch.core.param_attr import ParamAttr as PAttr
        want = RF.row_conv(R(x), 2, param_attr=RAttr(name="rc"), act="tanh")
        got = F.row_conv(T(x), 2, param_attr=PAttr(name="rc"), act="tanh")
        same(got, want)
        same(F.row_conv(T(x), 2, param_attr=PAttr(name="rc")),
             RF.row_conv(R(x), 2, param_attr=RAttr(name="rc")))
        want = RF.bilinear_tensor_product(R(x[:, 0]), R(y), 3, name="btp")
        got = F.bilinear_tensor_product(T(x[:, 0]), T(y), 3, name="btp")
    else:
        same(*both("row_conv", x, 2))
        got, want = both("bilinear_tensor_product", x[:, 0], y, 3,
                         act="sigmoid")
    same(got, want)


def test_random_crop_is_a_window():
    x = f32(2, 3, 6, 7)
    out = F.random_crop(T(x), [4, 5], generator=torch.Generator()
                        .manual_seed(0))
    assert list(out.shape) == [2, 3, 4, 5]
    hit = [(i, j) for i in range(3) for j in range(3)
           if np.array_equal(x[..., i:i + 4, j:j + 5], out.numpy())]
    assert hit
    ref = RF.random_crop(R(x), [4, 5], seed=3)
    assert list(ref.shape) == list(out.shape)


def test_assign_and_lod_noops():
    x = f32(2, 3)
    same(F.assign(T(x)), RF.assign(R(x)))
    dst = torch.zeros(2, 3)
    assert F.assign(T(x), dst) is dst and np.array_equal(dst.numpy(), x)
    t = T(x)
    for name in ("lod_reset", "merge_selected_rows"):
        assert getattr(F, name)(t) is t
    assert F.lod_append(t, [0]) is t
    assert F.reorder_lod_tensor_by_rank(t, None) is t
    assert F.create_array() == []


@pytest.mark.parametrize("masked", [False, True])
def test_fused_multi_head_attention(masked, monkeypatch):
    """The fused op equals the reference's and takes the dense path
    (`ops.attention.dense_attention`, the port's `_xla_attention`), not a
    kernel."""
    from paddle_tpu_torch.ops import attention as A
    b, s, e, h = 2, 5, 8, 2
    args = (f32(b, s, e), f32(e, 3 * e, seed=1) * 0.3, f32(3 * e, seed=2),
            f32(e, e, seed=3) * 0.3, f32(e, seed=4))
    mask = (np.where(np.random.RandomState(5).rand(b, 1, s, s) > 0.3, 0.0,
                     -1e9).astype(np.float32) if masked else None)
    calls = []
    real = A.dense_attention
    monkeypatch.setattr(A, "dense_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, want = both("transformer.fused_multi_head_attention", *args, num_heads=h,
                     attn_mask=mask, is_causal=not masked)
    same(got, want)
    assert calls == [1]


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_feedforward(act):
    same(*both("transformer.fused_feedforward", f32(2, 3, 4), f32(4, 6, seed=1),
               f32(6, seed=2), f32(6, 4, seed=3), f32(4, seed=4),
               activation=act))


def test_store_state_dict_and_parameters(fresh_store):
    F.fc(T(f32(2, 3)), 4, name="sd_fc")
    F.center_loss(T(f32(2, 3)), T(np.array([[0], [1]])), 2, 0.5, name="cc")
    sd = F.legacy_param_store().state_dict()
    assert set(sd) == {"fc/sd_fc.weight", "fc/sd_fc.bias", "buffer/cc"}
    assert len(F.legacy_param_store().parameters()) == 2
    with pytest.raises(ValueError, match="exists with weight shape"):
        F.fc(T(f32(2, 5)), 4, name="sd_fc")
