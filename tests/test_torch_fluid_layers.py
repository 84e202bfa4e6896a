"""CPU twins of the port's `fluid.layers`, `fluid.contrib` and
`fluid.dygraph` (`paddle_tpu_torch.fluid`) against the reference's
(`paddle_tpu.fluid`): the cases of `test_fluid_legacy.py` that
`test_torch_functional_legacy.py` does not already run (those whose
functions live in `nn.functional`), each with its own assertions and
held to the reference's output on the same seeded numpy inputs.

Deterministic outputs are compared: float outputs rtol 1e-5, atol 1e-6;
ids, counts and classes exactly. Where a function draws random numbers
(NCE's negatives, `shuffle_batch`'s permutation, the sampled decoders)
the two frameworks' generators differ, so the twin checks the contract
(shapes, a permutation of the rows) rather than the values. Weights
are carried across with `nn.layer.layers.load_reference_state` (the
GRU and LSTM of `basic_gru` / `basic_lstm`, `GRUUnit`, `TreeConv`).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.fluid as rfluid
import paddle_tpu.fluid.layers as RL

import paddle_tpu_torch as ptt
import paddle_tpu_torch.fluid as fluid
import paddle_tpu_torch.fluid.layers as L
from paddle_tpu.core.tensor import Tensor as RTensor
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.nn.layer.layers import load_reference_state

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        yield


def T(a):
    return torch.from_numpy(np.asarray(a))


def R(a):
    return RTensor(jnp.asarray(np.asarray(a)))


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if torch.is_tensor(x):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def same(got, want, rtol=RTOL, atol=ATOL):
    g, w = _np(got), _np(want)
    if isinstance(g, list):
        assert isinstance(w, list) and len(g) == len(w)
        for a, b in zip(g, w):
            same(a, b, rtol, atol)
        return
    g, w = np.asarray(g), np.asarray(w)
    assert g.shape == w.shape, (g.shape, w.shape)
    if g.dtype.kind in "biu" or w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def ref_state(layer):
    """A reference layer's state as {name: numpy array}."""
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def both(name, *args, **kw):
    """fluid.layers.<name> of the port and of the reference on the same
    numpy arguments (lists of arrays stay lists)."""
    def conv(f, a):
        if isinstance(a, np.ndarray):
            return f(a)
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            return [f(x) for x in a]
        return a
    got = getattr(L, name)(*[conv(T, a) for a in args], **kw)
    want = getattr(RL, name)(*[conv(R, a) for a in args], **kw)
    return got, want


# ---- TestLegacyLayers -------------------------------------------------------

def test_multiplex():
    a = np.asarray([[1.0, 2], [3, 4]], np.float32)
    b = np.asarray([[10.0, 20], [30, 40]], np.float32)
    idx = np.asarray([[1], [0]], np.int32)
    got, want = both("multiplex", [a, b], idx)
    np.testing.assert_allclose(got.numpy(), [[10, 20], [3, 4]])
    same(got, want)


def test_elementwise_and_reduce_family():
    x, y = np.asarray([1.0, 5.0], np.float32), np.asarray([3.0, 2.0],
                                                          np.float32)
    got, want = both("elementwise_max", x, y)
    np.testing.assert_allclose(got.numpy(), [3, 5])
    same(got, want)
    for name in ("elementwise_min", "elementwise_pow", "elementwise_mod",
                 "elementwise_floordiv"):
        same(*both(name, x, y))
    got, want = both("reduce_prod", np.asarray([2.0, 3.0], np.float32))
    np.testing.assert_allclose(got.numpy(), 6.0)
    same(got, want)
    m = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    for name in ("reduce_min", "reduce_sum", "reduce_mean", "reduce_max"):
        same(*both(name, m, dim=1))


def test_decay_layers_return_schedulers():
    from paddle_tpu_torch.optimizer.lr import LRScheduler
    cases = [("exponential_decay", (0.1, 100, 0.9)),
             ("piecewise_decay", ([10, 20], [0.1, 0.05, 0.01])),
             ("cosine_decay", (0.1, 10, 3)), ("noam_decay", (512, 100)),
             ("natural_exp_decay", (0.1, 100, 0.9)),
             ("inverse_time_decay", (0.1, 100, 0.5)),
             ("polynomial_decay", (0.1, 100))]
    for name, args in cases:
        sched, ref = getattr(L, name)(*args), getattr(RL, name)(*args)
        assert isinstance(sched, LRScheduler), name
        lrs, rlrs = [], []
        for _ in range(25):
            lrs.append(sched())
            rlrs.append(ref())
            sched.step()
            ref.step()
        np.testing.assert_allclose(lrs, rlrs, rtol=1e-6, err_msg=name)


def test_rank_loss():
    lbl = np.asarray([[1.0], [0.0]], np.float32)
    left = np.asarray([[2.0], [0.5]], np.float32)
    right = np.asarray([[1.0], [1.5]], np.float32)
    got, want = both("rank_loss", lbl, left, right)
    assert got.shape == (2, 1) and np.isfinite(got.numpy()).all()
    same(got, want)
    same(*both("margin_rank_loss", lbl, left, right))


def test_edit_distance():
    a = np.asarray([[1, 2, 3, 4]], np.int64)
    b = np.asarray([[1, 5, 3]], np.int64)
    (dist, n), (rdist, rn) = both("edit_distance", a, b, normalized=False)
    assert float(dist.numpy()[0, 0]) == 2.0  # a substitution and a deletion
    same(dist, rdist)
    same(n, rn)
    same(*both("edit_distance", a, b, normalized=True)[0:2])


def test_ctc_greedy_decoder():
    # logits prefer: [a a blank b b] -> "a b"
    probs = np.full((1, 5, 3), -5.0, np.float32)
    for t, c in enumerate([1, 1, 0, 2, 2]):
        probs[0, t, c] = 5.0
    (ids, lens), (rids, rlens) = both("ctc_greedy_decoder", probs, blank=0)
    assert list(ids.numpy()[0][:2]) == [1, 2]
    assert int(lens.numpy()[0]) == 2
    same(ids, rids)
    same(lens, rlens)


def test_beam_search_step():
    # 2 beams, vocab 4: flat top-2 of accumulated scores
    scores = np.asarray([[0.1, 0.9, 0.0, 0.0], [0.0, 0.0, 0.8, 0.2]],
                        np.float32)
    ids = np.zeros((2, 4), np.int64)
    pre = np.zeros((2, 1), np.float32)
    got, want = both("beam_search", None, pre, ids, scores, beam_size=2,
                     end_id=0, return_parent_idx=True)
    sel_ids, sel_scores, parent = got
    assert float(sel_scores.numpy()[0, 0]) == pytest.approx(0.9)
    assert int(parent.numpy()[0]) == 0
    assert int(parent.numpy()[1]) == 1  # 0.8 from beam 1
    same(list(got), list(want))


def test_beam_search_first_step_grouping():
    """Rows not divisible by beam_size (the first decode step) group per
    row: candidates never merge across batch items."""
    scores = np.asarray([[0.1, 0.9, 0, 0], [0, 0, 0.8, 0.2],
                         [0.5, 0, 0, 0.4]], np.float32)
    ids = np.zeros((3, 4), np.int64)
    got, want = both("beam_search", None, np.zeros((3, 1), np.float32), ids,
                     scores, beam_size=4, end_id=0)
    np.testing.assert_allclose(got[1].numpy().reshape(3, 4)[:, 0],
                               [0.9, 0.8, 0.5])
    same(list(got), list(want))


def test_training_helper_basic_decoder():
    """A GRU cell on the reference's weights behind TrainingHelper and
    BasicDecoder: one step's outputs, sample ids and next inputs."""
    import paddle_tpu.nn as rnn
    import paddle_tpu_torch.nn as pnn
    paddle.seed(0)
    rcell = rnn.GRUCell(4, 4)
    cell = pnn.GRUCell(4, 4)
    load_reference_state(cell, ref_state(rcell))
    inputs = np.random.RandomState(1).randn(2, 3, 4).astype(np.float32)
    h0 = np.zeros((2, 4), np.float32)
    outs = []
    for mod, cellx, conv in ((L, cell, T), (RL, rcell, R)):
        dec = mod.BasicDecoder(cellx, mod.TrainingHelper(conv(inputs)))
        inp, states, finished = dec.initialize(conv(h0))
        outs.append(dec.step(conv(np.asarray(0)), inp, states))
    (out, states, inp, fin), (rout, rstates, rinp, rfin) = outs
    assert tuple(out.cell_outputs.shape) == (2, 4)
    assert tuple(out.sample_ids.shape) == (2,)
    same(out.cell_outputs, rout.cell_outputs, atol=1e-5)
    same(out.sample_ids, rout.sample_ids)
    same(inp, rinp)
    same(fin, rfin)


def test_mvn_diag_distribution():
    loc, scale = np.zeros(2, np.float32), np.eye(2, dtype=np.float32) * 2.0
    d = L.MultivariateNormalDiag(T(loc), T(scale))
    rd = RL.MultivariateNormalDiag(R(loc), R(scale))
    v = np.asarray([0.3, -0.2], np.float32)
    lp = d.log_prob(T(v))
    np.testing.assert_allclose(d.log_prob(T(np.zeros(2, np.float32))),
                               -0.5 * 2 * np.log(2 * np.pi * 4.0),
                               rtol=1e-5)
    same(lp, rd.log_prob(R(v)))
    same(d.entropy(), rd.entropy())
    other = L.MultivariateNormalDiag(T(loc + 1), T(scale * 0.5))
    rother = RL.MultivariateNormalDiag(R(loc + 1), R(scale * 0.5))
    same(d.kl_divergence(other), rd.kl_divergence(rother))
    assert tuple(d.sample((5,)).shape) == (5, 2)


def test_blocks_raise_with_guidance():
    for name in ("While", "IfElse", "Switch", "DynamicRNN", "StaticRNN"):
        for mod in (L, RL):
            with pytest.raises(NotImplementedError, match="SURVEY"):
                getattr(mod, name)(None)


def test_chunk_eval_outside_tag():
    """The O tag terminates chunks and never starts one."""
    tags = np.asarray([0, 1, 2, 0], np.int64)  # B I O B
    got, want = both("chunk_eval", tags, tags, "IOB", 1)
    assert int(got[4].numpy()) == 2 and float(got[2].numpy()) == 1.0
    same(list(got), list(want))


def test_chunk_eval_and_auc():
    pred = np.asarray([0, 1, 2, 0, 1, 1, 2], np.int64)
    lbl = np.asarray([0, 1, 2, 0, 2, 0, 1], np.int64)
    got, want = both("chunk_eval", pred, lbl, "IOB", 1)
    same(list(got), list(want))
    score = np.asarray([[0.1, 0.9], [0.8, 0.2], [0.3, 0.7], [0.6, 0.4]],
                       np.float32)
    label = np.asarray([[1], [0], [0], [1]], np.int64)
    (a, b, stats), (ra, rb, rstats) = both("auc", score, label)
    assert 0.0 <= float(a.numpy()) <= 1.0
    same(a, ra)
    same(stats, rstats)


def test_matrix_nms_score_threshold_prefilters():
    boxes = np.asarray([[0, 0, 10, 10], [50, 50, 60, 60]], np.float32)
    scores = np.asarray([[0.9, 0.3]], np.float32)
    (out, n), (rout, rn) = both(
        "matrix_nms", boxes, scores, score_threshold=0.5, post_threshold=0.0,
        nms_top_k=2, keep_top_k=2, background_label=-1)
    assert int(n.numpy()[0]) == 1  # 0.3 pre-filtered
    same(out, rout)
    same(n, rn)


def test_matrix_nms():
    boxes = np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                       np.float32)
    scores = np.asarray([[0.9, 0.85, 0.8]], np.float32)  # one class
    for gaussian in (False, True):
        (out, n), (rout, rn) = both("matrix_nms", boxes, scores, 0.0, 0.1,
                                    3, 3, use_gaussian=gaussian,
                                    background_label=-1)
        assert int(n.numpy()[0]) >= 2  # decayed, not dropped
        same(out, rout)
        same(n, rn)


def test_misc_tensor_helpers():
    x = np.random.RandomState(3).randn(2, 3).astype(np.float32)
    for name in ("shape", "rank", "size", "has_inf", "has_nan",
                 "is_empty"):
        same(*both(name, x))
    same(*both("reverse", x, 1))
    same(*both("crop_tensor", x, shape=[1, 2], offsets=[1, 1]))
    # the reference's clip_by_norm names an op its library lacks
    clipped = L.clip_by_norm(T(x), 1.0).numpy()
    np.testing.assert_allclose(clipped, x / np.linalg.norm(x), rtol=1e-6)
    same(*both("brelu", x * 30, 0.0, 24.0))
    assert tuple(L.fill_constant_batch_size_like(
        T(x), [1, 4], "float32", 1.5).shape) == (2, 4)


# ---- TestContrib ------------------------------------------------------------

def test_basic_gru_lstm():
    """`basic_gru` / `basic_lstm` keep their layer in the legacy parameter
    store under a name; the port's runs on the reference's weights."""
    from paddle_tpu.fluid import contrib as RC
    from paddle_tpu.nn.functional.legacy import legacy_param_store as rstore

    from paddle_tpu_torch.fluid import contrib as C
    from paddle_tpu_torch.nn.functional.legacy import legacy_param_store

    paddle.seed(1)
    x = np.random.RandomState(2).randn(2, 5, 8).astype(np.float32)
    rout, rh = RC.basic_gru(R(x), None, hidden_size=6, name="twin_gru")
    rlo, rlh, rlc = RC.basic_lstm(R(x), None, None, hidden_size=6,
                                  name="twin_lstm")
    for key, build in (("twin_gru/8x6l1b0", lambda: ptt.nn.GRU(8, 6)),
                       ("twin_lstm/8x6l1b0", lambda: ptt.nn.LSTM(8, 6))):
        load_reference_state(legacy_param_store().layer(key, build),
                             ref_state(rstore().layer(key, None)))
    out, h = C.basic_gru(T(x), None, hidden_size=6, name="twin_gru")
    assert tuple(out.shape) == (2, 5, 6)
    same(out, rout, atol=1e-5)
    same(h, rh, atol=1e-5)
    lo, lh, lc = C.basic_lstm(T(x), None, None, hidden_size=6,
                              name="twin_lstm")
    assert tuple(lo.shape) == (2, 5, 6)
    for g, w in ((lo, rlo), (lh, rlh), (lc, rlc)):
        same(g, w, atol=1e-5)


def test_partial_ops_and_shuffle():
    from paddle_tpu.fluid import contrib as RC

    from paddle_tpu_torch.fluid import contrib as C
    a = np.asarray([[1.0, 2, 3], [4, 5, 6]], np.float32)
    b = np.asarray([[7.0, 8, 9], [10, 11, 12]], np.float32)
    pc = C.partial_concat([T(a), T(b)], 0, 2)
    assert pc.shape == (2, 4)
    same(pc, RC.partial_concat([R(a), R(b)], 0, 2))
    ps = C.partial_sum([T(a), T(b)], 0, 2)
    np.testing.assert_allclose(ps.numpy(), [[8, 10], [14, 16]])
    same(ps, RC.partial_sum([R(a), R(b)], 0, 2))
    sb = C.shuffle_batch(T(a))
    assert sorted(sb.numpy()[:, 0].tolist()) == [1.0, 4.0]
    x = np.random.RandomState(4).randn(2, 3, 7).astype(np.float32)
    same(C.sequence_topk_avg_pooling(T(x), None, None, [1, 3], 3),
         RC.sequence_topk_avg_pooling(R(x), None, None, [1, 3], 3))


def test_correlation_and_bilateral_slice():
    from paddle_tpu.fluid import contrib as RC

    from paddle_tpu_torch.fluid import contrib as C
    rs = np.random.RandomState(5)
    x = rs.rand(1, 2, 6, 6).astype(np.float32)
    y = rs.rand(1, 2, 6, 6).astype(np.float32)
    out = C.correlation(T(x), T(y), pad_size=1, kernel_size=1,
                        max_displacement=1, stride1=1, stride2=1)
    assert tuple(out.shape) == (1, 9, 6, 6)
    same(out, RC.correlation(R(x), R(y), 1, 1, 1, 1, 1))
    # the bilateral-grid slice (HDRNet), with and without the offset
    img = rs.rand(2, 3, 8, 8).astype(np.float32)
    guide = rs.rand(2, 1, 8, 8).astype(np.float32)
    for offset in (False, True):
        grid = rs.rand(2, 3 * (4 if offset else 3), 4, 4, 4).astype(
            np.float32)
        same(C.bilateral_slice(T(img), T(guide), T(grid), offset),
             RC.bilateral_slice(R(img), R(guide), R(grid), offset),
             atol=1e-5)


def test_cluster_only_pieces_raise():
    from paddle_tpu_torch.distributed.fleet.utils import ExecuteError
    from paddle_tpu_torch.fluid import contrib as C
    cl = C.HDFSClient(hadoop_home=None)
    cl._hadoop_home = None
    with pytest.raises(ExecuteError, match="hadoop"):
        cl.is_exist("/x")
    with pytest.raises(NotImplementedError, match="SURVEY"):
        C.distributed_batch_reader(None)


def test_decoupled_weight_decay_factory():
    """The decoupled Momentum decays before its step: one step on the
    same parameter and gradient as the reference's."""
    from paddle_tpu.fluid import contrib as RC
    import paddle_tpu.optimizer as ropt

    import paddle_tpu_torch.optimizer as opt
    from paddle_tpu_torch.fluid import contrib as C
    cls = C.extend_with_decoupled_weight_decay(opt.Momentum)
    p = ptt.create_parameter([4], "float32",
                             default_initializer=ptt.nn.initializer
                             .Constant(1.0))
    o = cls(learning_rate=0.1, weight_decay=0.01, parameters=[p])
    assert o._decoupled()
    rp = paddle.Parameter(np.ones(4, np.float32))
    ro = RC.extend_with_decoupled_weight_decay(ropt.Momentum)(
        learning_rate=0.1, weight_decay=0.01, parameters=[rp])
    (p * p).sum().backward()
    (rp * rp).sum().backward()
    o.step()
    ro.step()
    same(p, rp)
    ecls = C.extend_optimizer.extend_with_decoupled_weight_decay(
        opt.Adam)
    assert issubclass(ecls, opt.AdamW)


# ---- TestDygraphAliases -----------------------------------------------------

def test_layer_aliases_construct():
    import paddle_tpu_torch.fluid.dygraph as D
    assert D.Conv2DTranspose is ptt.nn.Conv2DTranspose
    assert D.AmpScaler is ptt.amp.GradScaler
    assert D.amp_guard is ptt.amp.auto_cast
    lw = D.LinearLrWarmup(0.1, 10, 0.0, 0.1)
    rlw = rfluid.dygraph.LinearLrWarmup(0.1, 10, 0.0, 0.1)
    np.testing.assert_allclose([lw() for _ in range(1)],
                               [rlw() for _ in range(1)])
    nce = D.NCE(20, 8)
    out = nce(T(np.random.rand(3, 8).astype(np.float32)),
              T(np.asarray([[1], [2], [3]], np.int64)))
    assert tuple(out.shape) == (3, 1) and torch.isfinite(out).all()


def test_gru_unit_and_tree_conv():
    import paddle_tpu.fluid.dygraph as RD
    import paddle_tpu_torch.fluid.dygraph as D
    paddle.seed(2)
    rg, g = RD.GRUUnit(12), D.GRUUnit(12)  # hidden 4
    load_reference_state(g, ref_state(rg))
    x = np.random.RandomState(6).rand(2, 12).astype(np.float32)
    h0 = np.random.RandomState(7).rand(2, 4).astype(np.float32)
    h, _, _ = g(T(x), T(h0))
    assert tuple(h.shape) == (2, 4)
    same(h, rg(R(x), R(h0))[0], atol=1e-5)
    rtc, tc = RD.TreeConv(6, 5, num_filters=2), D.TreeConv(6, 5,
                                                          num_filters=2)
    load_reference_state(tc, ref_state(rtc))
    nodes = np.random.RandomState(8).rand(1, 4, 6).astype(np.float32)
    adj = np.eye(4, dtype=np.float32)[None]
    adj[0, 0, 1] = adj[0, 1, 2] = 1.0
    out = tc(T(nodes), T(adj))
    assert tuple(out.shape)[0] == 1
    same(out, rtc(R(nodes), R(adj)), atol=1e-5)
